"""The paper's mining algorithms: packed-bitmap Apriori and GFM."""
