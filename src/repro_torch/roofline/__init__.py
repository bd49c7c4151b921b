"""The analysis of a step: its operations counted on fake tensors
(``op_costs``), set against the card's data-sheet roofline (``analyze``),
broken down by op (``breakdown``), and the named sharding-rule variants
(``rule_variants``)."""
