"""Entry points a user runs: the continuous mining service (``serve``)."""
