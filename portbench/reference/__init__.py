"""Plain PyTorch references, one file an architecture.  They import
nothing of the program and take nothing it made: the weights come from
``portbench.weights``, the inputs from ``portbench.traffic``."""
