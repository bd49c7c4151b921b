"""Hand-written Hopper kernels for the port, their plain PyTorch versions
(``ref``) and the wrappers that pick between them (``ops``)."""


def pad_to(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``."""
    return ((x + m - 1) // m) * m
