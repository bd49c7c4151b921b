"""repro_torch — the grid-mining system on PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

A port of the JAX package ``repro`` (which stays the reference): the
module layout mirrors it, so ``repro_torch.core.gfm`` is the counterpart
of ``repro.core.gfm``.  The package imports torch and numpy, never jax and
never ``repro``.  Entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""

__version__ = "0.1.0"
