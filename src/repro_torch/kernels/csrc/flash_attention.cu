// The float32 flash-attention kernel as the port runs it (ops.flash_attention
// for float32 inputs): the kernel itself, its design and its limits are in
// flash_attention.cuh.  Replaces the Pallas TPU kernel flash_attention_pallas
// (src/repro/kernels/flash_attention.py:84) for float32 inputs.
#include "flash_attention.cuh"
