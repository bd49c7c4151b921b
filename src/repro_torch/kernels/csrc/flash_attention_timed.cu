// The same float32 flash-attention kernel with its per-phase clock64() timers
// compiled in (flash_attention.cuh, FLASH_PHASE_TIMERS).  Built into a library
// of its own; only ops.flash_attention_phase_cycles loads it, never the path.
#define FLASH_PHASE_TIMERS 1
#include "flash_attention.cuh"
