// The same sLSTM scan kernel with its per-phase clock64() timers compiled in
// (slstm_scan.cuh, SLSTM_PHASE_TIMERS).  Built into a library of its own;
// only ops.slstm_scan_phase_cycles loads it, never the model's path.
#define SLSTM_PHASE_TIMERS 1
#include "slstm_scan.cuh"
