// The sLSTM scan kernel as the port runs it (ops.slstm_scan): the kernel
// itself, its design and its limits are in slstm_scan.cuh.  Replaces the
// Pallas TPU kernel slstm_scan_pallas (src/repro/kernels/slstm_cell.py:95).
#include "slstm_scan.cuh"
