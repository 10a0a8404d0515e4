// K3 (ivf_flat_scan.cuh), both forms, over bfloat16 lists; one library a
// store, so that the stores' builds run in parallel.
#include "ivf_flat_scan.cuh"

RAFT_IVF_FLAT_SCAN_ENTRIES(kBF16)
