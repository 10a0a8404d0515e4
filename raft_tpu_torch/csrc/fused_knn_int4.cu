// K2 (fused_knn.cuh) over a corpus of int4 split-half nibbles with per-row
// scales; one library a store, so that the stores' builds run in parallel.
#include "fused_knn.cuh"

RAFT_FUSED_KNN_ENTRIES(kI4)
