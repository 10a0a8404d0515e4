// K2 (fused_knn.cuh) over a corpus of bfloat16 rows (the wrapper rounds the
// query to bf16); one library a store, so that the stores' builds run in
// parallel.
#include "fused_knn.cuh"

RAFT_FUSED_KNN_ENTRIES(kBF16)
