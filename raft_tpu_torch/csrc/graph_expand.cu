// K5 (graph_expand.cuh) over a dense edge store: int8 rows with per-edge
// scales, or bf16 rows; one library a store mode, so that the modes'
// builds run in parallel.
#include "graph_expand.cuh"

namespace {

using I8 = k5::TileStore<int8_t, false>;
using Bf16 = k5::TileStore<uint16_t, false>;
const k5::PqArgs kNoPq{nullptr, nullptr, 0, 0};

}  // namespace

// Shared memory one warp uses, in bytes (the wrapper refuses a shape
// above the card's per-block limit; a launch puts as many warps in a
// block as that limit holds, at most four).
extern "C" size_t raft_graph_expand_smem(int dim_p, int store_bf16) {
  return store_bf16 ? k5::smem_bytes<Bf16>(dim_p, kNoPq)
                    : k5::smem_bytes<I8>(dim_p, kNoPq);
}

// For a shape: the kernel's registers a thread, its local memory a thread
// in bytes (spills), the warps an SM keeps resident, the warps a block
// and the shared memory an SM holds, in info[0..4].
extern "C" int raft_graph_expand_info(int deg_p, int dim_p, int store_bf16,
                                      int* info) {
  return store_bf16 ? k5::info<Bf16>(deg_p, dim_p, kNoPq, info)
                    : k5::info<I8>(deg_p, dim_p, kNoPq, info);
}

// store_bf16: 0 for an int8 store, 1 for a bf16 store (its raw bits).
// deg_p is a multiple of 32 up to 256, dim_p a multiple of 128.
extern "C" int raft_graph_expand(const void* pids, const void* q,
                                 const void* vecs, const void* aux,
                                 const void* pen, int pairs, int width,
                                 int deg_p, int dim_p, int degree, int kout,
                                 int metric, int store_bf16, void* out_v,
                                 void* out_i, void* stream) {
  return store_bf16
             ? k5::launch<Bf16>(pids, q, vecs, aux, pen, kNoPq, pairs, width,
                                deg_p, dim_p, degree, kout, metric, out_v,
                                out_i, stream)
             : k5::launch<I8>(pids, q, vecs, aux, pen, kNoPq, pairs, width,
                              deg_p, dim_p, degree, kout, metric, out_v,
                              out_i, stream);
}
