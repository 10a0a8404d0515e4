// K5 (graph_expand.cuh) over a pq edge store: pq_dim uint8 codes a row,
// decoded through the compact codebook (pq_dim, book, pq_len), int8 with
// (pq_dim,) float32 scales (lut_i8 1) or float32 (lut_i8 0); one library
// a store mode, so that the modes' builds run in parallel.
#include "graph_expand.cuh"

namespace {

using PqI8 = k5::PqStore<true>;
using PqF32 = k5::PqStore<false>;

}  // namespace

// Shared memory a block needs at one warp, in bytes: the codebook and one
// warp's stage and query rows (the wrapper refuses a shape above the
// card's per-block limit; a launch puts as many warps in a block as that
// limit holds, at most 16).
extern "C" size_t raft_graph_expand_pq_smem(int dim_p, int pq_dim, int book,
                                            int lut_i8) {
  const k5::PqArgs a{nullptr, nullptr, pq_dim, book};
  return lut_i8 ? k5::smem_bytes<PqI8>(dim_p, a)
                : k5::smem_bytes<PqF32>(dim_p, a);
}

// For a shape: the kernel's registers a thread, its local memory a thread
// in bytes (spills), the warps an SM keeps resident, the warps a block
// and the shared memory an SM holds, in info[0..4].
extern "C" int raft_graph_expand_pq_info(int deg_p, int dim_p, int pq_dim,
                                         int book, int lut_i8, int* info) {
  const k5::PqArgs a{nullptr, nullptr, pq_dim, book};
  return lut_i8 ? k5::info<PqI8>(deg_p, dim_p, a, info)
                : k5::info<PqF32>(deg_p, dim_p, a, info);
}

// vecs: (n, deg_p, pq_dim) uint8 codes; cb: (pq_dim, book, pq_len) int8
// or float32, 16-byte aligned, dim_p = pq_dim · pq_len a multiple of 128;
// cb_scale: (pq_dim,) float32 (int8 only). deg_p a multiple of 32 up to
// 256.
extern "C" int raft_graph_expand_pq(const void* pids, const void* q,
                                    const void* vecs, const void* aux,
                                    const void* pen, const void* cb,
                                    const void* cb_scale, int pairs,
                                    int width, int deg_p, int dim_p,
                                    int pq_dim, int book, int degree,
                                    int kout, int metric, int lut_i8,
                                    void* out_v, void* out_i, void* stream) {
  const k5::PqArgs a{cb, static_cast<const float*>(cb_scale), pq_dim, book};
  return lut_i8 ? k5::launch<PqI8>(pids, q, vecs, aux, pen, a, pairs, width,
                                   deg_p, dim_p, degree, kout, metric, out_v,
                                   out_i, stream)
                : k5::launch<PqF32>(pids, q, vecs, aux, pen, a, pairs, width,
                                    deg_p, dim_p, degree, kout, metric,
                                    out_v, out_i, stream);
}
