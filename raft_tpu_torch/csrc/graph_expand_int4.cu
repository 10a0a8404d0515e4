// K5 (graph_expand.cuh) over an int4 edge store: split-half nibbles with
// per-edge scales, dim_p / 2 bytes a row; one library a store mode, so
// that the modes' builds run in parallel. The entries are the dense
// library's (graph_expand.cu), dim_p the scored width; store_bf16 must
// be 0.
#include "graph_expand.cuh"

namespace {

using I4One = k5::TileStore<edge::Int4, true>;   // dim_p 128
using I4 = k5::TileStore<edge::Int4, false>;
const k5::PqArgs kNoPq{nullptr, nullptr, 0, 0};

}  // namespace

extern "C" size_t raft_graph_expand_smem(int dim_p, int /*store_bf16*/) {
  return dim_p == edge::kChunk ? k5::smem_bytes<I4One>(dim_p, kNoPq)
                               : k5::smem_bytes<I4>(dim_p, kNoPq);
}

extern "C" int raft_graph_expand_info(int deg_p, int dim_p, int store_bf16,
                                      int* info) {
  if (store_bf16) return (int)cudaErrorInvalidValue;
  return dim_p == edge::kChunk ? k5::info<I4One>(deg_p, dim_p, kNoPq, info)
                               : k5::info<I4>(deg_p, dim_p, kNoPq, info);
}

// vecs: (n, deg_p, dim_p / 2) bytes; dim_p a multiple of 128, deg_p of 32
// up to 256.
extern "C" int raft_graph_expand(const void* pids, const void* q,
                                 const void* vecs, const void* aux,
                                 const void* pen, int pairs, int width,
                                 int deg_p, int dim_p, int degree, int kout,
                                 int metric, int store_bf16, void* out_v,
                                 void* out_i, void* stream) {
  if (store_bf16) return (int)cudaErrorInvalidValue;
  return dim_p == edge::kChunk
             ? k5::launch<I4One>(pids, q, vecs, aux, pen, kNoPq, pairs,
                                 width, deg_p, dim_p, degree, kout, metric,
                                 out_v, out_i, stream)
             : k5::launch<I4>(pids, q, vecs, aux, pen, kNoPq, pairs, width,
                              deg_p, dim_p, degree, kout, metric, out_v,
                              out_i, stream);
}
