// K6 (cagra_fused.cuh) over an int4 edge store: split-half nibbles with
// per-edge scales, dim_p / 2 bytes a row; one library a store mode, so
// that the modes' builds run in parallel. The entries are the dense
// library's (cagra_fused.cu), dim_p the scored width; store_bf16 must be
// 0.
#include "cagra_fused.cuh"

extern "C" size_t raft_cagra_fused_smem(int itopk, int width, int kprime,
                                        int deg_p, int dim_p,
                                        int /*store_bf16*/) {
  return k6::warp_bytes<edge::Int4>(itopk, width, kprime, deg_p, dim_p);
}

extern "C" int raft_cagra_fused_info(int itopk, int width, int kprime,
                                     int deg_p, int dim_p, int store_bf16,
                                     int* info) {
  if (store_bf16) return (int)cudaErrorInvalidValue;
  return k6::info<edge::Int4>(itopk, width, kprime, deg_p, dim_p, info);
}

// vecs: (n, deg_p, dim_p / 2) bytes; itopk and deg_p at most 256, deg_p
// a multiple of 32, dim_p of 128; the rows of bd0 in any order.
extern "C" int raft_cagra_fused(const void* q, const void* bd0,
                                const void* bi0, const void* vecs,
                                const void* aux, const void* gph,
                                const void* pen, int m, int n, int itopk,
                                int width, int max_iter, int kprime,
                                int deg_p, int dim_p, int degree, int metric,
                                int store_bf16, void* counter, void* out_d,
                                void* out_i, void* out_hops,
                                void* out_parents, void* stream) {
  if (store_bf16) return (int)cudaErrorInvalidValue;
  return k6::launch<edge::Int4>(q, bd0, bi0, vecs, aux, gph, pen, m, n,
                                itopk, width, max_iter, kprime, deg_p, dim_p,
                                degree, metric, counter, out_d, out_i,
                                out_hops, out_parents, stream);
}
