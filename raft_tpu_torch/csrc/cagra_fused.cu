// K6 (cagra_fused.cuh) over a dense edge store: int8 rows with per-edge
// scales, or bf16 rows; one library a store mode, so that the modes'
// builds run in parallel.
#include "cagra_fused.cuh"

// Shared memory one warp uses, in bytes (the wrapper refuses a shape
// above the card's per-block limit; a launch puts as many warps in a
// block as that limit holds, at most four).
extern "C" size_t raft_cagra_fused_smem(int itopk, int width, int kprime,
                                        int deg_p, int dim_p,
                                        int store_bf16) {
  return store_bf16
             ? k6::warp_bytes<uint16_t>(itopk, width, kprime, deg_p, dim_p)
             : k6::warp_bytes<int8_t>(itopk, width, kprime, deg_p, dim_p);
}

// For a shape: the kernel's registers a thread, its local memory a thread
// in bytes (spills), the warps an SM keeps resident, the warps a block
// and the shared memory an SM holds, in info[0..4].
extern "C" int raft_cagra_fused_info(int itopk, int width, int kprime,
                                     int deg_p, int dim_p, int store_bf16,
                                     int* info) {
  return store_bf16
             ? k6::info<uint16_t>(itopk, width, kprime, deg_p, dim_p, info)
             : k6::info<int8_t>(itopk, width, kprime, deg_p, dim_p, info);
}

// store_bf16: 0 for an int8 store, 1 for a bf16 store (its raw bits).
// itopk and deg_p at most 256, deg_p a multiple of 32, dim_p of 128;
// the rows of bd0 in any order. counter: one int of device memory,
// zeroed here on the stream.
extern "C" int raft_cagra_fused(const void* q, const void* bd0,
                                const void* bi0, const void* vecs,
                                const void* aux, const void* gph,
                                const void* pen, int m, int n, int itopk,
                                int width, int max_iter, int kprime,
                                int deg_p, int dim_p, int degree, int metric,
                                int store_bf16, void* counter, void* out_d,
                                void* out_i, void* out_hops,
                                void* out_parents, void* stream) {
  return store_bf16
             ? k6::launch<uint16_t>(q, bd0, bi0, vecs, aux, gph, pen, m, n,
                                    itopk, width, max_iter, kprime, deg_p,
                                    dim_p, degree, metric, counter, out_d,
                                    out_i, out_hops, out_parents, stream)
             : k6::launch<int8_t>(q, bd0, bi0, vecs, aux, gph, pen, m, n,
                                  itopk, width, max_iter, kprime, deg_p,
                                  dim_p, degree, metric, counter, out_d,
                                  out_i, out_hops, out_parents, stream);
}
