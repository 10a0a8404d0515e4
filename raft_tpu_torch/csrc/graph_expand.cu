// K5 — CAGRA frontier expansion: score each (query, parent) pair's edge
// tile and keep the parent's k' best edges.
//
// Replaces the TPU kernel raft_tpu/ops/graph_expand.py::_expand_padded
// (kernel _kernel, scoring edge_tile_widen), dense mode: the store holds,
// for every node, its deg_p neighbors' vectors as one contiguous
// (deg_p, dim_p) tile, int8 with per-edge scales or bf16. Output per pair:
// the k' best (value, edge position) best first, lowest position on ties,
// (+inf, -1) for empty slots.
//
// Design on Hopper: one warp per (query, parent) pair, four pairs to a
// block. The warp copies its query into shared memory, streams the
// parent's tile (8 KB at 64 x 128 int8) with 4-byte loads per lane, so
// each row is one coalesced 128-byte read, eight rows in flight at a
// time, and scores it with the shared edge::score_tile; the per-parent
// top-k' is a rank count over the tile's scores in shared memory. The
// TPU's query-routing one-hot matmul, its P_q queries per grid step and
// its 128-lane output padding have no counterpart: each warp reads its
// own query row and writes exactly k' slots.
//
// Bound on this card: each pair reads one tile, one aux row and its query
// and does about 2 operations per tile byte, so the bytes bound it. The
// tiles are read once, coalesced; what this simple version leaves is
// latency: one warp handles a whole 8 KB tile with only eight row loads
// in flight, and the rank count costs deg_p² compares per pair.
#include "edge_score.cuh"

namespace {

constexpr int kWarps = 4;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
graph_expand_kernel(const int* __restrict__ pids, const float* __restrict__ q,
                    const T* __restrict__ vecs, const float* __restrict__ aux,
                    const float* __restrict__ pen, int pairs, int width,
                    int deg_p, int dim_p, int degree, int kout, int metric,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pair = blockIdx.x * kWarps + warp;
  if (pair >= pairs) return;  // warps are independent: no block barrier
  float* qs = smem + (size_t)warp * (dim_p + deg_p);
  float* sc = qs + dim_p;
  const float* qrow = q + (size_t)(pair / width) * dim_p;
  for (int d = lane; d < dim_p; d += 32) qs[d] = qrow[d];
  __syncwarp();
  const float qn = edge::warp_sqnorm(qs, dim_p, lane);
  const size_t pid = (size_t)pids[pair];
  edge::score_tile(vecs + pid * deg_p * dim_p, aux + pid * 2 * deg_p,
                   pen != nullptr ? pen + pid * deg_p : nullptr, qs, qn,
                   deg_p, dim_p, degree, metric, sc, lane);
  __syncwarp();
  edge::tile_topk(sc, deg_p, kout, nullptr, out_v + (size_t)pair * kout,
                  out_i + (size_t)pair * kout, lane);
}

template <typename T>
int launch(const void* pids, const void* q, const void* vecs, const void* aux,
           const void* pen, int pairs, int width, int deg_p, int dim_p,
           int degree, int kout, int metric, void* out_v, void* out_i,
           cudaStream_t stream) {
  const size_t smem = (size_t)kWarps * (dim_p + deg_p) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      graph_expand_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (pairs + kWarps - 1) / kWarps;
  if (blocks > 0) {
    graph_expand_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
        (const int*)pids, (const float*)q, (const T*)vecs, (const float*)aux,
        (const float*)pen, pairs, width, deg_p, dim_p, degree, kout, metric,
        (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// store_bf16: 0 for an int8 store, 1 for a bf16 store (its raw bits).
extern "C" int raft_graph_expand(const void* pids, const void* q,
                                 const void* vecs, const void* aux,
                                 const void* pen, int pairs, int width,
                                 int deg_p, int dim_p, int degree, int kout,
                                 int metric, int store_bf16, void* out_v,
                                 void* out_i, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (store_bf16) {
    return launch<uint16_t>(pids, q, vecs, aux, pen, pairs, width, deg_p,
                            dim_p, degree, kout, metric, out_v, out_i, s);
  }
  return launch<int8_t>(pids, q, vecs, aux, pen, pairs, width, deg_p, dim_p,
                        degree, kout, metric, out_v, out_i, s);
}
