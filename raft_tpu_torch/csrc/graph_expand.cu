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
// Bound on this card: each pair reads one tile, one aux row and its query
// and does about 2 operations per tile byte, so the bytes bound it; but a
// pair's own work is a chain — the tile's copy, ~1,700 warp instructions
// of scoring and sorting — so what a design has to hide is latency.
//
// Design on Hopper: persistent warps, four to a block (fewer when a wide
// query row leaves four above the card's shared memory a block), as many
// blocks as the card keeps resident (16 warps an SM at the path's shape);
// warp w takes pairs w, w + W, w + 2W, ... (every pair costs the same). Scoring
// and the per-parent top-k' are edge_score.cuh's (the tile staged in the
// warp's shared memory by cp.async, prmt widening, the reduce-scatter
// tree, a bitonic sort in registers), shared with K6 so the two kernels
// compute the same bits. As soon as a pair's scores are in registers, the
// next pair's query row and tile copies are started, so they are in
// flight while the pair before sorts and stores. The TPU's query-routing
// one-hot matmul, its P_q queries per grid step and its 128-lane output
// padding have no counterpart: each warp reads its own query row and
// writes exactly k' slots.
#include "edge_score.cuh"

namespace {

constexpr int kWarps = 4;

// Start copying the dim_p floats of a query row into shared memory, 16
// bytes a lane a step, as one copy group.
__device__ __forceinline__ void copy_query(float* dst, const float* src,
                                           int dim_p, int lane) {
  for (int d = 4 * lane; d < dim_p; d += 128) {
    edge::cp_async16(dst + d, src + d);
  }
  edge::cp_commit();
}

// 4-byte words of shared memory one warp uses: the tile stage, then two
// query rows.
__host__ __device__ inline size_t warp_words(int dim_p, int elem_bytes) {
  return edge::stage_words(elem_bytes) + 2 * (size_t)dim_p;
}

inline size_t warp_bytes(int dim_p, int store_bf16) {
  return sizeof(float) * warp_words(dim_p, store_bf16 ? 2 : 1);
}

template <typename T, int NG>
__global__ void __launch_bounds__(kWarps * 32, NG <= 2 ? 4 : 2)
graph_expand_kernel(const int* __restrict__ pids, const float* __restrict__ q,
                    const void* __restrict__ vp, const float* __restrict__ aux,
                    const float* __restrict__ pen, int pairs, int width,
                    int deg_p, int dim_p, int degree, int kout, int metric,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const T* vecs = static_cast<const T*>(vp);
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * warps;
  int pair = blockIdx.x * warps + warp;
  if (pair >= pairs) return;  // warps are independent: no block barrier
  float* base = smem + (size_t)warp * warp_words(dim_p, sizeof(T));
  float* qbuf = base + edge::stage_words(sizeof(T));
  const size_t tile = (size_t)deg_p * dim_p;
  edge::TileScorer<T, NG> sc;
  sc.stage = reinterpret_cast<uint32_t*>(base);
  // a pair's query and tile are in flight while the pair before sorts
  int pid = pids[pair];
  copy_query(qbuf, q + (size_t)(pair / width) * dim_p, dim_p, lane);
  sc.issue(vecs + (size_t)pid * tile, aux + (size_t)pid * 2 * deg_p,
           pen != nullptr ? pen + (size_t)pid * deg_p : nullptr, deg_p,
           dim_p, lane);
  for (int b = 0;; b ^= 1) {
    const int next = pair + stride;
    const int next_pid = next < pairs ? pids[next] : 0;
    float qn, dist[NG];
    sc.finish(qbuf + b * dim_p, qn, true, dim_p, degree, metric,
              pen != nullptr, lane, dist);
    if (next < pairs) {
      copy_query(qbuf + (b ^ 1) * dim_p, q + (size_t)(next / width) * dim_p,
                 dim_p, lane);
      sc.issue(vecs + (size_t)next_pid * tile,
               aux + (size_t)next_pid * 2 * deg_p,
               pen != nullptr ? pen + (size_t)next_pid * deg_p : nullptr,
               deg_p, dim_p, lane);
    }
    uint64_t key[NG];
    edge::sort_tile<NG>(dist, lane, key);
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int r = g * 32 + lane;
      if (r < kout) {
        const float v = edge::key_value(key[g]);
        out_v[(size_t)pair * kout + r] = v;
        out_i[(size_t)pair * kout + r] = isfinite(v) ? edge::key_pos(key[g])
                                                     : -1;
      }
    }
    if (next >= pairs) break;
    pair = next;
  }
}

template <int NG>
const void* kernel_of(int store_bf16) {
  return store_bf16 ? (const void*)&graph_expand_kernel<uint16_t, NG>
                    : (const void*)&graph_expand_kernel<int8_t, NG>;
}

// The instance for the shape (NG: the next power of two of deg_p / 32),
// or null past deg_p 256.
const void* kernel_for(int deg_p, int store_bf16) {
  if (deg_p <= 32) return kernel_of<1>(store_bf16);
  if (deg_p <= 64) return kernel_of<2>(store_bf16);
  if (deg_p <= 128) return kernel_of<4>(store_bf16);
  if (deg_p <= 256) return kernel_of<8>(store_bf16);
  return nullptr;
}

}  // namespace

// Shared memory one warp uses, in bytes (the wrapper refuses a shape
// above the card's per-block limit; a launch puts as many warps in a
// block as that limit holds, at most four).
extern "C" size_t raft_graph_expand_smem(int dim_p, int store_bf16) {
  return warp_bytes(dim_p, store_bf16);
}

// For a shape: the kernel's registers a thread, its local memory a thread
// in bytes (spills), and the warps an SM keeps resident, in info[0..2].
extern "C" int raft_graph_expand_info(int deg_p, int dim_p, int store_bf16,
                                      int* info) {
  const void* kern = kernel_for(deg_p, store_bf16);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return (int)edge::instance_info(kern, kWarps, warp_bytes(dim_p, store_bf16),
                                  info);
}

// store_bf16: 0 for an int8 store, 1 for a bf16 store (its raw bits).
// deg_p is a multiple of 32 up to 256, dim_p a multiple of 128.
extern "C" int raft_graph_expand(const void* pids, const void* q,
                                 const void* vecs, const void* aux,
                                 const void* pen, int pairs, int width,
                                 int deg_p, int dim_p, int degree, int kout,
                                 int metric, int store_bf16, void* out_v,
                                 void* out_i, void* stream) {
  const void* kern = kernel_for(deg_p, store_bf16);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&pids,  &q,     &vecs,   &aux,  &pen,   &pairs,
                  &width, &deg_p, &dim_p,  &degree, &kout, &metric,
                  &out_v, &out_i};
  return (int)edge::launch_persistent(kern, kWarps,
                                      warp_bytes(dim_p, store_bf16), pairs,
                                      args, (cudaStream_t)stream);
}
