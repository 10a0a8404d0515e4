// K5 — CAGRA frontier expansion: score each (query, parent) pair's edge
// tile and keep the parent's k' best edges.
//
// Replaces the TPU kernel raft_tpu/ops/graph_expand.py::_expand_padded
// (kernel _kernel, scoring edge_tile_widen), in its three store modes,
// one library each so that their builds run in parallel:
// graph_expand.cu (dense: int8 rows with per-edge scales, or bf16),
// graph_expand_int4.cu (split-half nibbles) and graph_expand_pq.cu (PQ
// codes and the compact codebook). The store holds, for every node, its
// deg_p neighbors' coded vectors as one contiguous (deg_p, W) tile.
// Output per pair: the k' best (value, edge position) best first, lowest
// position on ties, (+inf, -1) for empty slots.
//
// Bound on this card: each pair reads one tile, one aux row and its query
// (and a block reads the pq codebook once) and does about 2 operations
// per scored dim, so the bytes bound it; but a pair's own work is a chain
// — the tile's copy, ~1,700 warp instructions of scoring and sorting at
// the dense 64 x 128 tile, more for pq's decode — so what a design has to
// hide is latency.
//
// Design on Hopper: persistent warps, four to a block (fewer when a wide
// query row, or pq's codebook, leaves four above the card's shared memory
// a block), as many blocks as the card keeps resident (16 warps an SM at
// the path's int8 shape); warp w takes pairs w, w + W, w + 2W, ...
// (every pair costs the same). Scoring and the per-parent top-k' are
// edge_score.cuh's (the tile staged in the warp's shared memory by
// cp.async, prmt widening, the reduce-scatter tree, a bitonic sort in
// registers), shared with K6 so the two kernels compute the same bits. As
// soon as a pair's scores are in registers, the next pair's query row and
// tile copies are started, so they are in flight while the pair before
// sorts and stores. A pq block first copies the codebook (int8: dim_p x
// book bytes, 32 KB at d = 128; float32: 4x that) into shared memory once
// for all its warps. The TPU's query-routing and decode one-hot matmuls,
// its P_q queries per grid step and its 128-lane output padding have no
// counterpart: each warp reads its own query row and writes exactly k'
// slots.
#pragma once

#include "edge_score.cuh"

namespace k5 {

constexpr int kWarps = 4;

// A pq store's codebook (the other stores' kernels ignore it): the
// compact (pq_dim, book, pq_len) int8 or float32 codebook and the int8
// one's (pq_dim,) scales, all in device memory.
struct PqArgs {
  const void* cb;
  const float* cb_scale;
  int pq_dim, book;
};

// Start copying the dim_p floats of a query row into shared memory, 16
// bytes a lane a step, as one copy group.
__device__ __forceinline__ void copy_query(float* dst, const float* src,
                                           int dim_p, int lane) {
  for (int d = 4 * lane; d < dim_p; d += 128) {
    edge::cp_async16(dst + d, src + d);
  }
  edge::cp_commit();
}

// The dense and int4 stores: T int8_t, uint16_t (bf16 bits) or
// edge::Int4; kOneChunk for a scored width of 128.
template <typename T, bool kOneChunk>
struct TileStore {
  template <int NG>
  using Scorer = edge::TileScorer<T, NG, kOneChunk>;
  __host__ __device__ static size_t stage_words(int, const PqArgs&) {
    return edge::stage_words<T>();
  }
  __host__ __device__ static size_t block_bytes(int, const PqArgs&) {
    return 0;
  }
  __host__ __device__ static size_t row_bytes(int dim_p, const PqArgs&) {
    return Scorer<1>::stored_row_bytes(dim_p);
  }
  template <int NG>
  __device__ static void bind(Scorer<NG>& sc, uint32_t* stage, const void*,
                              const PqArgs&, int) {
    sc.stage = stage;
  }
};

// The pq store: an int8 (kI8) or float32 codebook.
template <bool kI8>
struct PqStore {
  template <int NG>
  using Scorer = edge::PqScorer<NG, kI8>;
  __host__ __device__ static size_t stage_words(int, const PqArgs& a) {
    return Scorer<1>::stage_words(a.pq_dim);
  }
  __host__ __device__ static size_t block_bytes(int dim_p, const PqArgs& a) {
    return Scorer<1>::codebook_bytes(dim_p, a.book);
  }
  __host__ __device__ static size_t row_bytes(int, const PqArgs& a) {
    return (size_t)a.pq_dim;
  }
  template <int NG>
  __device__ static void bind(Scorer<NG>& sc, uint32_t* stage,
                              const void* cb, const PqArgs& a, int dim_p) {
    sc.bind(stage, cb, a.cb_scale, dim_p, a.pq_dim, a.book);
  }
};

// 4-byte words of shared memory one warp uses: the tile stage, then two
// query rows (a multiple of 4, so every part is 16-byte aligned).
template <class P>
__host__ __device__ inline size_t warp_words(int dim_p, const PqArgs& a) {
  return P::stage_words(dim_p, a) + 2 * (size_t)dim_p;
}

template <class P>
inline size_t warp_bytes(int dim_p, const PqArgs& a) {
  return sizeof(float) * warp_words<P>(dim_p, a);
}

template <class P, int NG>
__global__ void __launch_bounds__(kWarps * 32, NG <= 2 ? 4 : 2)
graph_expand_kernel(const int* __restrict__ pids, const float* __restrict__ q,
                    const char* __restrict__ vecs,
                    const float* __restrict__ aux,
                    const float* __restrict__ pen, PqArgs pa, int pairs,
                    int width, int deg_p, int dim_p, int degree, int kout,
                    int metric, float* __restrict__ out_v,
                    int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * warps;
  // the block's part (pq: the codebook), copied once for all its warps
  const size_t bb = P::block_bytes(dim_p, pa);
  char* block = reinterpret_cast<char*>(smem);
  if (bb > 0) {
    const int4* from = static_cast<const int4*>(pa.cb);
    int4* to = reinterpret_cast<int4*>(block);
    for (size_t i = threadIdx.x; i < bb / 16; i += blockDim.x) {
      to[i] = __ldg(from + i);
    }
    __syncthreads();
  }
  int pair = blockIdx.x * warps + warp;
  if (pair >= pairs) return;  // warps are independent: no block barrier
  float* base = reinterpret_cast<float*>(block + bb) +
                (size_t)warp * warp_words<P>(dim_p, pa);
  float* qbuf = base + P::stage_words(dim_p, pa);
  const size_t tile = (size_t)deg_p * P::row_bytes(dim_p, pa);
  typename P::template Scorer<NG> sc;
  P::bind(sc, reinterpret_cast<uint32_t*>(base), block, pa, dim_p);
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

// The instance for the shape (NG: the next power of two of deg_p / 32),
// or null past deg_p 256.
template <class P>
const void* kernel_for(int deg_p) {
  if (deg_p <= 32) return (const void*)&graph_expand_kernel<P, 1>;
  if (deg_p <= 64) return (const void*)&graph_expand_kernel<P, 2>;
  if (deg_p <= 128) return (const void*)&graph_expand_kernel<P, 4>;
  if (deg_p <= 256) return (const void*)&graph_expand_kernel<P, 8>;
  return nullptr;
}

// Shared memory a block needs at one warp, in bytes.
template <class P>
size_t smem_bytes(int dim_p, const PqArgs& a) {
  return P::block_bytes(dim_p, a) + warp_bytes<P>(dim_p, a);
}

template <class P>
int info(int deg_p, int dim_p, const PqArgs& a, int* out) {
  const void* kern = kernel_for<P>(deg_p);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return (int)edge::instance_info(kern, kWarps, warp_bytes<P>(dim_p, a), out,
                                  P::block_bytes(dim_p, a));
}

template <class P>
int launch(const void* pids, const void* q, const void* vecs,
           const void* aux, const void* pen, PqArgs pa, int pairs, int width,
           int deg_p, int dim_p, int degree, int kout, int metric,
           void* out_v, void* out_i, void* stream) {
  const void* kern = kernel_for<P>(deg_p);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&pids,  &q,     &vecs,  &aux,   &pen,    &pa,
                  &pairs, &width, &deg_p, &dim_p, &degree, &kout,
                  &metric, &out_v, &out_i};
  return (int)edge::launch_persistent(
      kern, kWarps, warp_bytes<P>(dim_p, pa), pairs, args,
      (cudaStream_t)stream, P::block_bytes(dim_p, pa));
}

}  // namespace k5
