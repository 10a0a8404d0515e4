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
// Design on Hopper: persistent warps, as many blocks as the card keeps
// resident; warp w takes pairs w, w + W, w + 2W, ... (every pair costs the
// same). Scoring and the per-parent top-k' are edge_score.cuh's (the tile
// staged in the warp's shared memory by cp.async, prmt widening, the
// reduce-scatter tree, a bitonic sort in registers), shared with K6 so the
// two kernels compute the same bits. As soon as a pair's scores are in
// registers, the next pair's query row and tile copies are started, so
// they are in flight while the pair before sorts and stores.
// - The dense and int4 stores: four independent warps a block (fewer when
//   a wide query row leaves four above the card's shared memory a block),
//   16 warps an SM at the path's shapes. At dim_p 128 an int4 unit stages
//   each row's 64 bytes once (edge_score.cuh).
// - The pq store: one block an SM of up to 16 warps (8 past deg_p 64), so
//   that the SM holds one copy of the codebook instead of one a block of
//   four. Its warps start their first pair's copies, then the whole block
//   stages the codebook (one barrier) while those copies are in flight.
//   (An int8 codebook decoded there once into a float32 table, so that a
//   lane reads one float4 a row and does no widening or scaling, was
//   measured slower: its random 16-byte reads take more shared-memory
//   wavefronts than the int8 word reads save in instructions.)
// The TPU's query-routing and decode one-hot matmuls, its P_q queries per
// grid step and its 128-lane output padding have no counterpart: each
// warp reads its own query row and writes exactly k' slots.
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
// edge::Int4; kOneChunk for a scored width of 128. Up to four warps a
// block, independent of each other (no block part), and the register
// budget of 16 warps an SM (8 past deg_p 64).
template <typename T, bool kOneChunk>
struct TileStore {
  template <int NG>
  using Scorer = edge::TileScorer<T, NG, kOneChunk>;
  static constexpr bool kBlockPart = false;
  __host__ __device__ static constexpr int max_warps(int) { return kWarps; }
  __host__ __device__ static constexpr int min_blocks(int ng) {
    return ng <= 2 ? 4 : 2;
  }
  __host__ __device__ static size_t stage_words(int, const PqArgs&) {
    return edge::stage_words<T, kOneChunk>();
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
  __device__ static void stage_block(char*, const PqArgs&, int, int, int) {}
};

// The pq store: an int8 (kI8, with its subspace scales) or float32
// codebook, held once a block in shared memory as it is stored (an int8
// entry is decoded at every read, float(t) · scale[s] in one __fmul_rn).
// One block an SM of up to 16 warps (8 past deg_p 64), so that an SM
// holds one copy of the codebook; the register budget is the dense
// store's at the same warps an SM.
template <bool kI8>
struct PqStore {
  template <int NG>
  using Scorer = edge::PqScorer<NG, kI8>;
  static constexpr bool kBlockPart = true;
  __host__ __device__ static constexpr int max_warps(int ng) {
    return ng <= 2 ? 16 : 8;
  }
  __host__ __device__ static constexpr int min_blocks(int) { return 1; }
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

  // The codebook into the block's shared memory, by all its threads, 16
  // bytes a thread and step, four steps' loads in flight at once.
  __device__ static void stage_block(char* block, const PqArgs& a,
                                     int dim_p, int tid, int nthreads) {
    constexpr int kBatch = 4;
    const int n16 = (int)(block_bytes(dim_p, a) / 16);
    const int4* from = static_cast<const int4*>(a.cb);
    int4* to = reinterpret_cast<int4*>(block);
    for (int i0 = tid; i0 < n16; i0 += kBatch * nthreads) {
      int4 w[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * nthreads;
        if (i < n16) w[b] = __ldg(from + i);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int i = i0 + b * nthreads;
        if (i < n16) to[i] = w[b];
      }
    }
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
__global__ void __launch_bounds__(32 * P::max_warps(NG), P::min_blocks(NG))
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
  const size_t bb = P::block_bytes(dim_p, pa);  // the block's part
  char* block = reinterpret_cast<char*>(smem);
  int pair = blockIdx.x * warps + warp;
  const bool live = pair < pairs;
  // warps are independent (no block barrier) unless there is a block part
  if (!P::kBlockPart && !live) return;
  float* base = reinterpret_cast<float*>(block + bb) +
                (size_t)warp * warp_words<P>(dim_p, pa);
  float* qbuf = base + P::stage_words(dim_p, pa);
  const size_t tile = (size_t)deg_p * P::row_bytes(dim_p, pa);
  typename P::template Scorer<NG> sc;
  P::bind(sc, reinterpret_cast<uint32_t*>(base), block, pa, dim_p);
  // a pair's query and tile are in flight while the pair before sorts
  // (the first pair's while the block stages its part)
  if (live) {
    const int pid = pids[pair];
    copy_query(qbuf, q + (size_t)(pair / width) * dim_p, dim_p, lane);
    sc.issue(vecs + (size_t)pid * tile, aux + (size_t)pid * 2 * deg_p,
             pen != nullptr ? pen + (size_t)pid * deg_p : nullptr, deg_p,
             dim_p, lane);
  }
  if constexpr (P::kBlockPart) {  // pq: the codebook, once for all warps
    P::stage_block(block, pa, dim_p, threadIdx.x, blockDim.x);
    __syncthreads();
    if (!live) return;
  }
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

// An instance and the most warps a block it takes.
struct Instance {
  const void* kern;
  int max_warps;
};

template <class P, int NG>
Instance instance() {
  return {(const void*)&graph_expand_kernel<P, NG>, P::max_warps(NG)};
}

// The instance for the shape (NG: the next power of two of deg_p / 32),
// or a null kernel past deg_p 256.
template <class P>
Instance kernel_for(int deg_p) {
  if (deg_p <= 32) return instance<P, 1>();
  if (deg_p <= 64) return instance<P, 2>();
  if (deg_p <= 128) return instance<P, 4>();
  if (deg_p <= 256) return instance<P, 8>();
  return {nullptr, 0};
}

// Shared memory a block needs at one warp, in bytes.
template <class P>
size_t smem_bytes(int dim_p, const PqArgs& a) {
  return P::block_bytes(dim_p, a) + warp_bytes<P>(dim_p, a);
}

template <class P>
int info(int deg_p, int dim_p, const PqArgs& a, int* out) {
  const Instance in = kernel_for<P>(deg_p);
  if (in.kern == nullptr) return (int)cudaErrorInvalidValue;
  return (int)edge::instance_info(in.kern, in.max_warps,
                                  warp_bytes<P>(dim_p, a), out,
                                  P::block_bytes(dim_p, a));
}

template <class P>
int launch(const void* pids, const void* q, const void* vecs,
           const void* aux, const void* pen, PqArgs pa, int pairs, int width,
           int deg_p, int dim_p, int degree, int kout, int metric,
           void* out_v, void* out_i, void* stream) {
  const Instance in = kernel_for<P>(deg_p);
  if (in.kern == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&pids,  &q,     &vecs,  &aux,   &pen,    &pa,
                  &pairs, &width, &deg_p, &dim_p, &degree, &kout,
                  &metric, &out_v, &out_i};
  return (int)edge::launch_persistent(
      in.kern, in.max_warps, warp_bytes<P>(dim_p, pa), pairs, args,
      (cudaStream_t)stream, P::block_bytes(dim_p, pa));
}

}  // namespace k5
