// Edge-tile scoring and per-parent top-k', shared by K5 (graph_expand.cu)
// and K6 (cagra_fused.cu), so that both kernels compute the same bits.
//
// The counterpart of raft_tpu/ops/graph_expand.py::edge_tile_widen (dense
// mode) and the epilogue + extraction of its _kernel. One warp scores one
// parent's tile: the (deg_p, dim_p) rows of its neighbors' stored vectors
// (int8 with a per-edge scale, or bf16), against one float32 query.
//
// Summation order, fixed so that every caller gets the same bits: lane l
// owns dims [128c + 4l, 128c + 4l + 4) of every 128-dim chunk c; it sums
// q[d] * widen(v[d]) over its dims in order (chunk by chunk), then the 32
// partial sums meet in the tree of an xor butterfly (pairs l, l ^ 16
// first, then l ^ 8, ... l ^ 1). Every product and add is __fmul_rn /
// __fadd_rn, so nvcc cannot contract them into FMAs: on integer-valued
// stores and queries every sum is exact and the kernels equal the plain
// PyTorch version (graph_expand.py::lane_order_dot) bit for bit.
//
// Design on Hopper (the cost of a hop is instructions and latency, not
// bytes):
// - TileScorer::issue puts the parent's tile in flight: units of 32 rows
//   by one 128-dim chunk, copied by cp.async into the warp's shared
//   memory, two units at once (at the path's 64 x 128 int8 tile, the
//   whole tile; the stage does not grow with the width), with its aux
//   (scale, norm) and penalty words; finish() reads a lane's word of each
//   row (an int8 word is its 4 dims of a chunk, a bf16 word 2 of them)
//   from there.
// - int8 widens without the conversion unit: the byte, xor 0x80, is
//   placed in the mantissa of 2^23 by one prmt, and 2^23 + 128 is
//   subtracted — exact, so the products keep their bits.
// - The 32 rows of a group meet in a reduce-scatter instead of 32
//   butterflies: lane l sums row i ^ l into acc[i], so at xor distance
//   16, 8, 4, 2, 1 every lane keeps the low half of its registers and
//   adds its partner's high half, which holds the same rows. That is the
//   butterfly's own tree, and it ends with row e's sum in lane e & 31:
//   31 shuffles and no select for 32 rows, instead of 160 shuffles.
// - The per-parent top-k' is a bitonic network over the warp, NG keys a
//   lane (edge e = 32g + lane in register g), on one 64-bit key a cell
//   (sort_key: the value's order bits, the edge position, a flag that
//   keeps a -0.0 value's sign).
//
// The packed stores keep that order (lane l still adds scored dims
// 128c + 4l + j), so the plain version's lane_order_dot serves them too:
// - int4 (TileScorer<Int4>; raft_tpu/ops/graph_expand.py's "int4" mode):
//   a row is dim_p / 2 bytes of split-half nibbles, byte j holding dim j
//   low and dim dim_p / 2 + j high. The 64 dims of each half of a chunk
//   lie on one plane, in 64 consecutive bytes; a unit stages the two
//   64-byte segments of a chunk's halves, so lane l reads word l and
//   widens the low or the high nibbles. At dim_p 128 (the path's width)
//   both segments are the row's 64 bytes, so a unit stages each row once
//   (2 KB, rows 16..31 swapped in pairs so that the lanes meet 32 banks)
//   and lane l reads word l % 16 of it, the low nibbles below lane 16 and
//   the high ones from it. A nibble + 8 goes into the mantissa of 2^23 by
//   the same prmt as int8: exact.
// - pq (PqScorer; the "pq" mode, K5 only): a row is pq_dim uint8 codes;
//   the compact codebook (pq_dim, book, pq_len), int8 with pq_dim scales
//   or float32, sits in the block's shared memory, staged once a block
//   (graph_expand.cuh::PqStore: one block an SM). A unit is 32 rows'
//   codes; lane l decodes its 4 dims of each chunk from the code of each
//   dim's subspace (one code and one word of the codebook when pq_len % 4
//   == 0, else dim by dim: at pq_len 2 a lane's 4 dims span two
//   subspaces), in int8 mode times the subspace's scale in one __fmul_rn
//   — the JAX kernel's int8 decode, float(t) * scale. The code loads meet
//   32 distinct banks: lane l reads byte s of row i ^ l, rows pq_dim
//   bytes apart, and (row, subspace) over the lanes covers the 32 banks
//   at pq_dim 16 and 64.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include <mutex>
#include <type_traits>

#include "topk_common.cuh"

namespace edge {

constexpr int kMetricL2 = 0;
constexpr int kMetricIP = 1;
constexpr int kChunk = 128;  // dims per chunk: 32 lanes x 4
constexpr int kUnit = 32;    // rows of a group: one a register of acc

// How a lane's word of a row widens: Store<T>::kWords words a row and
// chunk, Store<T>::kDims dims a word.
template <typename T>
struct Store;

template <>
struct Store<int8_t> {
  static constexpr int kWords = 1;
  static constexpr int kDims = 4;
  __device__ static __forceinline__ void widen(uint32_t w, float (&v)[4]) {
    const uint32_t u = w ^ 0x80808080u;  // byte b -> b + 128, unsigned
    v[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)),
                     8388736.f);
    v[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)),
                     8388736.f);
    v[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)),
                     8388736.f);
    v[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)),
                     8388736.f);
  }
};

// bf16 stored as its 16 raw bits: widening is a shift, exact.
template <>
struct Store<uint16_t> {
  static constexpr int kWords = 2;
  static constexpr int kDims = 2;
  __device__ static __forceinline__ void widen(uint32_t w, float (&v)[2]) {
    v[0] = __uint_as_float(w << 16);
    v[1] = __uint_as_float(w & 0xffff0000u);
  }
};

// Tag of the int4 store: split-half nibbles, two dims a byte.
struct Int4 {};

// A word's four nibbles of one plane (0: low, 1: high), sign-extended and
// widened: nibble + 8 (an xor) in the mantissa of 2^23, less 2^23 + 8 —
// exact, as ops/quant.int4_nibbles' shifts are.
template <>
struct Store<Int4> {
  static constexpr int kWords = 1;
  static constexpr int kDims = 4;
  __device__ static __forceinline__ void widen(uint32_t w, int plane,
                                               float (&v)[4]) {
    const uint32_t u = ((w >> (4 * plane)) & 0x0f0f0f0fu) ^ 0x08080808u;
    v[0] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540)),
                     8388616.f);
    v[1] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7541)),
                     8388616.f);
    v[2] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7542)),
                     8388616.f);
    v[3] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7543)),
                     8388616.f);
  }
};

// Sum over the warp; every lane ends with the same bits (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = __fadd_rn(v, __shfl_xor_sync(RAFT_FULL_MASK, v, off));
  }
  return v;
}

// ||q||² of the query in shared memory, in the scoring's order.
__device__ __forceinline__ float warp_sqnorm(const float* qs, int dim_p,
                                             int lane) {
  float acc = 0.f;
  for (int c = 0; c < dim_p; c += kChunk) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float x = qs[c + 4 * lane + j];
      acc = __fadd_rn(acc, __fmul_rn(x, x));
    }
  }
  return warp_sum(acc);
}

// One step of the reduce-scatter. Lane l's acc[i] holds row i ^ l's
// partial, so its partner l ^ OFF holds the same row r ^ l in acc[r + OFF]
// for r < OFF: every lane keeps acc[r] and adds the partner's acc[r + OFF]
// — the butterfly's pair sum of that row, with no select.
template <int OFF>
__device__ __forceinline__ void scatter_step(float (&acc)[kUnit]) {
#pragma unroll
  for (int r = 0; r < OFF; ++r) {
    acc[r] = __fadd_rn(acc[r],
                       __shfl_xor_sync(RAFT_FULL_MASK, acc[r + OFF], OFF));
  }
}

// The butterfly's sums of 32 rows, lane l holding row i ^ l's partial in
// acc[i]: returns row (lane)'s sum (acc[0] ends as row 0 ^ l). acc is
// clobbered.
__device__ __forceinline__ float reduce_scatter(float (&acc)[kUnit]) {
  scatter_step<16>(acc);
  scatter_step<8>(acc);
  scatter_step<4>(acc);
  scatter_step<2>(acc);
  scatter_step<1>(acc);
  return acc[0];
}

// A cell's 64-bit key: ascending keys are ascending (value, position)
// under the float compare (-0.0 equal to 0.0; NaN after +inf). The high
// word is the value's order bits, the low word position << 2 | a -0.0
// flag << 1, bit 0 left to the caller (K6: explored). Positions are
// distinct, so neither flag ever decides the order.
constexpr uint32_t kOrdInf = 0xff800000u;  // order bits of +inf

__device__ __forceinline__ uint64_t sort_key(float v, int pos) {
  uint32_t u = __float_as_uint(v);
  const uint32_t neg0 = u == 0x80000000u ? 1u : 0u;
  if (neg0) u = 0u;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((uint64_t)u << 32) | ((uint32_t)pos << 2) | (neg0 << 1);
}
__device__ __forceinline__ float key_value(uint64_t k) {
  if (k & 2u) return -0.f;
  uint32_t u = (uint32_t)(k >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}
__device__ __forceinline__ int key_pos(uint64_t k) {
  return (int)((uint32_t)k >> 2);
}
__device__ __forceinline__ bool key_finite(uint64_t k) {
  return (uint32_t)(k >> 32) < kOrdInf;
}

// One compare-exchange step (S, J) of the bitonic network over the
// warp's NG * 32 keys, element n = 32g + lane in key[g]: cell n keeps the
// smaller of itself and cell n ^ J when (n & J == 0) == (n & S == 0),
// else the larger; then the steps J / 2 ... 1 of the same stage.
template <int NG, int S, int J>
__device__ __forceinline__ void sort_step(uint64_t (&key)[NG], int lane) {
  if constexpr (J >= 32) {  // partners in one lane's registers
    constexpr int jr = J / 32;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if ((g & jr) == 0) {
        const bool asc = ((g * 32) & S) == 0;
        const uint64_t a = key[g], b = key[g | jr];
        const bool sw = asc ? (b < a) : (a < b);
        key[g] = sw ? b : a;
        key[g | jr] = sw ? a : b;
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int n = g * 32 + lane;
      const uint64_t o = __shfl_xor_sync(RAFT_FULL_MASK, key[g], J);
      const bool keep_min = ((n & J) == 0) == ((n & S) == 0);
      key[g] = ((o < key[g]) == keep_min) ? o : key[g];
    }
  }
  if constexpr (J > 1) sort_step<NG, S, J / 2>(key, lane);
}

template <int NG, int S>
__device__ __forceinline__ void sort_stage(uint64_t (&key)[NG], int lane) {
  sort_step<NG, S, S / 2>(key, lane);
  if constexpr (S < NG * 32) sort_stage<NG, S * 2>(key, lane);
}

// Sort the warp's NG * 32 distinct keys ascending, element n = 32g + lane
// in key[g] (a bitonic network; NG a power of two).
template <int NG>
__device__ __forceinline__ void warp_sort(uint64_t (&key)[NG], int lane) {
  sort_stage<NG, 2>(key, lane);
}

// Start a 16-byte copy from device to shared memory.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
// Wait until at most N of this thread's copy groups are in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A store's staged bytes of one row and 128-dim chunk (int4: its two
// 64-byte segments, or at a scored width of 128 (kOneChunk) the row's 64
// bytes, which hold both): a unit is 32 such rows, and a warp's stage two
// units (the same size at any width).
template <typename T, bool kOneChunk = false>
__host__ __device__ constexpr int chunk_row_bytes() {
  if constexpr (std::is_same<T, Int4>::value) return kOneChunk ? 64 : 128;
  return kChunk * (int)sizeof(T);
}
template <typename T, bool kOneChunk = false>
__host__ __device__ constexpr size_t stage_words() {
  return (size_t)2 * kUnit * chunk_row_bytes<T, kOneChunk>() / 4;
}
// The same for a scored width of dim_p.
template <typename T>
__host__ __device__ constexpr size_t stage_words_at(int dim_p) {
  return dim_p == kChunk ? stage_words<T, true>() : stage_words<T, false>();
}

// Where row r of an int4 unit of 64-byte rows is staged: rows 16..31 swap
// in pairs, so that lanes l and l ^ 16, which read the same word of rows
// 16 apart, meet different banks (all 32 lanes distinct banks).
__host__ __device__ constexpr int i4_row(int r) { return r ^ ((r >> 4) & 1); }

// The kernels' value of edge e: cross = dot * scale,
//   l2: max((||q||² + ||v_e||²) - 2 cross, 0)      ip: -cross
// plus the penalty when there is one, +inf for a pad edge (!real).
__device__ __forceinline__ float edge_value(float dot, float scale,
                                            float norm, float pn, float qn,
                                            int metric, bool has_pen,
                                            bool real) {
  const float cross = __fmul_rn(dot, scale);
  float d;
  if (metric == kMetricL2) {
    d = fmaxf(__fsub_rn(__fadd_rn(qn, norm), __fmul_rn(2.f, cross)), 0.f);
  } else {
    d = -cross;
  }
  if (has_pen) d = __fadd_rn(d, pn);
  return real ? d : CUDART_INF_F;
}

// A tile's aux (scale, norm) and penalty words, edge 32g + lane in g.
template <int NG>
__device__ __forceinline__ void load_aux(const float* aux, const float* pen,
                                         int deg_p, int lane,
                                         float (&scale)[NG],
                                         float (&norm)[NG],
                                         float (&pn)[NG]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int e = g * 32 + lane;
    scale[g] = norm[g] = pn[g] = 0.f;
    if (e < deg_p) {
      scale[g] = __ldg(aux + e);
      norm[g] = __ldg(aux + deg_p + e);
      pn[g] = pen != nullptr ? __ldg(pen + e) : 0.f;
    }
  }
}

// One parent's tile scored into NG registers a lane: dist[g] is edge
// 32g + lane's value (edge_value), +inf for e >= degree (pad edges) and
// for the sort's pad cells (e >= deg_p). aux holds [scales (deg_p),
// dequantized norms (deg_p)]. deg_p is a multiple of 32 and at most
// 32·NG, dim_p (the scored width) a multiple of 128 (kOneChunk: 128, so
// the loop over a group's chunks is unrolled away; K6 at chip_smoke's
// shape on an H100 took 2.53-2.56 ms with it and 2.98-3.03 ms without,
// in one process of tools/kernel_ab.py). T: int8_t, uint16_t (bf16 bits)
// or Int4.
//
// The tile comes in units of 32 rows by one 128-dim chunk (group g =
// rows 32g ..., chunk c), group by group and chunk by chunk within a
// group, each copied into shared memory by cp.async, 16 bytes a lane a
// step, two units in flight: issue() starts units 0 and 1, finish() waits
// for each in turn and starts unit u + 2 in its place. So the stage is
// the same size at any width, and a lane adds a row's chunks in the
// contract's order. Lane l reads its word of row i ^ l into acc[i] (one
// bank a lane for int8 and int4), which is what the reduce-scatter wants.
template <typename T, int NG, bool kOneChunk = false>
struct TileScorer {
  using S = Store<T>;
  static constexpr bool kI4 = std::is_same<T, Int4>::value;
  static constexpr int kRowBytes = chunk_row_bytes<T, kOneChunk>();
  static constexpr int kUnitBytes = kUnit * kRowBytes;
  static constexpr int kRowWords = kRowBytes / 4;  // a row's chunk
  static constexpr int kSegs = kRowBytes / 16;     // its copies
  uint32_t* stage;  // the warp's stage_words<T>() words
  const char* src;  // the tile
  float scale[NG], norm[NG], pn[NG];
  int row_bytes, groups, chunks, half;

  // A row's stored bytes at scored width dim_p.
  __host__ __device__ static constexpr int stored_row_bytes(int dim_p) {
    return kI4 ? dim_p / 2 : dim_p * (int)sizeof(T);
  }

  // int4: the byte of a row where the 64 dims of half-chunk h start (the
  // low plane below half, the high plane from it).
  __device__ __forceinline__ int segment(int h) const {
    return 64 * h < half ? 64 * h : 64 * h - half;
  }

  // Copy unit u: the chunk u % chunks of the rows of group u / chunks.
  __device__ __forceinline__ void copy_unit(int u, int lane) const {
    char* to = reinterpret_cast<char*>(stage) + (u & 1) * kUnitBytes;
    if constexpr (kI4 && kOneChunk) {  // 32 contiguous 64-byte rows, once
      const char* from = src + (size_t)u * kUnitBytes;
      for (int off = 16 * lane; off < kUnitBytes; off += 16 * 32) {
        cp_async16(to + i4_row(off >> 6) * 64 + (off & 63), from + off);
      }
    } else if constexpr (kI4) {  // the two 64-byte segments of a chunk
      const int nc = kOneChunk ? 1 : chunks;
      const int g = u / nc, c = u - g * nc;
      const char* from = src + (size_t)g * kUnit * row_bytes;
      const int oa = segment(2 * c), ob = segment(2 * c + 1);
      for (int i = lane; i < kUnit * kSegs; i += 32) {
        const int r = i / kSegs, sg = i % kSegs;
        cp_async16(to + 16 * i, from + (size_t)r * row_bytes +
                                    (sg < 4 ? oa : ob) + 16 * (sg & 3));
      }
    } else if constexpr (kOneChunk) {  // the unit's 32 rows are contiguous
      const char* from = src + (size_t)u * kUnitBytes;
      for (int off = 16 * lane; off < kUnitBytes; off += 16 * 32) {
        cp_async16(to + off, from + off);
      }
    } else {
      const int g = u / chunks, c = u - g * chunks;
      const char* from = src + (size_t)g * kUnit * row_bytes +
                         (size_t)c * kChunk * sizeof(T);
      for (int i = lane; i < kUnit * kSegs; i += 32) {
        const int r = i / kSegs, sg = i % kSegs;
        cp_async16(to + 16 * i, from + (size_t)r * row_bytes + 16 * sg);
      }
    }
    cp_commit();
  }

  // Start the copies of one parent's tile and the loads of its aux and
  // penalty words.
  __device__ __forceinline__ void issue(const void* tile, const float* aux,
                                        const float* pen, int deg_p,
                                        int dim_p, int lane) {
    src = reinterpret_cast<const char*>(tile);
    row_bytes = stored_row_bytes(dim_p);
    half = dim_p / 2;
    groups = deg_p / kUnit;
    chunks = kOneChunk ? 1 : dim_p / kChunk;
    load_aux<NG>(aux, pen, deg_p, lane, scale, norm, pn);
    copy_unit(0, lane);
    if (groups * chunks > 1) copy_unit(1, lane);
  }

  // Finish the tile started by issue(): dist[g] for every g (+inf past
  // deg_p). qs is the query in shared memory, qn its ||q||²; with
  // `fresh_q` the query's own copy group came just before the tile's, and
  // qn is computed here once it has landed.
  __device__ __forceinline__ void finish(const float* qs, float& qn,
                                         bool fresh_q, int dim_p, int degree,
                                         int metric, bool has_pen, int lane,
                                         float (&dist)[NG]) {
    const int nc = kOneChunk ? 1 : chunks, units = groups * nc;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      dist[g] = CUDART_INF_F;
      if (g < groups) {
        float acc[kUnit];
#pragma unroll
        for (int i = 0; i < kUnit; ++i) acc[i] = 0.f;
        for (int c = 0; c < nc; ++c) {
          const int u = g * nc + c;
          if (u + 1 < units) cp_wait<1>(); else cp_wait<0>();
          __syncwarp();
          if (u == 0 && fresh_q) qn = warp_sqnorm(qs, dim_p, lane);
          const uint32_t* rows = stage + (u & 1) * kUnit * kRowWords;
          if constexpr (kI4) {
            // lane l's dims 128c + 4l + j: half-chunk 2c + (l >= 16)
            const float4 q4 =
                *reinterpret_cast<const float4*>(qs + c * kChunk + 4 * lane);
            const float q[4] = {q4.x, q4.y, q4.z, q4.w};
            const int plane = 64 * (2 * c + (lane >> 4)) >= half ? 1 : 0;
            // one copy (kOneChunk): row i ^ l at i4_row, word l % 16
            const int lw = kOneChunk ? lane & 15 : lane;
            const int lr = kOneChunk ? i4_row(lane) : lane;
#pragma unroll
            for (int i = 0; i < kUnit; ++i) {
              float v[4];
              const int r = kOneChunk ? i4_row(i) ^ lr : i ^ lr;
              S::widen(rows[r * kRowWords + lw], plane, v);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc[i] = __fadd_rn(acc[i], __fmul_rn(q[j], v[j]));
              }
            }
          } else {
            const uint32_t* lrows = rows + S::kWords * lane;
#pragma unroll
            for (int h = 0; h < S::kWords; ++h) {  // chunk c, word h
              const float* qp = qs + c * kChunk + 4 * lane + S::kDims * h;
              float q[S::kDims];
              if constexpr (S::kDims == 4) {
                const float4 q4 = *reinterpret_cast<const float4*>(qp);
                q[0] = q4.x, q[1] = q4.y, q[2] = q4.z, q[3] = q4.w;
              } else {
                const float2 q2 = *reinterpret_cast<const float2*>(qp);
                q[0] = q2.x, q[1] = q2.y;
              }
#pragma unroll
              for (int i = 0; i < kUnit; ++i) {
                float v[S::kDims];
                S::widen(lrows[(i ^ lane) * kRowWords + h], v);
#pragma unroll
                for (int j = 0; j < S::kDims; ++j) {
                  acc[i] = __fadd_rn(acc[i], __fmul_rn(q[j], v[j]));
                }
              }
            }
          }
          __syncwarp();  // every lane is done with this stage buffer
          if (u + 2 < units) copy_unit(u + 2, lane);
        }
        const float dot = reduce_scatter(acc);
        dist[g] = edge_value(dot, scale[g], norm[g], pn[g], qn, metric,
                             has_pen, g * 32 + lane < degree);
      }
    }
  }
};

// One parent's pq tile scored as TileScorer does, from codes: kI8 an int8
// codebook with float32 subspace scales, else a float32 one. The codebook
// (pq_dim, book, pq_len) is in the block's shared memory (cbs); the
// stage holds two units of 32 rows' pq_dim codes, group by group (every
// chunk of a group reads the same unit).
template <int NG, bool kI8>
struct PqScorer {
  uint32_t* stage;      // the warp's stage_words(pq_dim) words
  const void* cbs;      // the codebook, in shared memory
  const float* cscale;  // int8: the (pq_dim,) scales, in device memory
  const char* src;      // the tile
  float scale[NG], norm[NG], pn[NG];
  int pq_dim, book, pq_len, groups, unit_bytes;

  __host__ __device__ static constexpr size_t stage_words(int pq_dim) {
    return (size_t)2 * kUnit * pq_dim / 4;
  }
  __host__ __device__ static constexpr size_t codebook_bytes(int dim_p,
                                                             int book) {
    return (size_t)dim_p * book * (kI8 ? 1 : 4);
  }

  __device__ __forceinline__ void bind(uint32_t* st, const void* cb,
                                       const float* sc, int dim_p, int w,
                                       int b) {
    stage = st, cbs = cb, cscale = sc;
    pq_dim = w, book = b, pq_len = dim_p / w;
    unit_bytes = kUnit * w;
  }

  __device__ __forceinline__ void copy_unit(int u, int lane) const {
    char* to = reinterpret_cast<char*>(stage) + (u & 1) * unit_bytes;
    const char* from = src + (size_t)u * unit_bytes;
    for (int off = 16 * lane; off < unit_bytes; off += 16 * 32) {
      cp_async16(to + off, from + off);
    }
    cp_commit();
  }

  __device__ __forceinline__ void issue(const void* tile, const float* aux,
                                        const float* pen, int deg_p,
                                        int /*dim_p*/, int lane) {
    src = reinterpret_cast<const char*>(tile);
    groups = deg_p / kUnit;
    load_aux<NG>(aux, pen, deg_p, lane, scale, norm, pn);
    copy_unit(0, lane);
    if (groups > 1) copy_unit(1, lane);
  }

  // Codeword entry `idx` of the codebook, decoded: float(t) * scale[s]
  // (int8) or the float itself.
  __device__ __forceinline__ float entry(int idx, float sc) const {
    if constexpr (kI8) {
      const int8_t t = reinterpret_cast<const int8_t*>(cbs)[idx];
      return __fmul_rn(__int2float_rn((int)t), sc);
    } else {
      return reinterpret_cast<const float*>(cbs)[idx];
    }
  }

  __device__ __forceinline__ void finish(const float* qs, float& qn,
                                         bool fresh_q, int dim_p, int degree,
                                         int metric, bool has_pen, int lane,
                                         float (&dist)[NG]) {
    const int chunks = dim_p / kChunk;
    const int cw = book * pq_len;  // a subspace's codebook entries
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      dist[g] = CUDART_INF_F;
      if (g < groups) {
        float acc[kUnit];
#pragma unroll
        for (int i = 0; i < kUnit; ++i) acc[i] = 0.f;
        if (g + 1 < groups) cp_wait<1>(); else cp_wait<0>();
        __syncwarp();
        if (g == 0 && fresh_q) qn = warp_sqnorm(qs, dim_p, lane);
        const uint8_t* codes =
            reinterpret_cast<const uint8_t*>(stage) + (g & 1) * unit_bytes;
        for (int c = 0; c < chunks; ++c) {
          const int d0 = c * kChunk + 4 * lane;
          const float4 q4 = *reinterpret_cast<const float4*>(qs + d0);
          const float q[4] = {q4.x, q4.y, q4.z, q4.w};
          if (pq_len % 4 == 0) {  // the lane's 4 dims: one subspace, aligned
            const int s = d0 / pq_len;
            const int base = s * cw + (d0 - s * pq_len);
            const float sc = kI8 ? __ldg(cscale + s) : 1.f;
#pragma unroll
            for (int i = 0; i < kUnit; ++i) {
              const int idx = base + codes[(i ^ lane) * pq_dim + s] * pq_len;
              float v[4];
              if constexpr (kI8) {
                Store<int8_t>::widen(
                    reinterpret_cast<const uint32_t*>(cbs)[idx >> 2], v);
#pragma unroll
                for (int j = 0; j < 4; ++j) v[j] = __fmul_rn(v[j], sc);
              } else {
                const float4 e =
                    reinterpret_cast<const float4*>(cbs)[idx >> 2];
                v[0] = e.x, v[1] = e.y, v[2] = e.z, v[3] = e.w;
              }
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                acc[i] = __fadd_rn(acc[i], __fmul_rn(q[j], v[j]));
              }
            }
          } else {  // dim by dim: the 4 dims may span two subspaces
            int sj[4], bj[4];
            float scj[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sj[j] = (d0 + j) / pq_len;
              bj[j] = sj[j] * cw + (d0 + j - sj[j] * pq_len);
              scj[j] = kI8 ? __ldg(cscale + sj[j]) : 1.f;
            }
#pragma unroll
            for (int i = 0; i < kUnit; ++i) {
              const uint8_t* row = codes + (i ^ lane) * pq_dim;
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float v = entry(bj[j] + row[sj[j]] * pq_len, scj[j]);
                acc[i] = __fadd_rn(acc[i], __fmul_rn(q[j], v));
              }
            }
          }
        }
        __syncwarp();  // every lane is done with this stage buffer
        if (g + 2 < groups) copy_unit(g + 2, lane);
        const float dot = reduce_scatter(acc);
        dist[g] = edge_value(dot, scale[g], norm[g], pn[g], qn, metric,
                             has_pen, g * 32 + lane < degree);
      }
    }
  }
};

// The sorted keys of one scored tile: key[g] holds rank 32g + lane.
template <int NG>
__device__ __forceinline__ void sort_tile(const float (&dist)[NG], int lane,
                                          uint64_t (&key)[NG]) {
#pragma unroll
  for (int g = 0; g < NG; ++g) key[g] = sort_key(dist[g], g * 32 + lane);
  warp_sort<NG>(key, lane);
}

// Host: how a persistent kernel launches on the current card when each of
// its warps uses `warp_bytes` of dynamic shared memory and the block
// `block_bytes` more (K5's pq codebook) — warps a block (at most
// max_warps, as many as the card's per-block limit holds, so a wide tile
// takes fewer warps a block, not an error), blocks an SM, and the card's
// SMs. Found once per (kernel, card, warp_bytes, block_bytes) and kept,
// so a later launch asks the runtime nothing but the current card.
struct Shape {
  int warps, blocks_per_sm, sms;
};

inline cudaError_t persistent_shape(const void* kern, int max_warps,
                                    size_t warp_bytes, Shape* out,
                                    size_t block_bytes = 0) {
  struct Entry {
    const void* kern;
    int dev;
    size_t warp_bytes, block_bytes;
    Shape shape;
  };
  static std::mutex mu;
  static Entry kept[64];
  static int n_kept = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_kept; ++i) {
    if (kept[i].kern == kern && kept[i].dev == dev &&
        kept[i].warp_bytes == warp_bytes &&
        kept[i].block_bytes == block_bytes) {
      *out = kept[i].shape;
      return cudaSuccess;
    }
  }
  int optin = 0;
  Shape s{max_warps, 0, 0};
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  while (s.warps > 0 && block_bytes + s.warps * warp_bytes > (size_t)optin) {
    --s.warps;
  }
  if (s.warps == 0) return cudaErrorInvalidValue;
  // the card's whole limit, so no shape of this kernel is refused later
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &s.blocks_per_sm, kern, s.warps * 32,
      block_bytes + s.warps * warp_bytes);
  if (err != cudaSuccess) return err;
  if (s.blocks_per_sm < 1) return cudaErrorInvalidConfiguration;
  if (n_kept < 64) {
    kept[n_kept++] = Entry{kern, dev, warp_bytes, block_bytes, s};
  }
  *out = s;
  return cudaSuccess;
}

// Host: `kern`'s registers a thread, its local memory a thread in bytes
// (spills), the warps an SM keeps resident, the warps a block and the
// shared memory an SM holds in bytes, into info[0..4].
inline cudaError_t instance_info(const void* kern, int max_warps,
                                 size_t warp_bytes, int* info,
                                 size_t block_bytes = 0) {
  Shape s;
  cudaError_t err =
      persistent_shape(kern, max_warps, warp_bytes, &s, block_bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kern);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = (int)attr.localSizeBytes;
  info[2] = s.blocks_per_sm * s.warps;
  info[3] = s.warps;
  info[4] =
      (int)(s.blocks_per_sm * (block_bytes + s.warps * warp_bytes));
  return cudaSuccess;
}

// Host: launch `kern` with persistent warps for `need` warps' worth of
// work: as many blocks as the card keeps resident, at most enough for
// `need`.
inline cudaError_t launch_persistent(const void* kern, int max_warps,
                                     size_t warp_bytes, int need,
                                     void** args, cudaStream_t stream,
                                     size_t block_bytes = 0) {
  Shape s;
  cudaError_t err =
      persistent_shape(kern, max_warps, warp_bytes, &s, block_bytes);
  if (err != cudaSuccess) return err;
  const int want = (need + s.warps - 1) / s.warps;
  const int blocks =
      want < s.blocks_per_sm * s.sms ? want : s.blocks_per_sm * s.sms;
  if (blocks > 0) {
    err = cudaLaunchKernel(kern, dim3(blocks), dim3(s.warps * 32), args,
                           block_bytes + s.warps * warp_bytes, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // namespace edge
