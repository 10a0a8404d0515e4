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
// q[d] * widen(v[d]) over its dims in order (chunk by chunk), then the
// warp adds the 32 partial sums by an xor butterfly. Every product and
// add is __fmul_rn / __fadd_rn, so nvcc cannot contract them into FMAs:
// on integer-valued stores and queries every sum is exact and the kernels
// equal the plain PyTorch version bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "topk_common.cuh"

namespace edge {

constexpr int kMetricL2 = 0;
constexpr int kMetricIP = 1;
constexpr int kChunk = 128;   // dims per chunk: 32 lanes x 4
constexpr int kRowGroup = 8;  // rows whose loads are issued together

struct Vals4 {
  float v[4];
};

__device__ __forceinline__ Vals4 load4(const int8_t* p) {
  const char4 c = *reinterpret_cast<const char4*>(p);
  return {{(float)c.x, (float)c.y, (float)c.z, (float)c.w}};
}

// bf16 stored as its 16 raw bits: widening is a shift, exact.
__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

__device__ __forceinline__ Vals4 load4(const uint16_t* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return {{bf16_bits_to_float(u.x & 0xffffu), bf16_bits_to_float(u.x >> 16),
           bf16_bits_to_float(u.y & 0xffffu), bf16_bits_to_float(u.y >> 16)}};
}

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

// Score one parent's tile into sc[0, deg_p): per edge e,
//   cross = (q . widen(v_e)) * scale_e
//   l2: max((||q||² + ||v_e||²) - 2 cross, 0)      ip: -cross
// plus pen[e] when a penalty row is given, and +inf for e >= degree (pad
// edges). aux holds [scales (deg_p), dequantized norms (deg_p)].
// deg_p is a multiple of 32, dim_p of 128; the caller syncs the warp
// before reading sc.
template <typename T>
__device__ __forceinline__ void score_tile(
    const T* __restrict__ tile, const float* __restrict__ aux,
    const float* __restrict__ pen, const float* qs, float qn, int deg_p,
    int dim_p, int degree, int metric, float* sc, int lane) {
  for (int e0 = 0; e0 < deg_p; e0 += kRowGroup) {
    float acc[kRowGroup];
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) acc[u] = 0.f;
    for (int c = 0; c < dim_p; c += kChunk) {
      const int d = c + 4 * lane;
      Vals4 v[kRowGroup];
#pragma unroll
      for (int u = 0; u < kRowGroup; ++u) {
        v[u] = load4(tile + (size_t)(e0 + u) * dim_p + d);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float qj = qs[d + j];
#pragma unroll
        for (int u = 0; u < kRowGroup; ++u) {
          acc[u] = __fadd_rn(acc[u], __fmul_rn(qj, v[u].v[j]));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kRowGroup; ++u) {
      const float dot = warp_sum(acc[u]);
      const int e = e0 + u;
      if (lane == (e & 31)) {
        const float cross = __fmul_rn(dot, aux[e]);
        float dist;
        if (metric == kMetricL2) {
          dist = fmaxf(__fsub_rn(__fadd_rn(qn, aux[deg_p + e]),
                                 __fmul_rn(2.f, cross)),
                       0.f);
        } else {
          dist = -cross;
        }
        if (pen != nullptr) dist = __fadd_rn(dist, pen[e]);
        sc[e] = e < degree ? dist : CUDART_INF_F;
      }
    }
  }
}

// The k' best of sc[0, deg_p) by (value, edge position), written best
// first to out_v / out_i: out_i is the edge position, or ids[position]
// when an id row is given, and -1 where the value is not finite (the
// Pallas extraction's empty slot). Each edge's rank is the number of
// edges ahead of it, so no two edges share a slot.
__device__ __forceinline__ void tile_topk(const float* sc, int deg_p,
                                          int kout,
                                          const int* __restrict__ ids,
                                          float* out_v, int* out_i,
                                          int lane) {
  for (int e = lane; e < deg_p; e += 32) {
    const float v = sc[e];
    int r = 0;
    for (int f = 0; f < deg_p; ++f) {
      r += key_less(sc[f], f, v, e) ? 1 : 0;
    }
    if (r < kout) {
      out_v[r] = v;
      out_i[r] = isfinite(v) ? (ids != nullptr ? ids[e] : e) : -1;
    }
  }
}

}  // namespace edge
