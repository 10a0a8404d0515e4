// K2 — query x corpus distance fused with a running per-query top-k.
//
// Replaces the TPU kernel raft_tpu/ops/fused_knn.py::_fused_knn_padded
// (kernel _kernel): the distance block of a (query tile, corpus tile) pair
// on the MXU, a running k-best in VMEM scratch, ties by (value, smallest
// global column), ids = -1 on +inf slots, the filter as an additive
// penalty row.
//
// Design on Hopper. A block owns 64 queries and walks its split of the
// corpus in tiles of 64 rows. The 64 x 64 dot block is an FP32 SIMT GEMM:
// the query and corpus tiles stream through shared memory 32 dimensions
// at a time, stored transposed (dimension-major, row stride 68) so that a
// thread reads its 4 queries and its 4 rows as two float4 loads, and each
// of 256 threads accumulates a 4 x 4 piece in registers. The loads from
// device memory are coalesced (8 consecutive dimensions of 4 rows per
// warp) and their transposed stores hit 32 distinct banks. The epilogue
// turns dots into distances (l2 from the norms,
// cosine, or -dot for inner product), adds the penalty row and writes the
// block to shared memory. Each warp then keeps the sorted k-best lists of
// 8 queries in shared memory: a candidate that beats the k-th entry is
// inserted (warp_insert), so after the first tiles almost every candidate
// is turned away by one comparison. When there are too few query tiles to
// fill the card, the corpus is split over blockIdx.y; each split writes
// its k best, sorted, into its own k columns of a (m, splits*k) buffer
// and the wrapper merges those with K1. Equal values there come in split
// order and, inside a split, in column order, so K1's lowest-position tie
// break is the lowest global column.
//
// Bound on this card: 2·m·n·d FP32 operations (2.56 TFLOP at m = 10,000,
// n = 1,000,000, d = 128) against 67 TFLOP/s, i.e. operations, not the
// 0.5 GB corpus read. This first version stays on the FP32 SIMT pipe; the
// distance block is the part a later version moves onto the tensor cores
// (3xTF32 wgmma keeps f32 accuracy).
#include "topk_common.cuh"

namespace {

constexpr int TM = 64;        // queries per block
constexpr int TN = 64;        // corpus rows per tile
constexpr int BK = 32;        // dimensions per shared-memory step
constexpr int kThreads = 256;
constexpr int LD = TM + 4;    // row stride of the transposed tiles (TM == TN)
constexpr int DS = TN + 1;    // padded row stride of the distance block

// Copy rows [r_base, r_base + 64) x dimensions [k0, k0 + BK) of the
// row-major (rows, d) matrix src into the dimension-major tile dst
// (BK x LD), zero outside [0, r_end) x [0, d). Each warp covers 4 rows x 8
// dimensions per step: 32-byte sectors from device memory, and transposed
// stores at banks (4c + r) mod 32, all distinct.
__device__ __forceinline__ void load_tile_t(float* dst,
                                            const float* __restrict__ src,
                                            int r_base, int r_end, int k0,
                                            int d, int tid) {
  for (int e = tid; e < TM * BK; e += kThreads) {
    const int w = e >> 5, lane = e & 31;
    const int r = 4 * (w >> 2) + (lane >> 3);
    const int c = 8 * (w & 3) + (lane & 7);
    const int gr = r_base + r, gc = k0 + c;
    dst[c * LD + r] = (gr < r_end && gc < d) ? src[(size_t)gr * d + gc] : 0.f;
  }
}

__global__ void __launch_bounds__(kThreads)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                 const float* __restrict__ data,
                 const float* __restrict__ dn,
                 const float* __restrict__ pen, int m, int n, int d, int k,
                 int metric, int rows_per_split, float* __restrict__ out_v,
                 int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                   // BK x LD, query tile (transposed)
  float* Bs = As + BK * LD;           // BK x LD, corpus tile (transposed)
  float* Ds = Bs + BK * LD;           // TM x DS, distances
  float* Lv = Ds + TM * DS;           // TM x k, running values
  int* Li = (int*)(Lv + TM * k);      // TM x k, running ids

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q0 = blockIdx.x * TM;
  const int split = blockIdx.y;
  const int splits = gridDim.y;
  const int c_begin = split * rows_per_split;
  const int c_end = min(n, c_begin + rows_per_split);

  for (int e = tid; e < TM * k; e += kThreads) {
    Lv[e] = CUDART_INF_F;
    Li[e] = INT_MAX;
  }
  __syncthreads();

  for (int c0 = c_begin; c0 < c_end; c0 += TN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < d; k0 += BK) {
      load_tile_t(As, q, q0, m, k0, d, tid);
      load_tile_t(Bs, data, c0, c_end, k0, d, tid);
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a4 = *reinterpret_cast<const float4*>(&As[kk * LD + ty * 4]);
        const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk * LD + tx * 4]);
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float b[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }

    // epilogue: the JAX kernel's arithmetic, rounded step by step (the
    // _rn intrinsics keep nvcc from contracting it into FMAs)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qi = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int cl = tx * 4 + j;
        const int ci = c0 + cl;
        float dist = CUDART_INF_F;
        if (qi < m && ci < c_end) {
          const float dot = acc[i][j];
          if (metric == 0) {
            dist = fmaxf(__fsub_rn(__fadd_rn(qn[qi], dn[ci]),
                                   __fmul_rn(2.f, dot)), 0.f);
          } else if (metric == 1) {
            dist = __fsub_rn(1.f, __fdiv_rn(dot, fmaxf(__fmul_rn(qn[qi], dn[ci]),
                                                       1e-30f)));
          } else {
            dist = -dot;
          }
          if (pen != nullptr) dist = __fadd_rn(dist, pen[ci]);
        }
        Ds[r * DS + cl] = dist;
      }
    }
    __syncthreads();

    // select: warp w keeps the lists of queries 8w .. 8w+7
    for (int rr = 0; rr < TM / 8; ++rr) {
      const int r = warp * (TM / 8) + rr;
      float* lv = Lv + r * k;
      int* li = Li + r * k;
      warp_offer(lv, li, k, Ds[r * DS + lane], c0 + lane, lane);
      warp_offer(lv, li, k, Ds[r * DS + lane + 32], c0 + lane + 32, lane);
    }
    // the next tile's GEMM steps end in __syncthreads before Ds is
    // written again, so no barrier is needed here
  }
  __syncthreads();

  const size_t stride = (size_t)splits * k;
  for (int rr = 0; rr < TM / 8; ++rr) {
    const int r = warp * (TM / 8) + rr;
    const int qi = q0 + r;
    if (qi >= m) continue;
    for (int j = lane; j < k; j += 32) {
      const float v = Lv[r * k + j];
      const size_t o = (size_t)qi * stride + (size_t)split * k + j;
      out_v[o] = v;
      out_i[o] = v < CUDART_INF_F ? Li[r * k + j] : -1;
    }
  }
}

}  // namespace

extern "C" size_t raft_fused_knn_smem(int k) {
  return sizeof(float) * (size_t)(2 * BK * LD + TM * DS) +
         (sizeof(float) + sizeof(int)) * (size_t)TM * k;
}

// metric: 0 = squared L2 (qn, dn squared norms), 1 = cosine (qn, dn
// norms), 2 = inner product (-dot; qn, dn unused). pen may be null.
extern "C" int raft_fused_knn(const void* q, const void* qn, const void* data,
                              const void* dn, const void* pen, int m, int n,
                              int d, int k, int metric, int splits,
                              int rows_per_split, void* out_v, void* out_i,
                              void* stream) {
  const size_t smem = raft_fused_knn_smem(k);
  cudaError_t err = cudaFuncSetAttribute(
      fused_knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((m + TM - 1) / TM, splits);
  if (m > 0) {
    fused_knn_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)q, (const float*)qn, (const float*)data,
        (const float*)dn, (const float*)pen, m, n, d, k, metric,
        rows_per_split, (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}
