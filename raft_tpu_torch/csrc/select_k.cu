// K1 — per-row k smallest of a (rows, n) float32 matrix.
//
// Replaces the TPU kernel raft_tpu/matrix/select_k.py::_kpass_2d (kernel
// _kpass_kernel): k passes of (row-min, invalidate) over 128-row VMEM
// blocks, ties to the lowest column, an alive mask so that +inf values are
// returned with their real column.
//
// Design on Hopper: one block per row, k passes of a block-wide arg-min.
// No alive mask is kept: pass t looks for the smallest key (value, column)
// strictly after the key pass t-1 returned, which is the same extraction
// order (ties to the lowest column, +inf values legal and returned with
// their column) with no per-element state. A row of up to 12,288 columns
// is copied once into shared memory and the passes read it there; a wider
// row is read from device memory in every pass (it stays in L2 for the
// widths the port hands over).
//
// Bound on this card: at the port's shapes (10,000 x 1,024, k = 20 in the
// coarse probe; 10,000 x 200, k = 10 in the probe merge) the least work is
// reading the input once, so the bytes bound it. The design reads it once
// from device memory and runs the k passes out of shared memory, but each
// pass costs a block-wide reduction with two barriers: this version is
// bound by those instructions, far above the byte bound (PERF.md). One
// warp per row with per-lane cached minima, or a warp-sort queue, is what
// a later version would use.
#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSmemCols = 12288;  // 48 KB of row (+ the static red_* buffers)

__global__ void __launch_bounds__(kThreads)
kpass_kernel(const float* __restrict__ x, int n, int k, int negate,
             int in_smem, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float row_smem[];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t r = blockIdx.x;
  const float* src = x + r * (size_t)n;
  const float sign = negate ? -1.f : 1.f;
  if (in_smem) {
    for (int i = tid; i < n; i += kThreads) row_smem[i] = sign * src[i];
    __syncthreads();
  }
  float pv = -CUDART_INF_F;
  int pc = -1;
  for (int t = 0; t < k; ++t) {
    float bv = CUDART_INF_F;
    int bc = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const float v = in_smem ? row_smem[i] : sign * src[i];
      if (key_less(pv, pc, v, i) && key_less(v, i, bv, bc)) {
        bv = v;
        bc = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(RAFT_FULL_MASK, bv, off);
      const int oc = __shfl_xor_sync(RAFT_FULL_MASK, bc, off);
      if (key_less(ov, oc, bv, bc)) {
        bv = ov;
        bc = oc;
      }
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bc;
    }
    __syncthreads();
    bv = red_v[0];
    bc = red_i[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      if (key_less(red_v[w], red_i[w], bv, bc)) {
        bv = red_v[w];
        bc = red_i[w];
      }
    }
    __syncthreads();  // red_* is rewritten by the next pass
    if (tid == 0) {
      out_v[r * k + t] = sign * bv;
      out_i[r * k + t] = bc == INT_MAX ? -1 : bc;  // only a NaN row
    }
    pv = bv;
    pc = bc;
  }
}

}  // namespace

extern "C" int raft_select_k(const void* values, int rows, int n, int k,
                             int select_min, void* out_v, void* out_i,
                             void* stream) {
  const int in_smem = n <= kSmemCols;
  const size_t smem = in_smem ? (size_t)n * sizeof(float) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      kpass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    kpass_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)values, n, k, select_min ? 0 : 1, in_smem,
        (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}
