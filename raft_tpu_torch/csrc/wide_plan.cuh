// The frame of the grouped scans' wide plans: K3 (ivf_flat_scan.cuh) past
// k = 512 and K4 (ivf_pq_scan.cu) past k = 256. Each kernel keeps its own
// tile loop and layout (prepare_wide); what the two share is here:
//   - the scratch: a 256-byte unit for the groups' counter, then 32
//     distance rows a persistent block, each the longest list rounded up
//     to the 128-row tile (ops/ivf_scan.py::wide_scratch_bytes states it);
//   - the grid: as many blocks as the card keeps resident, each taking
//     groups blockIdx.x, then the counter's, while they are live;
//   - the selection: one warp a pair over its distance row, in rounds of
//     list_select.cuh's kCap keys past k = 512.
#pragma once

#include "list_select.cuh"
#include "tf32_tile.cuh"

namespace {
namespace wide {

constexpr int kBM = 32;                  // queries a group
constexpr size_t kCounterBytes = 256;    // the groups' counter's unit

// The arguments every wide kernel takes, first in its own (which derive
// from this): the live groups, the pairs' output columns, the counter and
// the blocks' distance rows (kBM a block, stride floats apart).
struct Frame {
  int n_groups;
  float* out_v;
  int* out_i;
  int* counter;
  float* rows;
  int stride;
};

// ---- on the card ----

// The block's groups, blockIdx.x and then the counter's, until a group of
// no pairs (past the live groups, which come first): scan(gi, cnt) is the
// whole block's work on group gi of cnt pairs.
template <class Scan>
__device__ __forceinline__ void for_each_group(const Frame& f,
                                               const int* gcount,
                                               Scan&& scan) {
  __shared__ int next;
  int gi = blockIdx.x;
  while (gi < f.n_groups) {
    const int cnt = gcount[gi];
    if (cnt <= 0) break;
    scan(gi, cnt);
    if (threadIdx.x == 0) next = atomicAdd(f.counter, 1) + gridDim.x;
    __syncthreads();
    gi = next;
  }
}

// The block's distance row r.
__device__ __forceinline__ float* block_row(const Frame& f, int r) {
  return f.rows + ((size_t)blockIdx.x * kBM + r) * f.stride;
}

// One warp: the k best of a pair's n distances in `row` (rows c_begin ..
// of its list) into its output columns from o, in rounds (any k), with
// ws the warp's lsel::kWarpBytes of shared memory.
__device__ __forceinline__ void select_pair(const Frame& f, const float* row,
                                            int n, int k, size_t o,
                                            int c_begin, unsigned char* ws,
                                            int lane) {
  float* ov = f.out_v + o;
  int* oi = f.out_i + o;
  lsel::select_rounds(
      lsel::RowKeys{row}, n, k, ws,
      [&](int e, lsel::Key64 key) {
        const unsigned pos = (unsigned)key;
        ov[e] = row[pos];
        oi[e] = c_begin + (int)pos;
      },
      [&](int e) {
        ov[e] = CUDART_INF_F;
        oi[e] = -1;
      },
      lane);
}

// ---- on the host ----

inline int row_stride(int lmax) { return (lmax + BN - 1) / BN * BN; }

// Bytes of the scratch for `blocks` persistent blocks over lists of at
// most lmax rows.
inline size_t scratch_bytes(int blocks, int lmax) {
  return kCounterBytes + sizeof(float) * (size_t)blocks * kBM *
                             row_stride(lmax > 0 ? lmax : 1);
}

// The persistent grid of kern at smem bytes a block on the current card:
// blocks an SM and in all.
inline cudaError_t grid(const void* kern, size_t smem, int* per_sm,
                        int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = *per_sm * sms;
  return cudaSuccess;
}

// The scratch of kern's plan over lists of at most lmax rows: out[0] =
// its bytes, out[1] = the persistent blocks, out[2] = the blocks an SM.
inline cudaError_t scratch_info(const void* kern, size_t smem, int lmax,
                                long long* out) {
  int per_sm = 0, blocks = 0;
  const cudaError_t err = grid(kern, smem, &per_sm, &blocks);
  if (err != cudaSuccess) return err;
  out[0] = (long long)scratch_bytes(blocks, lmax);
  out[1] = blocks;
  out[2] = per_sm;
  return cudaSuccess;
}

// The frame over a scratch of scratch_bytes(., lmax) bytes.
inline Frame frame(int n_groups, void* out_v, void* out_i, void* scratch,
                   int lmax) {
  return Frame{n_groups,      (float*)out_v,
               (int*)out_i,   (int*)scratch,
               (float*)((char*)scratch + kCounterBytes), row_stride(lmax)};
}

// Zero the counter and launch the persistent blocks (no more than the
// groups) of kern with its arguments a, whose frame is a's base.
template <class Args>
inline cudaError_t launch(const void* kern, size_t smem, const Args& a,
                          cudaStream_t s) {
  if (a.n_groups == 0) return cudaSuccess;
  int per_sm = 0, blocks = 0;
  cudaError_t err = grid(kern, smem, &per_sm, &blocks);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(a.counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&a};
  err = cudaLaunchKernel(kern,
                         dim3(a.n_groups < blocks ? a.n_groups : blocks),
                         dim3(kThreads), args, smem, s);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace wide
}  // namespace
