// K3 — IVF-Flat list scan: per (query, probe) pair, the k nearest rows of
// the probed list.
//
// Replaces the TPU kernel raft_tpu/ops/ivf_scan.py::_scan_groups (kernel
// _kernel -> _kernel_body): (query, probe) pairs packed 128 to a group per
// list so that each grid step scores a dense (group x list) block on the
// MXU; per-pair top-k of row ids; dead groups skipped; filter as an
// additive penalty row.
//
// Design on Hopper. The 128-query grouping exists to feed the MXU, and is
// dropped: one block of 128 threads owns one (query, probe) pair, the role
// of ivf_flat_interleaved_scan-inl.cuh:1085 in the CUDA reference. The
// query sits in shared memory; the list's rows (a contiguous range of the
// cluster-sorted data) stream through shared memory 128 rows x 32
// dimensions at a time with coalesced loads, each thread accumulating the
// dot of one row. Distances (l2 from the norms, cosine, or -dot) plus the
// penalty go to shared memory and warp 0 keeps the pair's sorted k-best
// list (warp_insert). Ties go to the smaller row id, as in the Pallas
// kernel. Pairs are launched in list order (the wrapper passes the sorted
// pair order), so blocks that run together read the same list and the
// second and later reads of a list come from L2. Each pair writes its k
// best to its own k columns of a (m, p*k) buffer in probe-rank order, and
// the wrapper merges each query's row with K1, exactly as merge_pairs
// orders the pairs.
//
// Bound on this card: the work is 2·d FP32 operations per (pair, row),
// about 100 GFLOP at m = 10,000, p = 20 over 1,024 lists of 1M rows (the
// lists are uneven, so probed lists run longer than average), 1.5 ms at
// 67 TFLOP/s; the bytes of the probed lists, each read once, take less.
// Each pair reading its whole list is what this first version pays above
// that bound: every row loaded is used for one dot product, so the kernel
// runs at the rate of L2 and device memory, and the L2 cache holds 50 MB
// of the 512 MB corpus. Grouping the pairs of a list inside one block (as
// the TPU kernel does), so that a loaded row serves many queries, is the
// next step.
#include "topk_common.cuh"

namespace {

constexpr int kRows = 128;     // rows per shared-memory tile = threads
constexpr int BKD = 32;        // dimensions per step
constexpr int RS = BKD + 1;    // padded tile row stride

__global__ void __launch_bounds__(kRows)
ivf_scan_kernel(const float* __restrict__ data, const float* __restrict__ dn,
                const float* __restrict__ pen, const float* __restrict__ q,
                const float* __restrict__ qn, const int* __restrict__ probed,
                const int* __restrict__ order,
                const int* __restrict__ offsets,
                const int* __restrict__ sizes, int p, int d, int d_pad, int k,
                int metric, float* __restrict__ out_v,
                int* __restrict__ out_i) {
  extern __shared__ float smem[];
  float* qs = smem;                     // d_pad
  float* tile = qs + d_pad;             // kRows x RS
  float* cand = tile + kRows * RS;      // kRows
  float* lv = cand + kRows;             // k
  int* li = (int*)(lv + k);             // k

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int pair = order[blockIdx.x];
  const int qi = pair / p;
  const int rank = pair % p;
  const int list = probed[pair];
  const int off = offsets[list];
  const int size = sizes[list];

  for (int c = tid; c < d_pad; c += kRows) {
    qs[c] = c < d ? q[(size_t)qi * d + c] : 0.f;
  }
  for (int j = tid; j < k; j += kRows) {
    lv[j] = CUDART_INF_F;
    li[j] = INT_MAX;
  }
  const float qnorm = qn != nullptr ? qn[qi] : 0.f;  // null for "ip"
  __syncthreads();

  for (int r0 = 0; r0 < size; r0 += kRows) {
    float acc = 0.f;
    for (int k0 = 0; k0 < d; k0 += BKD) {
      for (int e = tid; e < kRows * BKD; e += kRows) {
        const int r = e / BKD, c = e % BKD;
        const int row = r0 + r, kk = k0 + c;
        tile[r * RS + c] = (row < size && kk < d)
                               ? data[(size_t)(off + row) * d + kk]
                               : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < BKD; ++c) {
        acc = fmaf(qs[k0 + c], tile[tid * RS + c], acc);
      }
      __syncthreads();
    }
    const int row = r0 + tid;
    float dist = CUDART_INF_F;
    if (row < size) {
      const int g = off + row;
      if (metric == 0) {
        dist = fmaxf(__fsub_rn(__fadd_rn(qnorm, dn[g]), __fmul_rn(2.f, acc)),
                     0.f);
      } else if (metric == 1) {
        dist = __fsub_rn(1.f, __fdiv_rn(acc, fmaxf(__fmul_rn(qnorm, dn[g]),
                                                   1e-30f)));
      } else {
        dist = -acc;
      }
      if (pen != nullptr) dist = __fadd_rn(dist, pen[g]);
    }
    cand[tid] = dist;
    __syncthreads();
    if (tid < 32) {
      for (int h = 0; h < kRows; h += 32) {
        warp_offer(lv, li, k, cand[h + lane], off + r0 + h + lane, lane);
      }
    }
    __syncthreads();
  }

  const size_t o = (size_t)qi * p * k + (size_t)rank * k;
  for (int j = tid; j < k; j += kRows) {
    const float v = lv[j];
    out_v[o + j] = v;
    out_i[o + j] = v < CUDART_INF_F ? li[j] : -1;
  }
}

}  // namespace

// metric: 0 = squared L2 (qn, dn squared norms), 1 = cosine (qn, dn
// norms), 2 = inner product (-dot). pen may be null. probed is (m, p),
// order a permutation of the m*p pairs (the launch order).
extern "C" int raft_ivf_flat_scan(const void* data, const void* dn,
                                  const void* pen, const void* q,
                                  const void* qn, const void* probed,
                                  const void* order, const void* offsets,
                                  const void* sizes, int m, int p, int d,
                                  int k, int metric, void* out_v, void* out_i,
                                  void* stream) {
  const int d_pad = (d + BKD - 1) / BKD * BKD;
  const size_t smem = sizeof(float) * (size_t)(d_pad + kRows * RS + kRows) +
                      (sizeof(float) + sizeof(int)) * (size_t)k;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)m * p;
  if (pairs > 0) {
    ivf_scan_kernel<<<(unsigned)pairs, kRows, smem, (cudaStream_t)stream>>>(
        (const float*)data, (const float*)dn, (const float*)pen,
        (const float*)q, (const float*)qn, (const int*)probed,
        (const int*)order, (const int*)offsets, (const int*)sizes, p, d,
        d_pad, k, metric, (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}
