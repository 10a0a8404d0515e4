// K4 — IVF-PQ list scan: per (query, probe) pair, the k nearest PQ-coded
// rows of the probed list.
//
// Replaces the TPU kernel raft_tpu/ops/ivf_pq_scan.py::_scan_groups
// (kernel _kernel -> _kernel_body): (query, probe) pairs packed 128 to a
// group per list; the group's PQ distances in expanded form,
//   l2: max(||q||² + ||c_l + dec_i||² - 2·q·c_l - 2·Σ_s q_s·cb[s, code_is], 0)
//   ip: -q·c_l - Σ_s q_s·cb[s, code_is],
// with the codes decoded by a one-hot GEMM against a block-diagonal
// codebook matrix on the MXU (f32, bf16 or int8 codebook); the additive
// penalty row; rows outside the list masked; a per-pair top-k with ties
// to the lower row.
//
// Design on Hopper. The one-hot decode GEMM and the 128-pair groups exist
// to feed the MXU, and are dropped. One block of 256 threads owns one
// (query, probe) pair, the role of ivf_pq_compute_similarity-inl.cuh:271
// in the CUDA reference: the block builds the lookup table
// lut[s][b] = Σ_l q[s·pq_len + l]·cb[s][b][l] in shared memory in float32
// (the codebook arrives already rounded to the LUT mode), computes q·c_l
// and ||q||² once, then streams the list's code rows: each thread reads
// one row's pq_dim bytes (16-byte loads when pq_dim is a multiple of 16)
// and sums its pq_dim LUT entries in subspace order. The epilogue follows
// _kernel_body's order with __fadd_rn/__fmul_rn, so nvcc cannot contract
// it into FMAs: max(((||q||² + dn) - 2·qc) + (-2·Σ), 0) + pen. Warp 0
// keeps the pair's sorted k-best list (warp_offer; ties to the smaller
// row). Pairs are launched in list order (the wrapper passes the sorted
// pair order), so blocks that run together read the same list's codes
// from L2. Each pair writes its k best to its own k columns of a
// (m, p*k) buffer in probe-rank order, and the wrapper merges each
// query's row with K1, exactly as merge_pairs orders the pairs. An empty
// (or filter-pruned) list writes (+inf, -1) and builds no LUT.
//
// Bound on this card: the LUT once per query (2·pq_len FLOPs per entry,
// 0.66 G at m = 10,000, pq_dim = 64, book = 256, ~0.01 ms at 67 TFLOP/s
// FP32) and one add per (pair, row, subspace) (~24 G over p = 20 probes
// of 1,024 lists of 1M rows, ~0.72 ms at 33.5 T adds/s: a lone add is
// half an FMA's two FLOPs); the distinct code bytes (~68 MB) take less.
// What this first version pays above that bound: every LUT read is a shared-
// memory load at a data-dependent address (random codes put several
// lanes of a warp on one bank), every pair rebuilds its 64 KB LUT from a
// 128 KB codebook read from L2, and every pair re-reads its list's codes.
// In the expanded form the LUT depends on the query alone, so the next
// step is one LUT per query shared by its pairs (a block per query, or
// per list with its queries' LUTs side by side), laid out against bank
// conflicts (e.g. subspace-interleaved copies), with the codes of a list
// read once for all the pairs that probe it.
#include <cstdint>

#include "topk_common.cuh"

namespace {

constexpr int kThreads = 256;  // rows per tile = threads of a block

__global__ void __launch_bounds__(kThreads)
ivf_pq_scan_kernel(const uint8_t* __restrict__ codes,
                   const float* __restrict__ dn,
                   const float* __restrict__ pen,
                   const float* __restrict__ cb,
                   const float* __restrict__ centers,
                   const float* __restrict__ q,
                   const int* __restrict__ probed,
                   const int* __restrict__ order,
                   const int* __restrict__ offsets,
                   const int* __restrict__ sizes, int p, int pq_dim,
                   int pq_len, int book, int k, int metric, int vec16,
                   float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ float smem[];
  __shared__ float red[2];
  const int rot_dim = pq_dim * pq_len;
  const int entries = pq_dim * book;
  float* lut = smem;                    // pq_dim x book
  float* qs = lut + entries;            // rot_dim
  float* cand = qs + rot_dim;           // kThreads
  float* lv = cand + kThreads;          // k
  int* li = (int*)(lv + k);             // k

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int pair = order[blockIdx.x];
  const int qi = pair / p;
  const int rank = pair % p;
  const int list = probed[pair];
  const int off = offsets[list];
  const int size = sizes[list];
  const size_t o = (size_t)qi * p * k + (size_t)rank * k;

  if (size <= 0) {  // block-uniform: no barrier is skipped by part of it
    for (int j = tid; j < k; j += kThreads) {
      out_v[o + j] = CUDART_INF_F;
      out_i[o + j] = -1;
    }
    return;
  }

  for (int c = tid; c < rot_dim; c += kThreads) {
    qs[c] = q[(size_t)qi * rot_dim + c];
  }
  for (int j = tid; j < k; j += kThreads) {
    lv[j] = CUDART_INF_F;
    li[j] = INT_MAX;
  }
  __syncthreads();

  for (int e = tid; e < entries; e += kThreads) {
    const float* ce = cb + (size_t)e * pq_len;
    const float* qe = qs + (e / book) * pq_len;
    float v = 0.f;
    for (int l = 0; l < pq_len; ++l) {
      v = __fadd_rn(v, __fmul_rn(qe[l], ce[l]));
    }
    lut[e] = v;
  }
  if (warp < 2) {  // warp 0: q·c_l, warp 1: ||q||²
    const float* cl = centers + (size_t)list * rot_dim;
    float acc = 0.f;
    for (int c = lane; c < rot_dim; c += 32) {
      const float a = qs[c];
      acc = fmaf(a, warp == 0 ? cl[c] : a, acc);
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      acc += __shfl_xor_sync(RAFT_FULL_MASK, acc, s);
    }
    if (lane == 0) red[warp] = acc;
  }
  __syncthreads();
  const float qc = red[0];
  const float qn = red[1];

  for (int r0 = 0; r0 < size; r0 += kThreads) {
    const int row = r0 + tid;
    float dist = CUDART_INF_F;
    if (row < size) {
      const size_t g = (size_t)off + row;
      const uint8_t* cr = codes + g * pq_dim;
      float acc = 0.f;
      if (vec16) {
        const uint4* c4 = reinterpret_cast<const uint4*>(cr);
        for (int w = 0; w < pq_dim / 16; ++w) {
          const uint4 u = __ldg(c4 + w);
          const unsigned words[4] = {u.x, u.y, u.z, u.w};
          const float* lw = lut + w * 16 * book;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const unsigned code = (words[j >> 2] >> ((j & 3) * 8)) & 0xffu;
            acc = __fadd_rn(acc, lw[j * book + code]);
          }
        }
      } else {
        for (int s = 0; s < pq_dim; ++s) {
          acc = __fadd_rn(acc, lut[s * book + cr[s]]);
        }
      }
      if (metric == 0) {
        dist = fmaxf(__fadd_rn(__fsub_rn(__fadd_rn(qn, dn[g]),
                                         __fmul_rn(2.f, qc)),
                               __fmul_rn(-2.f, acc)),
                     0.f);
      } else {
        dist = __fadd_rn(-qc, __fmul_rn(-1.f, acc));
      }
      if (pen != nullptr) dist = __fadd_rn(dist, pen[g]);
    }
    cand[tid] = dist;
    __syncthreads();
    if (warp == 0) {
      for (int h = 0; h < kThreads; h += 32) {
        warp_offer(lv, li, k, cand[h + lane], off + r0 + h + lane, lane);
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < k; j += kThreads) {
    const float v = lv[j];
    out_v[o + j] = v;
    out_i[o + j] = v < CUDART_INF_F ? li[j] : -1;
  }
}

}  // namespace

// codes: (rows, pq_dim) uint8; dn: (rows,) decoded squared row norms
// (may be null for ip); pen: (rows,) additive penalty or null; cb:
// (pq_dim, book, pq_len) float32 codebook of the LUT mode; centers:
// (n_lists, pq_dim*pq_len) rotated centers; q: (m, pq_dim*pq_len)
// rotated queries; probed: (m, p); order: a permutation of the m*p pairs
// (the launch order). metric: 0 = squared L2, 1 = inner product (-dot).
extern "C" int raft_ivf_pq_scan(const void* codes, const void* dn,
                                const void* pen, const void* cb,
                                const void* centers, const void* q,
                                const void* probed, const void* order,
                                const void* offsets, const void* sizes,
                                int m, int p, int pq_dim, int pq_len,
                                int book, int k, int metric, void* out_v,
                                void* out_i, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)pq_dim * book + (size_t)pq_dim * pq_len +
                       kThreads) +
      (sizeof(float) + sizeof(int)) * (size_t)k;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_pq_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec16 =
      pq_dim % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const long long pairs = (long long)m * p;
  if (pairs > 0) {
    ivf_pq_scan_kernel<<<(unsigned)pairs, kThreads, smem,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const float*)dn, (const float*)pen,
        (const float*)cb, (const float*)centers, (const float*)q,
        (const int*)probed, (const int*)order, (const int*)offsets,
        (const int*)sizes, p, pq_dim, pq_len, book, k, metric, vec16,
        (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}
