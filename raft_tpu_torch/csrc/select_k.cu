// K1 — per-row k smallest of a (rows, n) float32 matrix, in two forms.
//
// Replaces the TPU kernel raft_tpu/matrix/select_k.py::_kpass_2d (kernel
// _kpass_kernel): k passes of (row-min, invalidate) over 128-row VMEM
// blocks, ties to the lowest column, an alive mask so that +inf values are
// returned with their real column.
//
// Order and empty slots (both forms). Keys compare lexicographically as
// (value, column): ties go to the lowest column, and +inf values are
// legal keys returned with their column. NaN is never selected: a NaN
// cell is before no key. A slot that no key fills (only in a row with
// fewer than k cells that are not NaN) reads (+inf, -1), after negation
// for a max selection, so (-inf, -1). A max selection negates the row as
// it is read and the values as they are written.
//
// The form is chosen by k alone (matrix/select_k.py::select_form):
//
// * warp select, k <= kWarpMaxK (256). The form of RAFT's
//   select_warpsort.cuh, written anew. One warp per row, kWarpsPerBlock
//   rows a block. The warp keeps the k best keys seen so far sorted
//   across its registers: capacity C = the next power of two >=
//   max(k, 32), C/32 keys a lane, key e in register e / 32 of lane
//   e % 32. The row is read coalesced, 32 columns a step. A column enters
//   the warp's buffer (C keys in shared memory, filled in lane order by a
//   ballot and a prefix count) only if it is strictly before the current
//   k-th key. When the buffer is full, or the row has been read, the
//   warp loads it into registers, sorts it descending with a bitonic
//   network (shuffles across lanes, register swaps within a lane), keeps
//   the elementwise smaller of queue and buffer (the C smallest of both,
//   as a bitonic sequence) and bitonic-merges that back into ascending
//   order. Work a row: one read of each cell and one compare with the
//   threshold, plus a merge for every C candidates that pass; after the
//   first merge only candidates that beat the k-th key enter.
//
// * k passes, k > kWarpMaxK. One block per row, k passes of a block-wide
//   arg-min: pass t looks for the smallest key strictly after the key
//   pass t-1 returned, which needs no per-element state. A row of up to
//   12,288 columns is copied once into shared memory and the passes read
//   it there; a wider row is read from device memory in every pass.
//
// Bound on this card: the least work is reading the input once and
// writing k (value, column) pairs a row, so the bytes bound both forms.
// The warp select reads each cell once from device memory and keeps its
// state in registers; its merges are the extra work. The k-pass form
// costs k block-wide reductions with two barriers each and grows with k:
// it stays only for k past the warp queue's 256 slots.
#include "topk_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// the warp select
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 4;
constexpr int kWarpMaxK = 256;

// (v, i) keys with (+inf, INT_MAX) as the empty key: a legal +inf cell
// (column < INT_MAX) comes before it.
__device__ __forceinline__ void set_empty(float& v, int& i) {
  v = CUDART_INF_F;
  i = INT_MAX;
}

// One compare-exchange step of a bitonic network over the warp's C = 32·R
// keys (key e in register e / 32 of lane e % 32), partners at distance j.
// Key e ends ascending against its partner when (e & s) == 0, descending
// otherwise, flipped by `desc`; s = 2C makes the whole step ascending.
template <int R>
__device__ __forceinline__ void bitonic_step(float (&v)[R], int (&c)[R],
                                             int s, int j, bool desc,
                                             int lane) {
  if (j >= 32) {
    const int jr = j >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & jr) continue;
      const int r2 = r | jr;
      const int e = r * 32 + lane;
      const bool asc = ((e & s) == 0) != desc;
      const bool swap = asc ? key_less(v[r2], c[r2], v[r], c[r])
                            : key_less(v[r], c[r], v[r2], c[r2]);
      if (swap) {
        const float tv = v[r];
        const int tc = c[r];
        v[r] = v[r2];
        c[r] = c[r2];
        v[r2] = tv;
        c[r2] = tc;
      }
    }
  } else {
    const bool lower = (lane & j) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float ov = __shfl_xor_sync(RAFT_FULL_MASK, v[r], j);
      const int oc = __shfl_xor_sync(RAFT_FULL_MASK, c[r], j);
      const int e = r * 32 + lane;
      const bool asc = ((e & s) == 0) != desc;
      // the lower key of an ascending pair keeps the smaller key
      const bool keep_min = lower == asc;
      const bool other_less = key_less(ov, oc, v[r], c[r]);
      if (keep_min == other_less) {
        v[r] = ov;
        c[r] = oc;
      }
    }
  }
}

// Sort the warp's C keys, ascending or (desc) descending.
template <int R>
__device__ __forceinline__ void bitonic_sort(float (&v)[R], int (&c)[R],
                                             bool desc, int lane) {
#pragma unroll
  for (int s = 2; s <= 32 * R; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      bitonic_step<R>(v, c, s, j, desc, lane);
    }
  }
}

// Sort a bitonic sequence of the warp's C keys ascending.
template <int R>
__device__ __forceinline__ void bitonic_merge(float (&v)[R], int (&c)[R],
                                              int lane) {
#pragma unroll
  for (int j = 16 * R; j > 0; j >>= 1) {
    bitonic_step<R>(v, c, 64 * R, j, false, lane);
  }
}

// Fold the buffer (bv, bc) into the ascending queue (qv, qc) → the C
// smallest keys of both, ascending.
template <int R>
__device__ __forceinline__ void merge_buffer(float (&qv)[R], int (&qc)[R],
                                             float (&bv)[R], int (&bc)[R],
                                             int lane) {
  bitonic_sort<R>(bv, bc, true, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (key_less(bv[r], bc[r], qv[r], qc[r])) {
      qv[r] = bv[r];
      qc[r] = bc[r];
    }
  }
  bitonic_merge<R>(qv, qc, lane);
}

// Key k−1 of the queue, on every lane.
template <int R>
__device__ __forceinline__ void kth_key(const float (&qv)[R],
                                        const int (&qc)[R], int k,
                                        float& tv, int& tc) {
  const int rk = (k - 1) >> 5;
  float v = qv[0];
  int c = qc[0];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if (r == rk) {
      v = qv[r];
      c = qc[r];
    }
  }
  tv = __shfl_sync(RAFT_FULL_MASK, v, (k - 1) & 31);
  tc = __shfl_sync(RAFT_FULL_MASK, c, (k - 1) & 31);
}

// Move the warp buffer's first nb keys into registers (the rest empty)
// and fold them into the queue.
template <int R>
__device__ __forceinline__ void fold_buffer(float (&qv)[R], int (&qc)[R],
                                            const float* buf_v,
                                            const int* buf_c, int nb,
                                            int lane) {
  float bv[R];
  int bc[R];
  __syncwarp();  // the buffer's last writes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < nb) {
      bv[r] = buf_v[e];
      bc[r] = buf_c[e];
    } else {
      set_empty(bv[r], bc[r]);
    }
  }
  __syncwarp();  // read before the buffer is written again
  merge_buffer<R>(qv, qc, bv, bc, lane);
}

template <int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
warp_select_kernel(const float* __restrict__ x, int rows, int n, int k,
                   int negate, float* __restrict__ out_v,
                   int* __restrict__ out_i) {
  constexpr int C = 32 * R;
  __shared__ float s_v[kWarpsPerBlock][C];  // each warp's buffer
  __shared__ int s_c[kWarpsPerBlock][C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= (size_t)rows) return;  // warps are independent
  const float* src = x + row * (size_t)n;
  const float sign = negate ? -1.f : 1.f;
  float* buf_v = s_v[warp];
  int* buf_c = s_c[warp];
  float qv[R];
  int qc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) set_empty(qv[r], qc[r]);
  float tv = CUDART_INF_F;  // the k-th key: (+inf, INT_MAX) while empty
  int tc = INT_MAX;
  int nb = 0;  // keys in the warp's buffer, the same on every lane
  const unsigned below = (1u << lane) - 1;
  float nxt = lane < n ? src[lane] : 0.f;
  for (int base = 0; base < n; base += 32) {
    const int col = base + lane;
    const float cur = nxt;
    if (base + 32 + lane < n) nxt = src[base + 32 + lane];
    const float v = sign * cur;
    const bool pass = col < n && key_less(v, col, tv, tc);
    const unsigned ballot = __ballot_sync(RAFT_FULL_MASK, pass);
    if (ballot == 0) continue;
    // the passing lanes append to the buffer in lane order
    const int at = nb + __popc(ballot & below);
    if (pass && at < C) {
      buf_v[at] = v;
      buf_c[at] = col;
    }
    nb += __popc(ballot);
    if (nb >= C) {
      fold_buffer<R>(qv, qc, buf_v, buf_c, C, lane);
      kth_key<R>(qv, qc, k, tv, tc);
      nb -= C;
      if (pass && at >= C) {  // what did not fit goes in after the fold
        buf_v[at - C] = v;
        buf_c[at - C] = col;
      }
    }
  }
  if (nb > 0) fold_buffer<R>(qv, qc, buf_v, buf_c, nb, lane);
  float* ov = out_v + row * (size_t)k;
  int* oi = out_i + row * (size_t)k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < k) {
      const bool empty = qc[r] == INT_MAX;
      ov[e] = sign * (empty ? CUDART_INF_F : qv[r]);
      oi[e] = empty ? -1 : qc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// the k passes
// ---------------------------------------------------------------------------

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
      out_i[r * k + t] = bc == INT_MAX ? -1 : bc;  // only NaN cells left
    }
    pv = bv;
    pc = bc;
  }
}

template <int R>
cudaError_t launch_warp_select(const float* x, int rows, int n, int k,
                               int negate, float* out_v, int* out_i,
                               cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  warp_select_kernel<R><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      x, rows, n, k, negate, out_v, out_i);
  return cudaGetLastError();
}

}  // namespace

// The warp select, 1 <= k <= 256.
extern "C" int raft_select_k_warp(const void* values, int rows, int n, int k,
                                  int select_min, void* out_v, void* out_i,
                                  void* stream) {
  if (k < 1 || k > kWarpMaxK || n < k) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const float* x = (const float*)values;
  const int neg = select_min ? 0 : 1;
  float* ov = (float*)out_v;
  int* oi = (int*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (k <= 32) {
    err = launch_warp_select<1>(x, rows, n, k, neg, ov, oi, s);
  } else if (k <= 64) {
    err = launch_warp_select<2>(x, rows, n, k, neg, ov, oi, s);
  } else if (k <= 128) {
    err = launch_warp_select<4>(x, rows, n, k, neg, ov, oi, s);
  } else {
    err = launch_warp_select<8>(x, rows, n, k, neg, ov, oi, s);
  }
  return (int)err;
}

// The k passes, any 1 <= k <= n.
extern "C" int raft_select_k_kpass(const void* values, int rows, int n, int k,
                                   int select_min, void* out_v, void* out_i,
                                   void* stream) {
  if (k < 1 || n < k) return (int)cudaErrorInvalidValue;
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
