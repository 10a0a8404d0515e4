// K1 — per-row k smallest of a (rows, n) float32 matrix, in two forms.
//
// Replaces the TPU kernel raft_tpu/matrix/select_k.py::_kpass_2d (kernel
// _kpass_kernel): k passes of (row-min, invalidate) over 128-row VMEM
// blocks, ties to the lowest column, an alive mask so that +inf values are
// returned with their real column.
//
// Order (both forms): the order of the JAX package's select_k (lax.top_k),
// stated in matrix/select_k.py. A cell's key is the int place of its
// float in IEEE 754 totalOrder (-NaN < -inf < ... < -0.0 < +0.0 < ... <
// +inf < +NaN), bitwise-inverted for a max selection; keys compare as
// (key, column), so ties go to the lowest column in both directions, and
// every cell, NaN and ±inf included, is a legal key returned with its
// column. The value written back is the key mapped back to its float,
// bit for bit. The empty key (INT_MAX, INT_MAX) comes after every legal
// key; since k <= n it is never written, and a slot it would fill reads
// (±inf, -1).
//
// The form is chosen by k alone (matrix/select_k.py::select_form):
//
// * warp select, k <= kWarpMaxK (512). The form of RAFT's
//   select_warpsort.cuh, written anew. One warp per row, kWarpsPerBlock
//   rows a block. The warp keeps the k best keys seen so far sorted
//   across its registers (the queue of warp_queue.cuh): capacity C = the
//   next power of two >= max(k, 32), C/32 keys a lane, key e in register
//   e / 32 of lane e % 32. The row is read coalesced, 32 columns a step,
//   or 128 (16 bytes a lane) where the row's width and address allow it
//   (the wrapper's vec flag; both loops feed the same selection, and
//   keys compare as (key, column), so the arrival order does not change
//   the result). A column enters the warp's buffer (CAP keys in shared
//   memory, filled in lane order by a ballot and a prefix count) only if
//   it is strictly before the current k-th key. When the buffer is full,
//   or the row has been read, the warp loads it into CAP / 32 registers,
//   sorts it descending with a bitonic network (shuffles across lanes,
//   register swaps within a lane), keeps the elementwise smaller of it
//   and the queue's last CAP keys (the C smallest of both, as a bitonic
//   sequence) and bitonic-merges the queue back into ascending order.
//   CAP = C up to k = 256; past 256 the queue has 512 keys and the
//   buffer 128 (warp_queue.cuh::fold_buffer's RB = 4): a fold is then a
//   128-key sort and one 512-key merge, ~3.5x fewer compare-exchanges
//   than a 512-key buffer, and the buffer takes 1 KB a warp. Work a row:
//   one read of each cell and one compare with the threshold, plus a
//   fold for every CAP candidates that pass; after the first folds only
//   candidates that beat the k-th key enter. (CAGRA's IVF-PQ graph pass
//   merges rows of 64 sorted runs of 257 at k = 257: a run's passing
//   keys come at its head, ~257·H(64) ≈ 1,200 a row, ~10 folds.)
//
// * k passes, k > kWarpMaxK. One block per row, k passes of a block-wide
//   arg-min: pass t looks for the smallest key strictly after the key
//   pass t-1 returned, which needs no per-element state. A row that fits
//   the card's opt-in shared memory (227 KB on sm_90: ~58,000 columns) is
//   copied there once and the passes read it there; a wider row is read
//   from device memory in every pass.
//
// Bound on this card: the least work is reading the input once and
// writing k (value, column) pairs a row, so the bytes bound both forms.
// The warp select reads each cell once from device memory and keeps its
// state in registers; its folds are the extra work. The k-pass form
// costs k block-wide reductions with two barriers each and grows with k:
// it stays only for k past the warp queue's 512 slots.
#include <cstdint>

#include "warp_queue.cuh"

namespace {

// ---------------------------------------------------------------------------
// the warp select
// ---------------------------------------------------------------------------

constexpr int kWarpsPerBlock = 4;
constexpr int kWarpMaxK = 512;

// The cell's key: its place in totalOrder as an int, inverted for a max
// selection (~ reverses the int order exactly, with no overflow).
__device__ __forceinline__ int select_key(float x, int negate) {
  const int b = __float_as_int(x);
  const int t = b ^ ((b >> 31) & 0x7fffffff);
  return negate ? ~t : t;
}

// The float whose key is `key` (select_key's inverse).
__device__ __forceinline__ float key_value(int key, int negate) {
  const int t = negate ? ~key : key;
  return __int_as_float(t ^ ((t >> 31) & 0x7fffffff));
}

// The warp's state: the queue (qv, qc), the k-th key (tv, tc) and the
// buffer's fill nb, the same on every lane.
template <int R, int CAP>
struct WarpSelect {
  int qv[R];
  int qc[R];
  int tv = INT_MAX;  // the k-th key: (INT_MAX, INT_MAX) while empty
  int tc = INT_MAX;
  int nb = 0;

  // Offer each lane's cell x at column col (ok: the lane has a cell).
  __device__ __forceinline__ void offer(float x, int col, bool ok,
                                       int negate, int* buf_v, int* buf_c,
                                       int k, int lane, unsigned below) {
    const int v = select_key(x, negate);
    const bool pass = ok && key_less(v, col, tv, tc);
    const unsigned ballot = __ballot_sync(RAFT_FULL_MASK, pass);
    if (ballot == 0) return;
    // the passing lanes append to the buffer in lane order
    const int at = nb + __popc(ballot & below);
    if (pass && at < CAP) {
      buf_v[at] = v;
      buf_c[at] = col;
    }
    nb += __popc(ballot);
    if (nb >= CAP) {
      warpq::fold_buffer<int, R, CAP / 32>(qv, qc, buf_v, buf_c, CAP, lane);
      warpq::kth_key<int, R>(qv, qc, k, tv, tc);
      nb -= CAP;
      if (pass && at >= CAP) {  // what did not fit goes in after the fold
        buf_v[at - CAP] = v;
        buf_c[at - CAP] = col;
      }
    }
  }
};

// VEC: the row is read 16 bytes a lane (n % 4 == 0, x 16-byte aligned),
// two steps of 128 columns in flight; else 4 bytes a lane, 32 columns a
// step, one step ahead.
template <int R, int CAP, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
warp_select_kernel(const float* __restrict__ x, int rows, int n, int k,
                   int negate, float* __restrict__ out_v,
                   int* __restrict__ out_i) {
  static_assert(CAP % 32 == 0 && CAP <= 32 * R, "a buffer of 1 to R "
                "registers");
  __shared__ int s_v[kWarpsPerBlock][CAP];  // each warp's buffer
  __shared__ int s_c[kWarpsPerBlock][CAP];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t row = (size_t)blockIdx.x * kWarpsPerBlock + warp;
  if (row >= (size_t)rows) return;  // warps are independent
  const float* src = x + row * (size_t)n;
  int* buf_v = s_v[warp];
  int* buf_c = s_c[warp];
  WarpSelect<R, CAP> ws;
#pragma unroll
  for (int r = 0; r < R; ++r) warpq::set_empty(ws.qv[r], ws.qc[r]);
  const unsigned below = (1u << lane) - 1;
  if (VEC) {
    const float4* src4 = (const float4*)src;
    const int n4 = n >> 2;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    float4 nx0 = lane < n4 ? src4[lane] : zero;
    float4 nx1 = 32 + lane < n4 ? src4[32 + lane] : zero;
    for (int b4 = 0; b4 < n4; b4 += 32) {
      const float4 cur = nx0;
      nx0 = nx1;
      if (b4 + 64 + lane < n4) nx1 = src4[b4 + 64 + lane];
      const bool ok = b4 + lane < n4;
      const int col = 4 * (b4 + lane);
      // one offer's code for the four columns: unrolled, its fold four
      // times over spills the queue at R = 8
#pragma unroll 1
      for (int e = 0; e < 4; ++e) {
        const float v = e == 0 ? cur.x : e == 1 ? cur.y : e == 2 ? cur.z
                                                                 : cur.w;
        ws.offer(v, col + e, ok, negate, buf_v, buf_c, k, lane, below);
      }
    }
  } else {
    float nxt = lane < n ? src[lane] : 0.f;
    for (int base = 0; base < n; base += 32) {
      const int col = base + lane;
      const float cur = nxt;
      if (base + 32 + lane < n) nxt = src[base + 32 + lane];
      ws.offer(cur, col, col < n, negate, buf_v, buf_c, k, lane, below);
    }
  }
  if (ws.nb > 0) {
    warpq::fold_buffer<int, R, CAP / 32>(ws.qv, ws.qc, buf_v, buf_c, ws.nb,
                                         lane);
  }
  float* ov = out_v + row * (size_t)k;
  int* oi = out_i + row * (size_t)k;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    if (e < k) {
      const bool empty = ws.qc[r] == INT_MAX;
      ov[e] = empty ? (negate ? -CUDART_INF_F : CUDART_INF_F)
                    : key_value(ws.qv[r], negate);
      oi[e] = empty ? -1 : ws.qc[r];
    }
  }
}

// ---------------------------------------------------------------------------
// the k passes
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
kpass_kernel(const float* __restrict__ x, int n, int k, int negate,
             int in_smem, float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ int row_smem[];
  __shared__ int red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t r = blockIdx.x;
  const float* src = x + r * (size_t)n;
  if (in_smem) {
    for (int i = tid; i < n; i += kThreads) {
      row_smem[i] = select_key(src[i], negate);
    }
    __syncthreads();
  }
  int pv = INT_MIN;  // before every key: (INT_MIN, -1)
  int pc = -1;
  for (int t = 0; t < k; ++t) {
    int bv = INT_MAX;
    int bc = INT_MAX;
    for (int i = tid; i < n; i += kThreads) {
      const int v = in_smem ? row_smem[i] : select_key(src[i], negate);
      if (key_less(pv, pc, v, i) && key_less(v, i, bv, bc)) {
        bv = v;
        bc = i;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int ov = __shfl_xor_sync(RAFT_FULL_MASK, bv, off);
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
      const bool empty = bc == INT_MAX;  // not reached: k <= n
      out_v[r * k + t] = empty ? (negate ? -CUDART_INF_F : CUDART_INF_F)
                               : key_value(bv, negate);
      out_i[r * k + t] = empty ? -1 : bc;
    }
    pv = bv;
    pc = bc;
  }
}

template <int R, int CAP>
cudaError_t launch_warp_select(const float* x, int rows, int n, int k,
                               int negate, bool vec, float* out_v,
                               int* out_i, cudaStream_t stream) {
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (vec) {
    warp_select_kernel<R, CAP, true><<<blocks, kWarpsPerBlock * 32, 0,
                                       stream>>>(x, rows, n, k, negate,
                                                 out_v, out_i);
  } else {
    warp_select_kernel<R, CAP, false><<<blocks, kWarpsPerBlock * 32, 0,
                                        stream>>>(x, rows, n, k, negate,
                                                  out_v, out_i);
  }
  return cudaGetLastError();
}

}  // namespace

// The warp select, 1 <= k <= 512.
extern "C" int raft_select_k_warp(const void* values, int rows, int n, int k,
                                  int select_min, void* out_v, void* out_i,
                                  void* stream) {
  if (k < 1 || k > kWarpMaxK || n < k) return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  const float* x = (const float*)values;
  const int neg = select_min ? 0 : 1;
  // 16-byte reads: every row starts 16-byte aligned
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0;
  float* ov = (float*)out_v;
  int* oi = (int*)out_i;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (k <= 32) {
    err = launch_warp_select<1, 32>(x, rows, n, k, neg, vec, ov, oi, s);
  } else if (k <= 64) {
    err = launch_warp_select<2, 64>(x, rows, n, k, neg, vec, ov, oi, s);
  } else if (k <= 128) {
    err = launch_warp_select<4, 128>(x, rows, n, k, neg, vec, ov, oi, s);
  } else if (k <= 256) {
    err = launch_warp_select<8, 256>(x, rows, n, k, neg, vec, ov, oi, s);
  } else {
    err = launch_warp_select<16, 128>(x, rows, n, k, neg, vec, ov, oi, s);
  }
  return (int)err;
}

// The k passes, any 1 <= k <= n. The row stays in shared memory when it
// fits the card's opt-in limit beside the kernel's static red_*.
extern "C" int raft_select_k_kpass(const void* values, int rows, int n, int k,
                                   int select_min, void* out_v, void* out_i,
                                   void* stream) {
  if (k < 1 || n < k) return (int)cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  cudaFuncAttributes fa;
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&fa, kpass_kernel);
  if (err != cudaSuccess) return (int)err;
  const size_t room = (size_t)optin - fa.sharedSizeBytes;
  const int in_smem = (size_t)n * sizeof(int) <= room;
  const size_t smem = in_smem ? (size_t)n * sizeof(int) : 0;
  err = cudaFuncSetAttribute(
      kpass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (rows > 0) {
    kpass_kernel<<<rows, kThreads, smem, (cudaStream_t)stream>>>(
        (const float*)values, n, k, select_min ? 0 : 1, in_smem,
        (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}
