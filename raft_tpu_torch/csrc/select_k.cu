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
// * radix select, k > kWarpMaxK (any k <= n by name). The form of RAFT's
//   select_radix.cuh, written anew. One block per row (the merges hand
//   it 8,192 to 17,408 rows: many waves over the 132 SMs), two blocks an
//   SM. Keys are the cells' order keys as unsigned (select_key, sign bit
//   flipped). A round looks for the c-th key (c <= kRadixCap = 2048)
//   after the last (key, column) written: a histogram in shared memory
//   of the keys' next digit (11, 11, then 10 bits) among those that
//   share the prefix found so far, a block-wide scan over its bins for
//   the bucket of the c-th key, until the bucket is one key or it and the
//   keys below it make c. A row that fits beside the sort buffer and the
//   histogram is read once from device memory and its keys staged in
//   shared memory for the later passes; a wider one is read again until
//   the keys at or below the bucket fit there, then gathered in column
//   order and the later passes read them. Then a block-wide ordered
//   compaction (a scan a tile, so the lowest columns win ties) takes the
//   keys below the prefix and the bucket's first keys; at the last bit
//   they are ties of the c-th key, written out at once in column order,
//   and only the keys below them are sorted. The sort is a bitonic
//   network over (key, column) as 64-bit keys: its stages up to 32 x 4
//   keys in a warp's registers (shuffles), only partners further apart
//   through shared memory. Past kRadixCap the rounds repeat. A thread
//   reads 8 consecutive columns a tile (two 16-byte loads in flight), and
//   the first round, which every key is after, tests no floor. Work a row:
//   one read of the row (two or three where it is wider than shared
//   memory), a few passes over shared memory and a sort of ~k keys,
//   where the k passes it replaces (the first form) made k block-wide
//   arg-min passes over the whole row.
//
// Bound on this card: the least work is reading the input once and
// writing k (value, column) pairs a row, so the bytes bound both forms.
// The warp select reads each cell once from device memory and keeps its
// state in registers; its folds are the extra work. The radix select's
// digit passes are the extra work: each reads every key of its source and
// counts the keys of the bucket with one shared-memory atomic a key, so a
// pass over a row from L2 costs about what the first read from device
// memory does.
#include <cstdint>
#include <mutex>

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
// the radix select
// ---------------------------------------------------------------------------

constexpr int kRadixThreads = 512;
constexpr int kRadixBlocks = 2;     // blocks resident a SM
constexpr int kRadixWarps = kRadixThreads / 32;
constexpr int kRadixBits = 11;  // digits of 11, 11 and 10 bits
constexpr int kRadixBins = 1 << kRadixBits;
constexpr int kRadixCap = 2048;                // keys a round sorts
constexpr int kChunk = 8;  // consecutive columns a thread a tile
constexpr unsigned kChunkFull = (1u << kChunk) - 1u;
constexpr int kTile = kRadixThreads * kChunk;
constexpr int kBinsPerThread =
    (kRadixBins + kRadixThreads - 1) / kRadixThreads;
// the sort: kSortE keys a thread, so a warp holds kSortLocal consecutive
// keys, and the block a whole round's
constexpr int kSortE = kRadixCap / kRadixThreads;
constexpr int kSortLocal = 32 * kSortE;
static_assert(kRadixWarps <= 32, "one warp scans the warps' sums");
static_assert(kTile <= 0xffff, "a tile's counts fit 16 bits");
static_assert(kChunk % 4 == 0 && kChunk <= 16, "16-byte loads, a mask");
static_assert(kSortE >= 1 && kSortE * kRadixThreads == kRadixCap,
              "the block holds a round's keys");

typedef unsigned long long RadixKey;  // (key, column), the sort's order

// The selection order as unsigned: select_key with its sign bit flipped.
__device__ __forceinline__ unsigned radix_key(float x, int negate) {
  return (unsigned)select_key(x, negate) ^ 0x80000000u;
}
__device__ __forceinline__ float radix_value(unsigned u, int negate) {
  return key_value((int)(u ^ 0x80000000u), negate);
}

// Where a pass reads the row's keys: the row in device memory, its keys
// staged in shared memory (column i at i), or the keys gathered there
// with their columns, in column order.
enum : int { kFromRow = 0, kFromStage = 1, kFromGather = 2 };

struct RadixSource {
  const float* x;        // the row
  const unsigned* keys;  // staged or gathered keys
  const int* cols;       // gathered columns
  int n;                 // the row's columns
  int count;             // gathered keys
  int kind;
  int negate;
  bool vec;              // the row may be read 16 bytes a thread
};

// A thread's kChunk consecutive keys of a tile (its 16-byte loads in
// flight together), their columns, and which of them exist (bit j).
struct Chunk {
  unsigned u[kChunk];
  int c[kChunk];
  unsigned ok;
};

__device__ __forceinline__ Chunk load_chunk(const RadixSource& s, int i0) {
  Chunk q;
  q.ok = 0u;
  if (s.kind == kFromRow) {
    if (s.vec && i0 + kChunk <= s.n) {
#pragma unroll
      for (int h = 0; h < kChunk; h += 4) {
        const float4 v =
            __ldg(reinterpret_cast<const float4*>(s.x + i0 + h));
        q.u[h] = radix_key(v.x, s.negate);
        q.u[h + 1] = radix_key(v.y, s.negate);
        q.u[h + 2] = radix_key(v.z, s.negate);
        q.u[h + 3] = radix_key(v.w, s.negate);
      }
      q.ok = kChunkFull;
    } else {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const bool in = i0 + j < s.n;
        q.u[j] = in ? radix_key(__ldg(s.x + i0 + j), s.negate) : 0u;
        q.ok |= in ? 1u << j : 0u;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) q.c[j] = i0 + j;
    return q;
  }
  const bool gathered = s.kind == kFromGather;
  const int lim = gathered ? s.count : s.n;
  if (i0 + kChunk <= lim) {
#pragma unroll
    for (int h = 0; h < kChunk; h += 4) {
      const uint4 v = *reinterpret_cast<const uint4*>(s.keys + i0 + h);
      q.u[h] = v.x;
      q.u[h + 1] = v.y;
      q.u[h + 2] = v.z;
      q.u[h + 3] = v.w;
      if (gathered) {
        const int4 c = *reinterpret_cast<const int4*>(s.cols + i0 + h);
        q.c[h] = c.x;
        q.c[h + 1] = c.y;
        q.c[h + 2] = c.z;
        q.c[h + 3] = c.w;
      }
    }
    if (!gathered) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) q.c[j] = i0 + j;
    }
    q.ok = kChunkFull;
  } else {
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool in = i0 + j < lim;
      q.u[j] = in ? s.keys[i0 + j] : 0u;
      q.c[j] = in ? (gathered ? s.cols[i0 + j] : i0 + j) : 0;
      q.ok |= in ? 1u << j : 0u;
    }
  }
  return q;
}

// What a round is looking among: the keys after the last (key, column)
// written (the floor; (0, -1) before the first round, so every key) whose
// bits above sh are pre (hmask: those bits; hpre: pre in place).
struct Cut {
  unsigned pre;
  int sh;
  unsigned hmask, hpre;
  unsigned fu;  // the last key written and its column
  int fc;
  __device__ __forceinline__ bool alive(unsigned u, int c) const {
    return u > fu || (u == fu && c > fc);
  }
  __device__ __forceinline__ void set(unsigned p, int s) {
    pre = p;
    sh = s;
    hmask = s >= 32 ? 0u : ~0u << s;
    hpre = s >= 32 ? 0u : p << s;
  }
};

// Exclusive sum of v over the block's threads in order; the block's total
// to `total`. s: kRadixWarps + 1 ints. Safe to call again at once.
__device__ __forceinline__ int block_excl(int v, int* s, int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(RAFT_FULL_MASK, inc, off);
    if (lane >= off) inc += y;
  }
  if (lane == 31) s[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int w = lane < kRadixWarps ? s[lane] : 0;
    int wi = w;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(RAFT_FULL_MASK, wi, off);
      if (lane >= off) wi += y;
    }
    if (lane < kRadixWarps) s[lane] = wi - w;
    if (lane == 31) s[kRadixWarps] = wi;
  }
  __syncthreads();
  total = s[kRadixWarps];
  return inc - v + s[warp];
}

// One read of the source: the histogram of the next nb bits of the keys
// `cut` looks among; on the way, the keys staged to stage_keys (the first
// read of a row that fits), or the keys at or below the prefix gathered
// to (gk, gc) in column order (a block-wide scan a tile).
template <bool kAll>  // the first round: every key is after the floor
__device__ __forceinline__ void digit_pass(const RadixSource& s,
                                           const Cut& cut, int nb,
                                           unsigned* hist,
                                           unsigned* stage_keys,
                                           unsigned* gk, int* gc,
                                           int* s_scan) {
  const int sh2 = cut.sh - nb;
  const unsigned mask = (1u << nb) - 1u;
  const int lim = s.kind == kFromGather ? s.count : s.n;
  int run = 0;
  for (int base = 0; base < lim; base += kTile) {
    const int i0 = base + kChunk * threadIdx.x;
    const Chunk q = load_chunk(s, i0);
    if (stage_keys != nullptr) {
      if (q.ok == kChunkFull) {
#pragma unroll
        for (int h = 0; h < kChunk; h += 4) {
          *reinterpret_cast<uint4*>(stage_keys + i0 + h) =
              make_uint4(q.u[h], q.u[h + 1], q.u[h + 2], q.u[h + 3]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < kChunk; ++j) {
          if ((q.ok >> j) & 1u) stage_keys[i0 + j] = q.u[j];
        }
      }
    }
    // one shared-memory atomic a key: the card's own merging of a warp's
    // atomics on one address beats merging them in the warp first here
    // (by __match_any_sync or by runs of a thread's bins), though the
    // merge rows' sorted runs and +inf tails put whole warps in one bin
    unsigned keep = 0u;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool ok =
          ((q.ok >> j) & 1u) && (kAll || cut.alive(q.u[j], q.c[j]));
      const unsigned a = q.u[j] & cut.hmask;
      if (ok && a == cut.hpre) atomicAdd(&hist[(q.u[j] >> sh2) & mask], 1u);
      keep |= (ok && a <= cut.hpre) ? 1u << j : 0u;
    }
    if (gk != nullptr) {
      int total;
      int at = run + block_excl(__popc(keep), s_scan, total);
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        if ((keep >> j) & 1u) {
          gk[at] = q.u[j];
          gc[at] = q.c[j];
          ++at;
        }
      }
      run += total;
    }
  }
}

// The bin in which the histogram's running count reaches krem, the keys
// in the bins before it and its own count, the same on every thread.
__device__ __forceinline__ void find_digit(const unsigned* hist, int nbins,
                                           int krem, int* s_scan,
                                           int* s_res, int& dig,
                                           int& before, int& cnt) {
  const int b0 = threadIdx.x * kBinsPerThread;
  int own = 0;
#pragma unroll
  for (int b = 0; b < kBinsPerThread; ++b) {
    if (b0 + b < nbins) own += (int)hist[b0 + b];
  }
  int total;
  const int ex = block_excl(own, s_scan, total);
  if (ex < krem && krem <= ex + own) {
    int c = ex;
    for (int b = 0; b < kBinsPerThread; ++b) {
      const int h = (int)hist[b0 + b];
      if (c + h >= krem) {
        s_res[0] = b0 + b;
        s_res[1] = c;
        s_res[2] = h;
        break;
      }
      c += h;
    }
  }
  __syncthreads();
  dig = s_res[0];
  before = s_res[1];
  cnt = s_res[2];
}

// The round's keys in column order (a block-wide scan a tile, so the
// lowest columns win ties): the `less` keys below the prefix to
// sbuf[0, less); then the first krem keys at it, to sbuf[less, less +
// krem) where the prefix is a bucket (sh > 0), else — they are ties of
// the c-th key, already in order — written out at once to the round's
// slots after the first `less`, the last of them also to *last.
template <bool kAll>
__device__ __forceinline__ void take_round(const RadixSource& s,
                                           const Cut& cut, int less,
                                           int krem, RadixKey* sbuf,
                                           int* s_scan, float* ov, int* oi,
                                           RadixKey* last) {
  const int lim = s.kind == kFromGather ? s.count : s.n;
  const bool direct = cut.sh == 0;
  int run_lt = 0, run_eq = 0;
  for (int base = 0; base < lim; base += kTile) {
    if (run_lt == less && run_eq >= krem) break;  // all found
    const Chunk q = load_chunk(s, base + kChunk * threadIdx.x);
    unsigned lt = 0u, eq = 0u;
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const bool ok =
          ((q.ok >> j) & 1u) && (kAll || cut.alive(q.u[j], q.c[j]));
      const unsigned a = q.u[j] & cut.hmask;
      lt |= (ok && a < cut.hpre) ? 1u << j : 0u;
      eq |= (ok && a == cut.hpre) ? 1u << j : 0u;
    }
    int total;
    const int ex = block_excl(__popc(lt) | (__popc(eq) << 16), s_scan,
                              total);
    int at_lt = run_lt + (ex & 0xffff);
    int at_eq = run_eq + (ex >> 16);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const RadixKey key = ((RadixKey)q.u[j] << 32) | (unsigned)q.c[j];
      if ((lt >> j) & 1u) {
        sbuf[at_lt++] = key;
      } else if ((eq >> j) & 1u) {
        if (at_eq < krem) {
          if (direct) {
            ov[less + at_eq] = radix_value(q.u[j], s.negate);
            oi[less + at_eq] = q.c[j];
            if (at_eq == krem - 1) *last = key;
          } else {
            sbuf[less + at_eq] = key;
          }
        }
        ++at_eq;
      }
    }
    run_lt += total & 0xffff;
    run_eq += total >> 16;
  }
}

// Compare-exchange steps j = jmax, ..., 1 of bitonic stage s over the
// keys in registers: thread t holds keys kSortE·t + e, so partners less
// than kSortE apart are its own and partners less than kSortLocal apart a
// lane's of the same warp.
__device__ __forceinline__ void sort_steps(RadixKey (&v)[kSortE], int s,
                                           int jmax) {
  const int base = kSortE * threadIdx.x;
  for (int j = jmax; j > 0; j >>= 1) {
    if (j >= kSortE) {
#pragma unroll
      for (int e = 0; e < kSortE; ++e) {
        const RadixKey o = __shfl_xor_sync(RAFT_FULL_MASK, v[e], j / kSortE);
        const int i = base + e;
        const bool keep_min = ((i & j) == 0) == ((i & s) == 0);
        v[e] = keep_min ? min(v[e], o) : max(v[e], o);
      }
    } else {
#pragma unroll
      for (int e = 0; e < kSortE; ++e) {
        if ((e & j) == 0) {
          const RadixKey a = v[e], b = v[e | j];
          if ((a > b) == (((base + e) & s) == 0)) {
            v[e] = b;
            v[e | j] = a;
          }
        }
      }
    }
  }
}

// Sort sbuf[0, c) ascending (a bitonic network over at least kSortLocal
// keys, the next power of two, padded with the greatest key: the stages up
// to kSortLocal in registers, then for each stage its steps of partners
// kSortLocal apart or more in shared memory and the rest in registers)
// and write them out as values and columns, the last also to *last
// (unless last is null).
__device__ __forceinline__ void sort_round(RadixKey* sbuf, int c,
                                           int negate, float* ov, int* oi,
                                           RadixKey* last) {
  __syncthreads();  // the keys are in sbuf
  if (c == 0) return;
  int p = kSortLocal;
  while (p < c) p <<= 1;
  const int base = kSortE * threadIdx.x;
  const bool mine = base < p;  // the same on a warp's lanes
  RadixKey v[kSortE];
  if (mine) {
#pragma unroll
    for (int e = 0; e < kSortE; ++e) {
      v[e] = base + e < c ? sbuf[base + e] : ~0ull;
    }
    for (int s = 2; s <= kSortLocal; s <<= 1) sort_steps(v, s, s >> 1);
  }
  for (int s = 2 * kSortLocal; s <= p; s <<= 1) {
    __syncthreads();  // sbuf is read before it is written
    if (mine) {
#pragma unroll
      for (int e = 0; e < kSortE; ++e) sbuf[base + e] = v[e];
    }
    __syncthreads();
    for (int j = s >> 1; j >= kSortLocal; j >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kRadixThreads) {
        const int i = 2 * t - (t & (j - 1));
        const RadixKey a = sbuf[i], b = sbuf[i + j];
        if ((a > b) == ((i & s) == 0)) {
          sbuf[i] = b;
          sbuf[i + j] = a;
        }
      }
      __syncthreads();
    }
    if (mine) {
#pragma unroll
      for (int e = 0; e < kSortE; ++e) v[e] = sbuf[base + e];
      sort_steps(v, s, kSortLocal >> 1);
    }
  }
  if (mine) {
#pragma unroll
    for (int e = 0; e < kSortE; ++e) {
      const int i = base + e;
      if (i < c) {
        ov[i] = radix_value((unsigned)(v[e] >> 32), negate);
        oi[i] = (int)(unsigned)v[e];
      }
      if (i == c - 1 && last != nullptr) *last = v[e];
    }
  }
}

// One block a row. Dynamic shared memory: the round's sort buffer (cap
// 64-bit keys), the histogram (kRadixBins counts), then the row's keys
// (staged) or gcap gathered keys and their columns.
__global__ void __launch_bounds__(kRadixThreads, kRadixBlocks)
radix_select_kernel(const float* __restrict__ x, int n, int k, int negate,
                    int vec, int cap, int staged, int gcap,
                    float* __restrict__ out_v, int* __restrict__ out_i) {
  extern __shared__ __align__(16) unsigned char radix_smem[];
  __shared__ int s_scan[kRadixWarps + 1];
  __shared__ int s_res[3];
  __shared__ RadixKey s_last;  // the last key a round wrote
  RadixKey* sbuf = reinterpret_cast<RadixKey*>(radix_smem);
  unsigned* hist = reinterpret_cast<unsigned*>(radix_smem + (size_t)cap * 8);
  unsigned char* region = radix_smem + (size_t)cap * 8 + kRadixBins * 4;
  unsigned* rkeys = reinterpret_cast<unsigned*>(region);
  int* rcols = reinterpret_cast<int*>(region + (size_t)gcap * 4);
  const size_t row = blockIdx.x;
  RadixSource s;
  s.x = x + row * (size_t)n;
  s.keys = rkeys;
  s.cols = rcols;
  s.n = n;
  s.count = 0;
  s.negate = negate;
  s.vec = vec != 0;
  Cut cut;
  cut.fu = 0u;
  cut.fc = -1;
  bool first = true;
  float* ov = out_v + row * (size_t)k;
  int* oi = out_i + row * (size_t)k;
  for (int written = 0; written < k;) {
    const int c = min(cap, k - written);
    s.kind = (staged && !first) ? kFromStage : kFromRow;
    bool stage = staged && first;
    bool gather = false;
    cut.set(0u, 32);
    int less = 0, krem = c;
    // the c-th key after the floor, kRadixBits a pass; stop when the
    // bucket is one key, or it and the keys below it make c
    for (;;) {
      const int nb = min(kRadixBits, cut.sh);
      for (int b = threadIdx.x; b < (1 << nb); b += kRadixThreads) {
        hist[b] = 0u;
      }
      __syncthreads();
      unsigned* sk = stage ? rkeys : nullptr;
      unsigned* gk = gather ? rkeys : nullptr;
      if (first) {
        digit_pass<true>(s, cut, nb, hist, sk, gk, rcols, s_scan);
      } else {
        digit_pass<false>(s, cut, nb, hist, sk, gk, rcols, s_scan);
      }
      __syncthreads();
      if (stage) s.kind = kFromStage;
      if (gather) s.kind = kFromGather;
      stage = gather = false;
      int dig, before, cnt;
      find_digit(hist, 1 << nb, krem, s_scan, s_res, dig, before, cnt);
      less += before;
      krem -= before;
      cut.set((cut.pre << nb) | (unsigned)dig, cut.sh - nb);
      if (cut.sh == 0 || krem == cnt) break;
      // a row read from device memory: the next pass gathers the keys
      // at or below the bucket, if they fit, and the passes after it
      // read them there
      if (s.kind == kFromRow && less + cnt <= gcap) {
        gather = true;
        s.count = less + cnt;
      }
    }
    if (first) {
      take_round<true>(s, cut, less, krem, sbuf, s_scan, ov + written,
                       oi + written, &s_last);
    } else {
      take_round<false>(s, cut, less, krem, sbuf, s_scan, ov + written,
                        oi + written, &s_last);
    }
    // at sh = 0 the ties came out in take_round, the last key with them
    sort_round(sbuf, cut.sh == 0 ? less : c, negate, ov + written,
               oi + written, cut.sh == 0 ? nullptr : &s_last);
    __syncthreads();  // s_last is written; sbuf is read
    cut.fu = (unsigned)(s_last >> 32);
    cut.fc = (int)(unsigned)s_last;
    first = false;
    written += c;
  }
}

// Dynamic shared memory the radix select may take on this device: the
// opt-in limit less its static arrays, or its share of the SM where
// kRadixBlocks blocks are to be resident, set as the kernel's limit once
// a device.
constexpr int kMaxDevices = 64;
std::mutex radix_mu;
int radix_room[kMaxDevices];

cudaError_t radix_room_of(int* room) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  std::lock_guard<std::mutex> lock(radix_mu);
  if (radix_room[dev] == 0) {
    int optin = 0, per_sm = 0, reserved = 0;
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, dev);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(
          &reserved, cudaDevAttrReservedSharedMemoryPerBlock, dev);
    }
    cudaFuncAttributes fa;
    if (err == cudaSuccess) {
      err = cudaFuncGetAttributes(&fa, radix_select_kernel);
    }
    if (err != cudaSuccess) return err;
    const int share = per_sm / kRadixBlocks - reserved;
    const int r = (share < optin ? share : optin) - (int)fa.sharedSizeBytes;
    err = cudaFuncSetAttribute(radix_select_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               r);
    if (err != cudaSuccess) return err;
    radix_room[dev] = r;
  }
  *room = radix_room[dev];
  return cudaSuccess;
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

// The radix select, any 1 <= k <= n. The row's keys stay in shared memory
// when they fit beside the sort buffer and the histogram; a wider row
// gathers the keys at or below the k-th key's bucket there once they fit.
extern "C" int raft_select_k_radix(const void* values, int rows, int n, int k,
                                   int select_min, void* out_v, void* out_i,
                                   void* stream) {
  if (k < 1 || n < k) return (int)cudaErrorInvalidValue;
  int room = 0;
  const cudaError_t err = radix_room_of(&room);
  if (err != cudaSuccess) return (int)err;
  int cap = kSortLocal;  // the sort buffer holds at least its network
  while (cap < k && cap < kRadixCap) cap <<= 1;
  const size_t fixed = (size_t)cap * 8 + kRadixBins * 4;
  const size_t row_bytes = ((size_t)n * 4 + 15) / 16 * 16;
  const bool staged = fixed + row_bytes <= (size_t)room;
  int gcap = 0;
  size_t smem = fixed + row_bytes;
  if (!staged) {
    gcap = (int)(((size_t)room - fixed) / 8) & ~3;
    smem = fixed + (size_t)gcap * 8;
  }
  if (rows == 0) return 0;
  const float* x = (const float*)values;
  const bool vec = n % 4 == 0 && (uintptr_t)x % 16 == 0;
  radix_select_kernel<<<rows, kRadixThreads, smem, (cudaStream_t)stream>>>(
      x, n, k, select_min ? 0 : 1, vec ? 1 : 0, cap, staged ? 1 : 0, gcap,
      (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}
