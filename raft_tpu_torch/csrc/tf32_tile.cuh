// The tile machinery of the port's tensor-core scans: K2 (fused_knn.cu)
// and the grouped forms of K3 (ivf_flat_scan.cu) and K4 (ivf_pq_scan.cu).
//
// A block of 8 warps scores BM = 32·MF query rows against tiles of
// BN = 128 rows, 32 dimensions a stage, on the tensor cores as 3xTF32:
// each f32 operand x is split into hi = tf32(x) and lo = tf32(x − hi)
// (cvt.rna.tf32.f32; the tensor core reads only an f32 register's upper
// 19 bits, so both parts are converted explicitly), and m16n8k8 TF32
// mma.sync sums lo·hi, hi·lo and hi·hi in f32 (lo·lo, 2^-22 of the
// product, is dropped). The tensor core truncates the sums it forms
// (rounds toward zero), which biases a long accumulation toward zero, so
// each 16 dimensions' six products are summed in a fresh accumulator and
// added to the dot by an ordinary rounded add. Integer-valued inputs of
// magnitude below 2^11 are held exactly by their hi parts, so their dots
// are exact as long as the sums are below 2^24. The warps sit 2 along the
// queries x 4 along the rows, each computing a (16·MF) x 32 piece as
// MF x 4 mma tiles. Staged tiles keep rows of 32 floats with their
// 16-byte chunks XOR-swizzled by the row, so a fragment's 32 lanes read
// 32 distinct banks.
//
// Selection from the accumulator fragments (offer_tile): each thread
// compares its fragment's distances with its row's current k-th value;
// what is strictly before it takes a slot of the row's candidate buffer
// (CAP keys in shared memory) by a shared atomic. A candidate that finds
// the buffer full waits: the block syncs, the warps fold every full
// buffer into its sorted k-list with K1's warp-select queue
// (warp_queue.cuh), and the waiting candidates try again against the new
// k-th keys. Equal keys compare by column, so the (value, column) order is
// exact whatever the order in which candidates arrive, and the result is
// the same bits run to run. A queue of 32·R keys holds k-lists up to
// k = 32·R; a buffer of CAP <= 32·RB keys is sorted in RB registers
// before it meets the queue's last RB (RB = R but in the wide plans of K3
// and K4: a queue of 512 keys beside buffers of 128, RB = 4, sorts 128
// keys a fold instead of 512).
//
// Low-precision stores (K2's and K3's store forms): the row tile is staged
// as its stored bytes (copy_raw: a 32-dimension stage row is 64 B at bf16,
// 32 B at int8 / uint8 and, for int4, 32 bytes whose low or high nibbles
// are the stage's 32 dimensions) and widened to f32 in one pass into a
// swizzled block (widen_stage) before its fragments are built. Every
// stored value is exact in TF32 (bf16's 8-bit significand, integers below
// 2^11, nibbles), so the row needs no lo part and the f32 query's two
// parts give the dot as 2xTF32 (B_EXACT); a query that is exact in TF32
// too (K2's bf16 store rounds it to bf16) needs one product (A_EXACT).
#pragma once

#include <cstdint>
#include <type_traits>

#include "warp_queue.cuh"

namespace {

constexpr int BN = 128;        // rows a tile
constexpr int BK = 32;         // dimensions a pipeline stage
constexpr int kThreads = 256;  // 8 warps: 2 along the queries x 4 the rows
constexpr size_t kSmemLimit = 232448;  // a block's shared memory on sm_90
// the widest k-list of the grouped K3 and K4 (ops/ivf_scan.py, GROUP_MAX_K)
constexpr int kGroupMaxK = 512;

// The stores a tile may hold: the element type as stored and its bytes.
enum StoreKind : int { kF32 = 0, kBF16 = 1, kI8 = 2, kU8 = 3, kI4 = 4 };
template <int S>
struct TileStore;
template <>
struct TileStore<kF32> {
  using T = float;
};
template <>
struct TileStore<kBF16> {
  using T = unsigned short;  // the raw bits
};
template <>
struct TileStore<kI8> {
  using T = signed char;
};
template <>
struct TileStore<kU8> {
  using T = unsigned char;
};
template <>
struct TileStore<kI4> {
  using T = signed char;  // two nibbles a byte
};
template <int S>
__host__ __device__ constexpr int store_bytes() {
  return (int)sizeof(typename TileStore<S>::T);
}

// Where float c (of 32) of row r of a staged tile lives: its 16-byte
// chunk c / 4 is XORed with r % 8, so the 8 rows of a fragment's row group
// read 8 different chunks (32 distinct banks) and a row's 8 chunks, as
// cp.async writes them, still cover all 32 banks.
__device__ __forceinline__ int swz(int r, int c) {
  return r * BK + ((((c >> 2) ^ r) & 7) << 2) + (c & 3);
}

__device__ __forceinline__ unsigned to_tf32(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x ≈ hi + lo, both TF32.
__device__ __forceinline__ void split_tf32(float x, unsigned& hi,
                                           unsigned& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a·b on a 16 x 8 x 8 TF32 tile, f32 accumulation.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a·b on a 16 x 8 x 8 TF32 tile into a fresh f32 accumulator.
__device__ __forceinline__ void mma_tf32_first(float (&d)[4],
                                               const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// Four 8 x 4 blocks of 32-bit words from shared memory, one register each
// a lane: lane l of block q gets word l % 4 of row l / 4, lanes 8q..8q+7
// give the rows' 16-byte addresses (ldmatrix .b16: a word is two b16).
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// Copy 16 (or 4) bytes from device to shared memory asynchronously, or
// zero-fill them when !valid (src is then not read).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until the oldest group a ring of ns (2 or 3) stages needs has
// landed: at most ns − 1 groups still in flight.
__device__ __forceinline__ void cp_async_wait_stage(int ns) {
  if (ns == 3) {
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  } else {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  }
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The bits of this thread's 16·MF fragment values.
template <int MF>
using Pending =
    typename std::conditional<(MF > 2), unsigned long long, unsigned>::type;

// Start the copies of rows [row0, row0 + ROWS) x dimensions [k0, k0 + 32)
// of the row-major (rows, d) matrix src into the swizzled block dst; rows
// at or past row_end and dimensions past d read as zeros.
template <int ROWS>
__device__ __forceinline__ void copy_block(float* dst, const float* src,
                                           int row0, int row_end, int k0,
                                           int d, int vec, int tid) {
  if (vec) {
    for (int e = tid; e < ROWS * (BK / 4); e += kThreads) {
      const int r = e >> 3, c = (e & 7) * 4;
      const bool ok = row0 + r < row_end && k0 + c < d;
      cp_async16(dst + swz(r, c),
                 ok ? src + (size_t)(row0 + r) * d + k0 + c : src, ok);
    }
  } else {
    for (int e = tid; e < ROWS * BK; e += kThreads) {
      const int r = e >> 5, c = e & 31;
      const bool ok = row0 + r < row_end && k0 + c < d;
      cp_async4(dst + swz(r, c),
                ok ? src + (size_t)(row0 + r) * d + k0 + c : src, ok);
    }
  }
}

// The same for the rows rows[0..ROWS) of src (shared memory; a negative
// entry reads as zeros).
template <int ROWS>
__device__ __forceinline__ void copy_gather(float* dst, const float* src,
                                            const int* rows, int k0, int d,
                                            int vec, int tid) {
  if (vec) {
    for (int e = tid; e < ROWS * (BK / 4); e += kThreads) {
      const int r = e >> 3, c = (e & 7) * 4;
      const int row = rows[r];
      const bool ok = row >= 0 && k0 + c < d;
      cp_async16(dst + swz(r, c), ok ? src + (size_t)row * d + k0 + c : src,
                 ok);
    }
  } else {
    for (int e = tid; e < ROWS * BK; e += kThreads) {
      const int r = e >> 5, c = e & 31;
      const int row = rows[r];
      const bool ok = row >= 0 && k0 + c < d;
      cp_async4(dst + swz(r, c), ok ? src + (size_t)row * d + k0 + c : src,
                ok);
    }
  }
}

// One stored value widened to f32 (int4: the low nibble of the byte, or
// the high one when hi).
template <int S>
__device__ __forceinline__ float widen1(typename TileStore<S>::T v,
                                        bool hi = false) {
  if constexpr (S == kF32) {
    return v;
  } else if constexpr (S == kBF16) {
    return __uint_as_float((unsigned)v << 16);
  } else if constexpr (S == kI4) {
    const unsigned w = (unsigned)(int)v;
    return (float)((int)(w << (hi ? 24 : 28)) >> 28);
  } else {
    return (float)v;
  }
}

// Start the copies of stored rows [row0, row0 + ROWS) x elements
// [e0, e0 + 32) of the row-major (rows, w) store src into the raw stage
// dst (ROWS rows of 32 elements); rows at or past row_end and elements
// past w read as zeros. vec: 16-byte cp.async copies (w elements a
// multiple of 16 bytes, src 16-byte aligned), else element by element,
// stored synchronously (the stage is read only after a later barrier).
template <int S, int ROWS>
__device__ __forceinline__ void copy_raw(void* dst, const void* src,
                                         int row0, int row_end, int e0,
                                         int w, int vec, int tid) {
  using T = typename TileStore<S>::T;
  constexpr int PER = 16 / sizeof(T);   // elements a 16-byte chunk
  constexpr int CH = BK / PER;          // chunks a stage row
  T* d = (T*)dst;
  const T* s = (const T*)src;
  if (vec) {
    for (int e = tid; e < ROWS * CH; e += kThreads) {
      const int r = e / CH, c = (e % CH) * PER;
      const bool ok = row0 + r < row_end && e0 + c < w;
      cp_async16((float*)(d + r * BK + c),
                 (const float*)(ok ? s + (size_t)(row0 + r) * w + e0 + c
                                   : s),
                 ok);
    }
  } else {
    for (int e = tid; e < ROWS * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const bool ok = row0 + r < row_end && e0 + c < w;
      d[r * BK + c] = ok ? s[(size_t)(row0 + r) * w + e0 + c] : (T)0;
    }
  }
}

// Widen a raw stage (ROWS rows of 32 stored elements) into the swizzled
// f32 block dst, 4 values (one 16-byte chunk) a thread at a time; hi:
// the int4 stage's high nibbles. Called by all threads of the block.
template <int S, int ROWS>
__device__ __forceinline__ void widen_stage(float* dst, const void* raw,
                                            bool hi, int tid) {
  using T = typename TileStore<S>::T;
  const T* s = (const T*)raw;
  for (int e = tid; e < ROWS * (BK / 4); e += kThreads) {
    const int r = e >> 3, c = (e & 7) * 4;
    const T* p = s + r * BK + c;
    float4 v;
    if constexpr (S == kBF16) {
      const uint2 w = *(const uint2*)p;
      v = make_float4(__uint_as_float(w.x << 16),
                      __uint_as_float(w.x & 0xffff0000u),
                      __uint_as_float(w.y << 16),
                      __uint_as_float(w.y & 0xffff0000u));
    } else {
      const unsigned w = *(const unsigned*)p;
      v = make_float4(widen1<S>((T)(w & 0xff), hi),
                      widen1<S>((T)((w >> 8) & 0xff), hi),
                      widen1<S>((T)((w >> 16) & 0xff), hi),
                      widen1<S>((T)(w >> 24), hi));
    }
    *(float4*)(dst + swz(r, c)) = v;
  }
}

// Split a resident tile of n floats in place into its TF32 hi parts and,
// n floats on, its lo parts.
__device__ __forceinline__ void split_tile(float* tile, int n, int tid) {
  for (int e = tid; e < n; e += kThreads) {
    unsigned hi, lo;
    split_tf32(tile[e], hi, lo);
    tile[e] = __uint_as_float(hi);
    tile[n + e] = __uint_as_float(lo);
  }
}

// acc += this warp's (16·MF) x 32 piece of one 32-dimension stage: A the
// block's BM x 32 query block (TF32 hi parts, with their lo parts at a_lo,
// or raw floats split here when a_lo is null), B the 128 x 32 row block.
// B_EXACT (runtime, block-uniform): every B value is exact in TF32, so
// its lo parts are zero and the two products that read them are skipped;
// they would add exact zeros, so the sums are the same bits. A_EXACT:
// every A value is exact in TF32 as well (with B_EXACT), so one product
// of the hi parts is the whole product.
template <int MF, bool A_EXACT = false>
__device__ __forceinline__ void stage_dots(float (&acc)[MF][4][4],
                                           const float* As, const float* a_lo,
                                           const float* Bs, bool b_exact,
                                           int lane, int wm, int wn) {
  // each lane's row and 16-byte chunk in the ldmatrix blocks: A blocks
  // (rows +0/+8) x (dims +0/+4), B blocks (j-block +0/+1) x (dims +0/+4)
  const int lr = lane & 7, lq = lane >> 3;
  const int a_row = wm * 16 * MF + lr + 8 * (lq & 1), a_chunk = lq >> 1;
  const int b_row = wn * 32 + lr + 8 * (lq >> 1), b_chunk = lq & 1;
  // two 8-dimension steps at a time: the tensor core truncates the f32
  // sums it forms, so the 16 dimensions' six products are summed in a
  // fresh accumulator, small ones first, and join the dot by a rounded add
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    unsigned bh[2][4][2], bl[2][4][2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int c4 = ((kk + 8 * u) >> 2) + b_chunk;
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        unsigned raw[4];
        ldsm_x4(raw, Bs + (b_row + 16 * jp) * BK + ((c4 ^ lr) & 7) * 4);
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          unsigned& h = bh[u][2 * jp + (w >> 1)][w & 1];
          unsigned& l = bl[u][2 * jp + (w >> 1)][w & 1];
          if (b_exact) {
            h = raw[w];
            l = 0u;
          } else {
            split_tf32(__uint_as_float(raw[w]), h, l);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      unsigned ah[2][4], al[2][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c4 = ((kk + 8 * u) >> 2) + a_chunk;
        const int off = (a_row + 16 * i) * BK + ((c4 ^ lr) & 7) * 4;
        if (a_lo != nullptr) {
          ldsm_x4(ah[u], As + off);
          ldsm_x4(al[u], a_lo + off);
        } else {
          unsigned raw[4];
          ldsm_x4(raw, As + off);
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            split_tf32(__uint_as_float(raw[w]), ah[u][w], al[u][w]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t[4];
        if (A_EXACT) {
          mma_tf32_first(t, ah[0], bh[0][j]);
          mma_tf32(t, ah[1], bh[1][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
          continue;
        }
        mma_tf32_first(t, al[0], bh[0][j]);
        if (!b_exact) mma_tf32(t, ah[0], bl[0][j]);
        mma_tf32(t, al[1], bh[1][j]);
        if (!b_exact) mma_tf32(t, ah[1], bl[1][j]);
        mma_tf32(t, ah[0], bh[0][j]);
        mma_tf32(t, ah[1], bh[1][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
      }
    }
  }
}

// Fold row r's buffer (its first nb keys) into its k-list, with one warp
// (a queue of 32·R keys; the buffer sorted in RB registers, CAP <= 32·RB).
template <int R, int CAP, int RB = R>
__device__ __forceinline__ void fold_row(float* list_v, int* list_c,
                                         float* buf_v, int* buf_c,
                                         int* buf_n, int r, int nb, int k,
                                         int lane) {
  float qv[R];
  int qc[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = i * 32 + lane;
    if (e < k) {
      qv[i] = list_v[r * k + e];
      qc[i] = list_c[r * k + e];
    } else {
      warpq::set_empty(qv[i], qc[i]);
    }
  }
  static_assert(CAP <= 32 * RB, "a buffer folds in one pass");
  warpq::fold_buffer<float, R, RB>(qv, qc, buf_v + r * CAP, buf_c + r * CAP,
                                   nb, lane);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int e = i * 32 + lane;
    if (e < k) {
      list_v[r * k + e] = qv[i];
      list_c[r * k + e] = qc[i];
    }
  }
  __syncwarp();
  if (lane == 0) buf_n[r] = 0;
}

// Offer a finished tile's distances to the block's k-lists (the header's
// selection). dist[i][j][e] sits at row wm·16·MF + 16·i + g + 8·(e / 2)
// and column col0 + 8·j + e % 2, col0 being the tile's first column plus
// wn·32 + 2·t4. A row r with live[r] < 0 takes nothing (live may be
// null: every row takes). Every listed column precedes this tile's, so
// the first offer compares values only: a key equal to the k-th is never
// before it here, and the k-th of a short list is +inf, so no +inf or NaN
// distance is ever offered. Called by all threads of the block.
template <int MF, int R, int CAP, int RB = R>
__device__ __forceinline__ void offer_tile(
    const float (&dist)[MF][4][4], const int* live, int col0, float* list_v,
    int* list_c, float* buf_v, int* buf_c, int* buf_n, int k, int lane,
    int warp, int wm, int g) {
  constexpr int BM = 32 * MF;
  float tv[MF][2];
  int tc[MF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 * MF + 16 * i + g + 8 * h;
      tv[i][h] = (live == nullptr || live[r] >= 0) ? list_v[r * k + k - 1]
                                                   : -CUDART_INF_F;
    }
  }
  // what finds its buffer full stays pending
  Pending<MF> pend = 0;
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1;
        const int r = wm * 16 * MF + 16 * i + g + 8 * h;
        if (dist[i][j][e] < tv[i][h]) {
          const int slot = atomicAdd(&buf_n[r], 1);
          if (slot < CAP) {
            buf_v[r * CAP + slot] = dist[i][j][e];
            buf_c[r * CAP + slot] = col0 + 8 * j + (e & 1);
          } else {
            pend |= (Pending<MF>)1 << ((i * 4 + j) * 4 + e);
          }
        }
      }
    }
  }
  // while some candidate found its buffer full: fold the full buffers and
  // offer the pending candidates again, against the new k-th keys
  while (__syncthreads_or(pend != 0)) {
    for (int r = warp; r < BM; r += kThreads / 32) {
      if (buf_n[r] >= CAP) {
        fold_row<R, CAP, RB>(list_v, list_c, buf_v, buf_c, buf_n, r, CAP,
                             k, lane);
      }
    }
    __syncthreads();
    // the folds may have listed this tile's columns: compare whole keys
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 * MF + 16 * i + g + 8 * h;
        tv[i][h] = list_v[r * k + k - 1];
        tc[i][h] = list_c[r * k + k - 1];
      }
    }
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const Pending<MF> bit = (Pending<MF>)1 << ((i * 4 + j) * 4 + e);
          if (!(pend & bit)) continue;
          const int h = e >> 1;
          const int r = wm * 16 * MF + 16 * i + g + 8 * h;
          const int col = col0 + 8 * j + (e & 1);
          if (key_less(dist[i][j][e], col, tv[i][h], tc[i][h])) {
            const int slot = atomicAdd(&buf_n[r], 1);
            if (slot >= CAP) continue;  // still pending
            buf_v[r * CAP + slot] = dist[i][j][e];
            buf_c[r * CAP + slot] = col;
          }
          pend &= ~bit;
        }
      }
    }
  }
}

// The first layout whose shared memory fits: the query tile resident
// split into its TF32 parts (a_res 2), resident as it is (1), or streamed
// through the ring beside the row tile (0), each with a ring of ns_max
// stages and then of 2. fixed: the bytes beside the tiles; b_stage: the
// bytes of a stage's row tile (f32 unless the rows are a low-precision
// store). Returns the bytes, or 0 when nothing fits.
inline size_t fit_tiles(int bm, int d, int ns_max, size_t fixed, int* a_res,
                        int* ns, size_t b_stage = sizeof(float) * BK * BN) {
  const size_t nk = (d + BK - 1) / BK;
  for (int a = 2; a >= 0; --a) {
    for (int s = ns_max; s >= 2; --s) {
      const size_t bytes =
          sizeof(float) * BK * a * nk * bm +
          (size_t)s * (sizeof(float) * BK * (a ? 0 : bm) + b_stage) + fixed;
      if (bytes <= kSmemLimit) {
        *a_res = a;
        *ns = s;
        return bytes;
      }
    }
  }
  return 0;
}

// The k-lists and buffers of a block of bm rows: bm·(k + cap) keys and bm
// counts.
inline size_t list_bytes(int bm, int k, int cap) {
  return (sizeof(float) + sizeof(int)) * (size_t)bm * (k + cap) +
         sizeof(int) * (size_t)bm;
}

}  // namespace
