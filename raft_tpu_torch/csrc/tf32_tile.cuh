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
// as its stored bytes (copy_stage) and each warp builds its B fragments
// from that stage in registers (see "The store forms" below): no widened
// block, no pass and no barrier of its own.
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
// the wide plans (K4 past k = 256, K3 past 512, K2 past 256): a block's
// bytes where two fit an SM, (233,472 - 2 x 1 KB reserved) / 2, and the
// 128-byte unit the static bytes beside the dynamic ones take
constexpr size_t kTwoBlocks = 115712;
constexpr size_t kStaticUnit = 128;

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

// ---------------------------------------------------------------------------
// The store forms (K2's and K3's): fragments built from the stored bytes
// ---------------------------------------------------------------------------
// A store's row tile is staged as its stored bytes (copy_stage) and each
// warp builds its fragments from that stage in registers: no widened
// block, no pass of its own, no barrier for it.
//
// * int8 / uint8 / int4 (stage rows of 32 bytes, the two 16-byte chunks
//   of row r XORed with (r / 4) % 2, so that a warp's 8 rows of 16-byte
//   reads meet 32 distinct banks): a lane loads the 16 bytes of a row
//   that hold 16 dimensions and widens its byte t4 of each word (TF32
//   B fragment: dimensions t4 and t4 + 4 of each 8) exactly: the byte
//   into the mantissa of 2^23 by one prmt, minus 2^23 (uint8); int8 xors
//   the byte with 0x80 first and subtracts 2^23 + 128; an int4 nibble
//   (its byte's low or high one by the stage) is xored with 8 into the
//   mantissa and 2^23 + 8 subtracted. Each value is an integer below
//   2^11, exact in TF32, so the products are 2xTF32 (the f32 query's hi
//   and lo parts) in the order of stage_dots' B_EXACT path, and uint8
//   gives the f32 form's bits on the same rows (stage_dots_bytes).
// * bf16 against the f32 query (K3, whose contract is the f32 query
//   against the row widened to f32): the same builder reads the 32 bytes
//   of a row that hold 16 dimensions (two 16-byte loads; every row of a
//   warp's 8 lands in its own 16-byte bank group under the stage's
//   swizzle, its four lanes reading the same bytes) and takes for lane t4
//   the halfwords of dimensions t4 and t4 + 4 of each 8, shifted into the
//   top of an f32 word: bf16's 8-bit significand is exact in TF32, so the
//   products are 2xTF32 as for the bytes and give the f32 form's bits on
//   the rows widened.
// * bf16 against a bf16 query (K2: the wrapper rounds the query, so the
//   dot is a bf16 product; stage rows of 64 bytes, the four 16-byte
//   chunks of row r XORed with (r / 2) % 4, so that ldmatrix's 8 rows
//   meet 32 distinct banks): m16n8k16 mma.sync with an f32 accumulator,
//   fragments by ldmatrix straight from the stage and from a bf16 copy of
//   the query tile (bf16_tile), half the instructions of the TF32 path and
//   no conversion. Each 16 dimensions sum in a fresh accumulator and join
//   the dot by a rounded add, as in stage_dots (stage_dots_bf16).
// The statement of the widening, bit for bit in torch integer ops, is
// tests/test_torch_widen.py.

// The 16-byte chunk c of stage row r, in 16-byte units from the stage's
// start (a row has BK elements of S).
template <int S>
__device__ __forceinline__ int stage_chunk(int r, int c) {
  if constexpr (S == kBF16) {
    return r * 4 + (c ^ ((r >> 1) & 3));
  } else {
    return r * 2 + (c ^ ((r >> 2) & 1));
  }
}

// Start the copies of stored rows [row0, row0 + ROWS) x elements
// [e0, e0 + 32) of the row-major (rows, w) store src into the swizzled
// stage dst (stage_chunk); rows at or past row_end and elements past w
// read as zeros. vec: 16-byte cp.async copies (w elements a multiple of
// 16 bytes, src 16-byte aligned), else element by element, stored
// synchronously (the stage is read only after a later barrier).
template <int S, int ROWS>
__device__ __forceinline__ void copy_stage(void* dst, const void* src,
                                           int row0, int row_end, int e0,
                                           int w, int vec, int tid) {
  using T = typename TileStore<S>::T;
  constexpr int PER = 16 / sizeof(T);   // elements a 16-byte chunk
  constexpr int CH = BK / PER;          // chunks a stage row
  uint4* d = (uint4*)dst;
  const T* s = (const T*)src;
  if (vec) {
    for (int e = tid; e < ROWS * CH; e += kThreads) {
      const int r = e / CH, c = e % CH;
      const bool ok = row0 + r < row_end && e0 + c * PER < w;
      cp_async16((float*)(d + stage_chunk<S>(r, c)),
                 (const float*)(ok ? s + (size_t)(row0 + r) * w + e0 +
                                         c * PER
                                   : s),
                 ok);
    }
  } else {
    for (int e = tid; e < ROWS * BK; e += kThreads) {
      const int r = e / BK, c = e % BK;
      const bool ok = row0 + r < row_end && e0 + c < w;
      ((T*)(d + stage_chunk<S>(r, c / PER)))[c % PER] =
          ok ? s[(size_t)(row0 + r) * w + e0 + c] : (T)0;
    }
  }
}

// Halfword t4 (0..3) of the stored word pair (a, b) — a's low, a's
// high, b's low, b's high — as the bits of an exact f32: the bf16 bits
// in the top of the word, a zero below.
__device__ __forceinline__ unsigned widen_bf16(unsigned a, unsigned b,
                                               int t4) {
  return __byte_perm(a, b, ((2 * t4 + 1) << 12) | ((2 * t4) << 8)) &
         0xffff0000u;
}

// Byte t4 of the stored word w (int4: its low nibble, or its high one
// when hi) as the bits of an exact f32.
template <int S>
__device__ __forceinline__ unsigned widen_lane(unsigned w, int t4,
                                               bool hi) {
  if constexpr (S == kI4) {
    const unsigned m = ((w >> (8 * t4 + (hi ? 4 : 0))) & 0xfu) ^
                       0x4b000008u;
    return __float_as_uint(__fsub_rn(__uint_as_float(m), 8388616.f));
  } else {
    static_assert(S == kI8 || S == kU8, "a byte store");
    const unsigned x = S == kI8 ? w ^ 0x80808080u : w;
    const unsigned m = __byte_perm(x, 0x4b000000u, 0x7540u | t4);
    return __float_as_uint(
        __fsub_rn(__uint_as_float(m), S == kI8 ? 8388736.f : 8388608.f));
  }
}

// acc += this warp's (16·MF) x 32 piece of one 32-dimension stage of a
// store whose values are exact in TF32 (int8, uint8, int4, bf16; hi: the
// int4 stage's high nibbles): A as in stage_dots (TF32 hi parts with
// their lo parts at a_lo, or raw floats split here when a_lo is null), B
// built from the stored stage Braw.
template <int MF, int S>
__device__ __forceinline__ void stage_dots_bytes(float (&acc)[MF][4][4],
                                                 const float* As,
                                                 const float* a_lo,
                                                 const unsigned char* Braw,
                                                 bool hi, int lane, int wm,
                                                 int wn) {
  const int lr = lane & 7, lq = lane >> 3;
  const int a_row = wm * 16 * MF + lr + 8 * (lq & 1), a_chunk = lq >> 1;
  const int g = lane >> 2, t4 = lane & 3;
  const uint4* B = (const uint4*)Braw;
  // not unrolled: hoisting the second half's fragments spills int4 (255
  // registers) and buys nothing in the byte stores (measured)
#pragma unroll 1
  for (int kk = 0; kk < BK; kk += 16) {
    // bh[u][j][h]: row wn·32 + 8·j + g, dimension kk + 8·u + 4·h + t4
    unsigned bh[2][4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wn * 32 + 8 * j + g;
      if constexpr (S == kBF16) {  // 8 dimensions a 16-byte chunk
        const uint4 w0 = B[stage_chunk<S>(r, kk >> 3)];
        const uint4 w1 = B[stage_chunk<S>(r, (kk >> 3) + 1)];
        bh[0][j][0] = widen_bf16(w0.x, w0.y, t4);
        bh[0][j][1] = widen_bf16(w0.z, w0.w, t4);
        bh[1][j][0] = widen_bf16(w1.x, w1.y, t4);
        bh[1][j][1] = widen_bf16(w1.z, w1.w, t4);
      } else {  // 16 dimensions a 16-byte chunk
        const uint4 w = B[stage_chunk<S>(r, kk >> 4)];
        bh[0][j][0] = widen_lane<S>(w.x, t4, hi);
        bh[0][j][1] = widen_lane<S>(w.y, t4, hi);
        bh[1][j][0] = widen_lane<S>(w.z, t4, hi);
        bh[1][j][1] = widen_lane<S>(w.w, t4, hi);
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
        // stage_dots' B_EXACT order: the products of the lo parts first
        float t[4];
        mma_tf32_first(t, al[0], bh[0][j]);
        mma_tf32(t, al[1], bh[1][j]);
        mma_tf32(t, ah[0], bh[0][j]);
        mma_tf32(t, ah[1], bh[1][j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
      }
    }
  }
}

// d = a·b on a 16 x 8 x 16 bf16 tile into a fresh f32 accumulator.
__device__ __forceinline__ void mma_bf16_first(float (&d)[4],
                                               const unsigned (&a)[4],
                                               const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}

// Two f32 values as one word of bf16 (lo in the low half), rounded to
// nearest (exact for values that are bf16 already).
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// A bf16 copy of rows [row0, row0 + ROWS) x dimensions [0, nk·32) of the
// row-major (rows, d) f32 matrix src: nk blocks of ROWS stage rows of 32
// bf16 (stage_chunk<kBF16>'s layout), zeros past row_end and d; read
// synchronously (vec: 16-byte reads). Called by all threads of the block.
template <int ROWS>
__device__ __forceinline__ void bf16_tile(unsigned char* dst,
                                          const float* src, int row0,
                                          int row_end, int d, int nk,
                                          int vec, int tid) {
  uint4* out = (uint4*)dst;
  for (int e = tid; e < nk * ROWS * 4; e += kThreads) {
    const int kc = e / (ROWS * 4), r = (e / 4) % ROWS, c = e % 4;
    const int k0 = kc * BK + c * 8;
    const float* p = src + (size_t)(row0 + r) * d + k0;
    float v[8];
    if (row0 + r < row_end && vec && k0 + 8 <= d) {
      const float4 x = *(const float4*)p, y = *(const float4*)(p + 4);
      v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
      v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
    } else {
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        v[t] = row0 + r < row_end && k0 + t < d ? p[t] : 0.f;
      }
    }
    out[kc * ROWS * 4 + stage_chunk<kBF16>(r, c)] =
        make_uint4(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]),
                   pack_bf16(v[4], v[5]), pack_bf16(v[6], v[7]));
  }
}

// acc += this warp's (16·MF) x 32 piece of one 32-dimension stage of a
// bf16 store, as bf16 products: A from the query's bf16 block Abf
// (bf16_tile's layout) or, when Abf is null, from the stage's f32 query
// block As (swz layout, packed to bf16 here); B by ldmatrix from the
// stored stage Braw.
template <int MF>
__device__ __forceinline__ void stage_dots_bf16(float (&acc)[MF][4][4],
                                                const unsigned char* Abf,
                                                const float* As,
                                                const unsigned char* Braw,
                                                int lane, int wm, int wn) {
  const int lr = lane & 7, lq = lane >> 3;
  const int a_row = wm * 16 * MF + lr + 8 * (lq & 1), a_chunk = lq >> 1;
  const int b_row = wn * 32 + lr + 8 * (lq >> 1), b_chunk = lq & 1;
  const int g = lane >> 2, t4 = lane & 3;
  const uint4* A = (const uint4*)Abf;
  const uint4* B = (const uint4*)Braw;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    // b[j]: row wn·32 + 8·j + g, dimensions kk + 2·t4 (+1) and +8 (+9)
    unsigned b[4][2];
#pragma unroll
    for (int jp = 0; jp < 2; ++jp) {
      unsigned raw[4];
      ldsm_x4(raw, (const float*)(B + stage_chunk<kBF16>(
                                           b_row + 16 * jp,
                                           (kk >> 3) + b_chunk)));
      b[2 * jp][0] = raw[0];
      b[2 * jp][1] = raw[1];
      b[2 * jp + 1][0] = raw[2];
      b[2 * jp + 1][1] = raw[3];
    }
#pragma unroll
    for (int i = 0; i < MF; ++i) {
      unsigned a[4];
      if (A != nullptr) {
        ldsm_x4(a, (const float*)(A + stage_chunk<kBF16>(
                                          a_row + 16 * i,
                                          (kk >> 3) + a_chunk)));
      } else {
#pragma unroll
        for (int h = 0; h < 4; ++h) {  // rows g (+8), dims 2·t4 (+8)
          const int r = wm * 16 * MF + 16 * i + g + 8 * (h & 1);
          const float2 x =
              *(const float2*)(As + swz(r, kk + 8 * (h >> 1) + 2 * t4));
          a[h] = pack_bf16(x.x, x.y);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float t[4];
        mma_bf16_first(t, a, b[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
      }
    }
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
// they would add exact zeros, so the sums are the same bits.
template <int MF>
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
// store); a_max, a_elem: the first a_res tried and the bytes of a
// resident query value (K2's bf16 store: 1 and 2, a bf16 copy). Returns
// the bytes, or 0 when nothing fits.
inline size_t fit_tiles(int bm, int d, int ns_max, size_t fixed, int* a_res,
                        int* ns, size_t b_stage = sizeof(float) * BK * BN,
                        int a_max = 2, size_t a_elem = sizeof(float)) {
  const size_t nk = (d + BK - 1) / BK;
  for (int a = a_max; a >= 0; --a) {
    for (int s = ns_max; s >= 2; --s) {
      const size_t bytes =
          a_elem * BK * a * nk * bm +
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
