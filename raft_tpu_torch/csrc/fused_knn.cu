// K2 — query x corpus distance fused with a running per-query top-k.
//
// Replaces the TPU kernel raft_tpu/ops/fused_knn.py::_fused_knn_padded
// (kernel _kernel): the distance block of a (query tile, corpus tile) pair
// on the MXU at precision "highest" (a multi-pass f32 emulation), a
// running k-best in VMEM scratch, ties by (value, smallest global column),
// ids = -1 on +inf slots, the filter as an additive penalty row.
//
// Design on Hopper. The distance block goes through the tensor cores at
// f32 accuracy as 3xTF32: each f32 operand x is split into hi = tf32(x)
// and lo = tf32(x − hi) (cvt.rna.tf32.f32; the tensor core reads only an
// f32 register's upper 19 bits, so both parts are converted explicitly),
// and m16n8k8 TF32 mma.sync sums lo·hi, hi·lo and hi·hi in f32 (lo·lo,
// 2^-22 of the product, is dropped). The tensor core truncates the sums
// it forms (rounds toward zero), which biases a long accumulation toward
// zero, so each 16 dimensions' six products are summed in a fresh
// accumulator and added to the dot by an ordinary rounded add. Integer-
// valued inputs of magnitude below 2^11 are held exactly by their hi
// parts, so their dots are exact as long as the sums are below 2^24.
//
// A block of 8 warps owns BM = 32·MF queries (MF = 4 for k <= 64, 2
// above) and walks its split of the corpus in tiles of BN = 128 rows; the
// warps sit 2 along the queries x 4 along the rows, each computing a
// (16·MF) x 32 piece as MF x 4 mma tiles. The query tile is copied into
// shared memory once and stays there (nk blocks of BM x 32 dimensions)
// where it fits beside the rest (d = 128: 64 KB at 128 queries); the
// corpus tiles stream through a ring of 3 stages (2 where shared memory
// is short), 32 dimensions a stage, by cp.async (16-byte copies where d
// is a multiple of 4, zero-filled past the matrix), so the copies of the
// next two stages are in flight while the tensor cores work on one. Where
// the query tile does not fit, it streams through the ring beside the
// corpus tile. A tile's rows are 32 floats with their 16-byte chunks
// XOR-swizzled by the row, so a fragment's 32 lanes read 32 distinct
// banks. The first stage of a corpus tile also brings its 128 columns'
// norms and penalties into one of four side buffers.
//
// Selection from the accumulator fragments: no distance block is written
// to shared memory. Once a tile's dots are complete, each thread turns
// its 16·MF fragment values into distances (l2 from the norms, cosine, or
// -dot for inner product, the metric a template parameter; the penalty
// row, zero when absent, is always added as in the JAX kernel, and +inf
// past the split's last row) and compares each with its query's current
// k-th key (value, column), read from the query's sorted k-list in shared
// memory. Only what is strictly before it enters the query's candidate
// buffer (CAP keys in shared memory, a slot taken by a shared atomic).
// A candidate that finds the buffer full waits: the block syncs, the
// warps fold every full buffer into its k-list with K1's warp-select
// queue (warp_queue.cuh: the list and the buffer in registers, a bitonic
// sort and merge), and the waiting candidates try again against the new
// k-th keys. Buffers that are not full carry over to later tiles; at the
// end of the split every buffer is folded. So after the first tiles
// almost every candidate is turned away by one compare, and a fold costs
// one bitonic sort for up to CAP candidates. Equal keys compare by global
// column, so the (value, column) order is exact whatever the order in
// which candidates arrive. A distance of +inf (a filtered row) or NaN is
// never offered, so a query with fewer than k such rows ends in
// (+inf, -1) slots. The k-lists cost BM·k·8 bytes of shared memory, so
// the query tile shrinks with k: 128 queries and CAP = the queue's C
// (32 or 64 keys) for k <= 64; 64 queries above, with CAP = 128 up to
// k = 128 and 64 up to k = 256 (the CAGRA build's k = 129, d = 128:
// 66 KB of lists, 33 KB of buffers, 32 KB of resident queries, a 48 KB
// ring).
//
// When there are too few query tiles to fill the card, the corpus is
// split over blockIdx.y; each split writes its k best, sorted, into its
// own k columns of a (m, splits·k) buffer and the wrapper merges those
// with K1. Equal values there come in split order and, inside a split, in
// column order, so K1's lowest-position tie break is the lowest global
// column (no distance is -0.0: the penalty add turns it into +0.0).
//
// Bound on this card: the f32-accurate product is 3 TF32 products of
// 2·m·n·d operations each — 7.68 TFLOP at m = 10,000, n = 1,000,000,
// d = 128 — against the 495 TFLOP/s dense TF32 rate: operations, not the
// 0.5 GB corpus read. mma.sync is the simple route to the tensor cores
// but does not reach that rate on this card; wgmma with TMA loads and
// warp specialisation, which would also overlap the selection with the
// products, is the next step.
#include <cstdint>
#include <type_traits>

#include "warp_queue.cuh"

namespace {

constexpr int BN = 128;        // corpus rows a tile
constexpr int BK = 32;         // dimensions a pipeline stage
constexpr int kThreads = 256;  // 8 warps: 2 along the queries x 4 the rows

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

// Fold row r's buffer (its first nb keys) into its k-list, with one warp.
template <int R, int CAP>
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
  warpq::fold_buffer<float, R>(qv, qc, buf_v + r * CAP, buf_c + r * CAP, nb,
                               lane);
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

template <int MF, int R, int CAP, int METRIC>
__global__ void __launch_bounds__(kThreads, 1)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                 const float* __restrict__ data,
                 const float* __restrict__ dn,
                 const float* __restrict__ pen, int m, int n, int d, int k,
                 int rows_per_split, int vec, int a_res, int ns,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int BM = 32 * MF;
  const int nk = (d + BK - 1) / BK;
  // the query tile: resident (nk blocks of BM x 32, loaded once) or a part
  // of every ring stage; then ns ring stages of the corpus tile
  // a_res: 0 the query tile streams through the ring beside the corpus
  // tile; 1 it stays in shared memory; 2 it stays there split once into
  // its TF32 hi and lo parts (two arrays)
  const int a_floats = a_res == 0 ? 0 : a_res * nk * BM * BK;
  const int stage = (a_res ? 0 : BM * BK) + BN * BK;
  extern __shared__ __align__(16) float smem[];
  float* a_tile = smem;
  float* ring = smem + a_floats;
  float* sides = ring + ns * stage;         // 4 x (dn, pen) of a tile
  float* list_v = sides + 4 * 2 * BN;       // BM x k sorted keys
  int* list_c = (int*)(list_v + BM * k);
  float* buf_v = (float*)(list_c + BM * k);  // BM x CAP candidates
  int* buf_c = (int*)(buf_v + BM * CAP);
  int* buf_n = buf_c + BM * CAP;             // BM counts

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // the fragment's row group
  const int t4 = lane & 3;   // and the thread in it
  const int wm = warp >> 2;  // 0..1 along the queries
  const int wn = warp & 3;   // 0..3 along the rows
  const int q0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int c_begin = split * rows_per_split;
  const int c_end = min(n, c_begin + rows_per_split);

  for (int e = tid; e < BM * k; e += kThreads) {
    list_v[e] = CUDART_INF_F;
    list_c[e] = INT_MAX;
  }
  for (int e = tid; e < BM; e += kThreads) buf_n[e] = 0;

  // this thread's rows of the tile: wm·16·MF + 16·i + g + 8·h
  float qnr[MF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = q0 + wm * 16 * MF + 16 * i + g + 8 * h;
      qnr[i][h] = (METRIC != 2 && qi < m) ? qn[qi] : 0.f;
    }
  }

  const int total = (c_end - c_begin + BN - 1) / BN * nk;

  // stage s: corpus tile s / nk, dimensions [32·(s % nk), +32), in ring
  // slot s % ns (with the query tile's same dimensions unless resident)
  // (with a tile's first stage, its columns' norms and penalties, into
  // side buffer tile % 4: a load runs at most two stages ahead)
  auto load = [&](int s) {
    const int tile = s / nk;
    const int k0 = (s - tile * nk) * BK;
    const int c0 = c_begin + tile * BN;
    float* st = ring + (s % ns) * stage;
    if (!a_res) {
      copy_block<BM>(st, q, q0, m, k0, d, vec, tid);
      st += BM * BK;
    }
    copy_block<BN>(st, data, c0, c_end, k0, d, vec, tid);
    if (k0 == 0) {
      const int c = tid & (BN - 1);
      const float* src = tid < BN ? dn : pen;
      if (src != nullptr) {
        cp_async4(sides + (tile & 3) * 2 * BN + tid,
                  c0 + c < c_end ? src + c0 + c : src, c0 + c < c_end);
      }
    }
  };

  float acc[MF][4][4];
#pragma unroll
  for (int i = 0; i < MF; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  if (a_res) {
    for (int kc = 0; kc < nk; ++kc) {
      copy_block<BM>(a_tile + kc * BM * BK, q, q0, m, kc * BK, d, vec, tid);
    }
    cp_async_commit();
  }
  for (int s = 0; s < ns - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  if (a_res == 2) {  // the query tile landed: split it once
    cp_async_wait_stage(ns);
    __syncthreads();
    float* a_lo = a_tile + nk * BM * BK;
    for (int e = tid; e < nk * BM * BK; e += kThreads) {
      unsigned hi, lo;
      split_tf32(a_tile[e], hi, lo);
      a_tile[e] = __uint_as_float(hi);
      a_lo[e] = __uint_as_float(lo);
    }
  }
  // each lane's row and 16-byte chunk in the ldmatrix blocks: A blocks
  // (rows +0/+8) x (dims +0/+4), B blocks (j-block +0/+1) x (dims +0/+4)
  const int lr = lane & 7, lq = lane >> 3;
  const int a_row = wm * 16 * MF + lr + 8 * (lq & 1), a_chunk = lq >> 1;
  const int b_row = wn * 32 + lr + 8 * (lq >> 1), b_chunk = lq & 1;
  for (int s = 0; s < total; ++s) {
    if (s + ns - 1 < total) load(s + ns - 1);
    cp_async_commit();
    cp_async_wait_stage(ns);  // stage s (and the query tile) landed
    __syncthreads();
    const float* st = ring + (s % ns) * stage;
    const float* As = a_res ? a_tile + (s % nk) * BM * BK : st;
    const float* Bs = a_res ? st : st + BM * BK;
    // two 8-dimension steps at a time: the tensor core truncates the f32
    // sums it forms, so the 16 dimensions' six products are summed in a
    // fresh accumulator, small ones first, and join the dot by a rounded
    // add
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
            split_tf32(__uint_as_float(raw[w]), bh[u][2 * jp + (w >> 1)][w & 1],
                       bl[u][2 * jp + (w >> 1)][w & 1]);
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
          if (a_res == 2) {
            ldsm_x4(ah[u], As + off);
            ldsm_x4(al[u], As + nk * BM * BK + off);
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
          mma_tf32(t, ah[0], bl[0][j]);
          mma_tf32(t, al[1], bh[1][j]);
          mma_tf32(t, ah[1], bl[1][j]);
          mma_tf32(t, ah[0], bh[0][j]);
          mma_tf32(t, ah[1], bh[1][j]);
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += t[e];
        }
      }
    }
    __syncthreads();  // slot s % ns is read before a load overwrites it
    if (s % nk != nk - 1) continue;

    // ---- the tile's dots are complete: select from the fragments ----
    const int tile = s / nk;
    const int c0 = c_begin + tile * BN;
    const float* side = sides + (tile & 3) * 2 * BN;
    float dnc[4][2], penc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int lc = wn * 32 + 8 * j + 2 * t4 + e1;
        dnc[j][e1] = METRIC != 2 ? side[lc] : 0.f;
        penc[j][e1] = c0 + lc >= c_end ? CUDART_INF_F
                      : pen != nullptr ? side[BN + lc] : 0.f;
      }
    }
    float tv[MF][2];
    int tc[MF][2];
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tv[i][h] = list_v[(wm * 16 * MF + 16 * i + g + 8 * h) * k + k - 1];
      }
    }
    // the dots become distances in place, and each is offered at once;
    // fragment value (i, j, e) sits at row 16·i + g + 8·(e / 2), column
    // 8·j + 2·t4 + e % 2. What finds its buffer full stays pending. (Rows
    // past m hold zero queries; their lists are never written out.)
    Pending<MF> pend = 0;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, e1 = e & 1;
          const int r = wm * 16 * MF + 16 * i + g + 8 * h;
          const int col = c0 + wn * 32 + 8 * j + 2 * t4 + e1;
          const float dot = acc[i][j][e];
          float dist;
          if (METRIC == 0) {
            dist = fmaxf(__fsub_rn(__fadd_rn(qnr[i][h], dnc[j][e1]),
                                   __fmul_rn(2.f, dot)),
                         0.f);
          } else if (METRIC == 1) {
            dist = __fsub_rn(
                1.f, __fdiv_rn(dot, fmaxf(__fmul_rn(qnr[i][h], dnc[j][e1]),
                                          1e-30f)));
          } else {
            dist = -dot;
          }
          dist = __fadd_rn(dist, penc[j][e1]);
          acc[i][j][e] = dist;
          // every listed column precedes this tile's, so a key equal to
          // the k-th is never before it here; the k-th of a short list
          // is +inf
          if (dist < tv[i][h]) {
            const int slot = atomicAdd(&buf_n[r], 1);
            if (slot < CAP) {
              buf_v[r * CAP + slot] = dist;
              buf_c[r * CAP + slot] = col;
            } else {
              pend |= (Pending<MF>)1 << ((i * 4 + j) * 4 + e);
            }
          }
        }
      }
    }
    // while some candidate found its buffer full: fold the full buffers
    // and offer the pending candidates again, against the new k-th keys
    while (__syncthreads_or(pend != 0)) {
      for (int r = warp; r < BM; r += kThreads / 32) {
        if (buf_n[r] >= CAP) {
          fold_row<R, CAP>(list_v, list_c, buf_v, buf_c, buf_n, r, CAP, k,
                           lane);
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
            const int col = c0 + wn * 32 + 8 * j + 2 * t4 + (e & 1);
            const float dist = acc[i][j][e];
            if (key_less(dist, col, tv[i][h], tc[i][h])) {
              const int slot = atomicAdd(&buf_n[r], 1);
              if (slot >= CAP) continue;  // still pending
              buf_v[r * CAP + slot] = dist;
              buf_c[r * CAP + slot] = col;
            }
            pend &= ~bit;
          }
        }
      }
    }

#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // fold what is left, then write each query's list: warp w owns rows
  // w, w + 8, ...
  const size_t stride = (size_t)gridDim.y * k;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int nb = buf_n[r];
    if (nb > 0) {
      fold_row<R, CAP>(list_v, list_c, buf_v, buf_c, buf_n, r, nb, k, lane);
    }
    __syncwarp();
    const int qi = q0 + r;
    if (qi >= m) continue;
    for (int e = lane; e < k; e += 32) {
      const int c = list_c[r * k + e];
      const size_t o = (size_t)qi * stride + (size_t)split * k + e;
      out_v[o] = list_v[r * k + e];
      out_i[o] = c == INT_MAX ? -1 : c;
    }
  }
}

// A launch's shape: the kernel, its shared memory, the queries a block,
// whether the query tile stays resident and the ring's stages.
struct Plan {
  const void* kern;
  size_t smem;
  int bm, a_res, ns;
};

// The first form that fits the block's shared memory, in order: the query
// tile resident split into its TF32 parts, then resident as it is, then
// streamed, each with a 3-stage ring and then a 2-stage one.
template <int MF, int R, int CAP, int METRIC>
cudaError_t prepare(int k, int d, Plan* p) {
  constexpr int BM = 32 * MF;
  const size_t nk = (d + BK - 1) / BK;
  const size_t lists = (sizeof(float) + sizeof(int)) * (size_t)BM * (k + CAP) +
                       sizeof(int) * (size_t)BM + sizeof(float) * 4 * 2 * BN;
  const size_t limit = 232448;  // a block's shared memory on sm_90
  p->kern = (const void*)fused_knn_kernel<MF, R, CAP, METRIC>;
  p->bm = BM;
  p->smem = 0;
  for (int a_res = 2; a_res >= 0 && p->smem == 0; --a_res) {
    for (int ns = 3; ns >= 2; --ns) {
      const size_t bytes = sizeof(float) * BK *
                               (a_res * nk * BM +
                                (size_t)ns * ((a_res ? 0 : BM) + BN)) +
                           lists;
      if (bytes <= limit) {
        p->smem = bytes;
        p->a_res = a_res;
        p->ns = ns;
        break;
      }
    }
  }
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

template <int METRIC>
cudaError_t plan_metric(int k, int d, Plan* p) {
  if (k <= 32) return prepare<4, 1, 32, METRIC>(k, d, p);
  if (k <= 64) return prepare<4, 2, 64, METRIC>(k, d, p);
  if (k <= 128) return prepare<2, 4, 128, METRIC>(k, d, p);
  return prepare<2, 8, 64, METRIC>(k, d, p);
}

// By k: 128 queries a block and a buffer of the queue's C keys up to
// k = 64; 64 queries above (the k-lists' shared memory), with 128 keys up
// to k = 128 and 64 up to 256.
cudaError_t plan_for(int k, int d, int metric, Plan* p) {
  if (metric == 0) return plan_metric<0>(k, d, p);
  if (metric == 1) return plan_metric<1>(k, d, p);
  return plan_metric<2>(k, d, p);
}

}  // namespace

// How many K2 blocks for (k, d, metric) the card `device` keeps resident
// at once (the wrapper splits the corpus by it); a negative CUDA error
// code on failure.
extern "C" int raft_fused_knn_slots(int k, int d, int metric, int device) {
  if (k < 1 || k > 256 || d < 1) return -(int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  Plan p;
  int per_sm = 0, sms = 0;
  err = plan_for(k, d, metric, &p);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kern,
                                                      kThreads, p.smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// metric: 0 = squared L2 (qn, dn squared norms), 1 = cosine (qn, dn
// norms), 2 = inner product (-dot; qn, dn unused). pen may be null.
// 1 <= k <= 256; each split's rows_per_split is a multiple of 128, and
// splits·rows_per_split >= n.
extern "C" int raft_fused_knn(const void* q, const void* qn, const void* data,
                              const void* dn, const void* pen, int m, int n,
                              int d, int k, int metric, int splits,
                              int rows_per_split, void* out_v, void* out_i,
                              void* stream) {
  if (k < 1 || k > 256 || d < 1 || splits < 1 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < n ||
      (long long)(splits - 1) * rows_per_split >= n) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return 0;
  const int vec = d % 4 == 0 && (uintptr_t)q % 16 == 0 &&
                  (uintptr_t)data % 16 == 0;
  Plan p;
  cudaError_t err = plan_for(k, d, metric, &p);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&q,     (void*)&qn,   (void*)&data,
                  (void*)&dn,    (void*)&pen,  (void*)&m,
                  (void*)&n,     (void*)&d,    (void*)&k,
                  (void*)&rows_per_split,      (void*)&vec,
                  (void*)&p.a_res, (void*)&p.ns, (void*)&out_v,
                  (void*)&out_i};
  err = cudaLaunchKernel(p.kern, dim3((m + p.bm - 1) / p.bm, splits),
                         dim3(kThreads), args, p.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
