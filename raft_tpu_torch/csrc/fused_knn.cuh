// K2 — query x corpus distance fused with a running per-query top-k.
//
// Replaces the TPU kernel raft_tpu/ops/fused_knn.py::_fused_knn_padded
// (kernel _kernel): the distance block of a (query tile, corpus tile) pair
// on the MXU at precision "highest" (a multi-pass f32 emulation), a
// running k-best in VMEM scratch, ties by (value, smallest global column),
// ids = -1 on +inf slots, the filter as an additive penalty row.
//
// Design on Hopper. The distance block goes through the tensor cores at
// f32 accuracy as 3xTF32 (hi/lo TF32 parts; the six m16n8k8 mma.sync
// products of 16 dimensions go into a fresh accumulator joined by a
// rounded add;
// integer-valued inputs below 2^11 give exact dots), with the ldmatrix
// fragments, cp.async copies and fragment selection of tf32_tile.cuh,
// which the grouped forms of K3 and K4 share.
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
//
// The store forms (template parameter S; one translation unit a store,
// fused_knn{,_bfloat16,_int8,_uint8,_int4}.cu, so that their builds run in
// parallel) replace the store modes of the same TPU kernel: the corpus is
// bf16, int8 or uint8 (n, d), or int4 (n, d / 2) split-half nibbles, where
// d is then the query's padded width 2·half_p. Its tiles are staged as the
// stored bytes (copy_stage) and each warp builds its B fragments from the
// stage in registers (tf32_tile.cuh, "K2's store forms"): the byte stores
// widen exactly by a prmt into the mantissa of 2^23 (int8, uint8, int4
// nibbles: integers exact in TF32), so a pair's dot is 2xTF32 (the f32
// query's hi and lo parts against the row); the bf16 store runs bf16
// m16n8k16 products against a bf16 copy of the query tile (the wrapper
// rounds the query to bf16 first, as the TPU kernel does, so every
// product is exact). No widened tile, no pass and no barrier of its own:
// a stage costs two barriers, as the f32 form's. An int4 stage of
// 32 dimensions reads 32 bytes, the low nibbles of bytes [c, c + 32) for
// dimensions [c, c + 32) of the low half and the high nibbles for
// [half_p + c, half_p + c + 32); the query's two halves sit at those
// dimensions, so one accumulator sums the low half's dims and then the
// high half's. The per-row scale (int8, int4, and any store given
// scales) multiplies the finished dot before the distance formula and
// the selection; it never multiplies a partial sum. The store forms'
// bound is the product count: 2 TF32 products (1 bf16 product for bf16)
// of 2·m·n·d operations each; the corpus bytes fall with the store.
//
// Past k = 256 (fused_knn_wide_kernel, raft_fused_knn_wide): the k-lists
// would take BM·k·8 bytes of shared memory (128 KB at 64 queries and
// k = 256), so the wide form keeps none. The tile loop, its products and
// its distances are the same code with MF = 2 (64 queries a block), so a
// distance is the same bits in both forms. Each (query, split) owns a
// candidate buffer of cap keys (a value and its column) in device memory,
// the wrapper's scratch, and each query a bound in shared memory, the
// end of the bucket of its k-th key so far (list_select.cuh's 64-bit
// keys: order bits, column, -0.0 flag). A finished tile's distances
// below their query's bound go to its buffer: the four threads that hold
// a query's fragment values take their slots by one shared atomic. A
// tile offers at most 128 keys a query, so a buffer past cap - 128 keys
// is shrunk before the next tile (one warp a query: the radix passes of
// list_select.cuh find the bucket of its k-th key, the buffer keeps that
// bucket and the keys below it, at most cap - 128, compacted in place,
// and the bound becomes the bucket's end). A split holds hundreds of k
// rows, so after the first tiles almost every distance is turned away by
// one compare, as in the plans below 256. At the split's end the buffer
// is selected in rounds (list_select.cuh::select_rounds) into the split's
// k columns, sorted by (value, column), and K1 merges the splits as
// below. The bound is strict, ties are broken by the column inside the
// key, and a buffer's keys are unique, so the result is the same bits
// whatever the order of the atomics. Its bound on this card is the
// k-list plans' (the 3xTF32 products); the buffers add at most
// m·splits·cap·8 bytes of writes and their shrinks' reads, and the
// split plan (ops/fused_knn.py::split_plan) keeps splits·k small beside
// the corpus, so that the offers stay rare.
#pragma once

#include "list_select.cuh"
#include "tf32_tile.cuh"

namespace {

template <int MF, int R, int CAP, int METRIC, int S>
__global__ void __launch_bounds__(kThreads, 1)
fused_knn_kernel(const float* __restrict__ q, const float* __restrict__ qn,
                 const void* __restrict__ data,
                 const float* __restrict__ dn,
                 const float* __restrict__ pen,
                 const float* __restrict__ scales, int m, int n, int d,
                 int k, int rows_per_split, int vec, int a_res, int ns,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int BM = 32 * MF;
  constexpr bool RAW = S != kF32;       // rows staged as stored bytes
  constexpr bool BF = S == kBF16;       // bf16 products
  constexpr int NSIDE = RAW ? 3 : 2;    // (dn, pen[, scale]) a column
  const int nk = (d + BK - 1) / BK;
  const int dw = S == kI4 ? d / 2 : d;  // a stored row's elements
  // the query tile: resident (nk blocks of BM x 32, loaded once) or a part
  // of every ring stage; then ns ring stages of the corpus tile
  // a_res: 0 the query tile streams through the ring beside the corpus
  // tile; 1 it stays in shared memory (bf16 store: as bf16); 2 it stays
  // there split once into its TF32 hi and lo parts (two arrays)
  const int a_bytes = a_res == 0 ? 0
                      : BF       ? nk * BM * BK * 2
                                 : a_res * nk * BM * BK * 4;
  const int stage = (a_res ? 0 : BM * BK * 4) + BN * BK * store_bytes<S>();
  extern __shared__ __align__(16) float smem[];
  float* a_tile = smem;
  unsigned char* ring = (unsigned char*)smem + a_bytes;
  float* sides = (float*)(ring + ns * stage);  // 4 x (dn, pen[, scale])
  float* list_v = sides + 4 * NSIDE * BN;   // BM x k sorted keys
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
    unsigned char* st = ring + (s % ns) * stage;
    if (!a_res) {
      copy_block<BM>((float*)st, q, q0, m, k0, d, vec & 1, tid);
      st += BM * BK * 4;
    }
    if constexpr (RAW) {
      copy_stage<S, BN>(st, data, c0, c_end, k0 % dw, dw, vec >> 1, tid);
    } else {
      copy_block<BN>((float*)st, (const float*)data, c0, c_end, k0, d,
                     vec & 1, tid);
    }
    if (k0 == 0) {
      const int c = tid & (BN - 1);
      const bool ok = c0 + c < c_end;
      const float* src = tid < BN ? dn : pen;
      float* side = sides + (tile & 3) * NSIDE * BN;
      if (src != nullptr) {
        cp_async4(side + tid, ok ? src + c0 + c : src, ok);
      }
      if (RAW && scales != nullptr && tid < BN) {
        cp_async4(side + 2 * BN + tid, ok ? scales + c0 + c : scales, ok);
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

  if constexpr (BF) {  // read before the loop's first barrier
    if (a_res) {
      bf16_tile<BM>((unsigned char*)a_tile, q, q0, m, d, nk, vec & 1, tid);
    }
  } else if (a_res) {
    for (int kc = 0; kc < nk; ++kc) {
      copy_block<BM>(a_tile + kc * BM * BK, q, q0, m, kc * BK, d, vec & 1,
                     tid);
    }
    cp_async_commit();
  }
  for (int s = 0; s < ns - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  if (!BF && a_res == 2) {  // the query tile landed: split it once
    cp_async_wait_stage(ns);
    __syncthreads();
    split_tile(a_tile, nk * BM * BK, tid);
  }
  for (int s = 0; s < total; ++s) {
    if (s + ns - 1 < total) load(s + ns - 1);
    cp_async_commit();
    cp_async_wait_stage(ns);  // stage s (and the query tile) landed
    __syncthreads();
    const unsigned char* st = ring + (s % ns) * stage;
    const float* As = a_res ? a_tile + (s % nk) * BM * BK : (const float*)st;
    const unsigned char* Bst = a_res ? st : st + BM * BK * 4;
    if constexpr (!RAW) {
      stage_dots<MF>(acc, As, a_res == 2 ? As + nk * BM * BK : nullptr,
                     (const float*)Bst, false, lane, wm, wn);
    } else if constexpr (BF) {  // the query tile is bf16 when resident
      stage_dots_bf16<MF>(
          acc,
          a_res ? (const unsigned char*)a_tile + (s % nk) * BM * BK * 2
                : nullptr,
          (const float*)st, Bst, lane, wm, wn);
    } else {
      stage_dots_bytes<MF, S>(acc, As,
                              a_res == 2 ? As + nk * BM * BK : nullptr, Bst,
                              S == kI4 && (s % nk) * BK >= dw, lane, wm, wn);
    }
    __syncthreads();  // slot s % ns is read before a load overwrites it
    if (s % nk != nk - 1) continue;

    // ---- the tile's dots are complete: select from the fragments ----
    const int tile = s / nk;
    const int c0 = c_begin + tile * BN;
    const float* side = sides + (tile & 3) * NSIDE * BN;
    float dnc[4][2], penc[4][2], scc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int lc = wn * 32 + 8 * j + 2 * t4 + e1;
        dnc[j][e1] = METRIC != 2 ? side[lc] : 0.f;
        penc[j][e1] = c0 + lc >= c_end ? CUDART_INF_F
                      : pen != nullptr ? side[BN + lc] : 0.f;
        scc[j][e1] = RAW && scales != nullptr ? side[2 * BN + lc] : 1.f;
      }
    }
    // the dots become distances in place; fragment value (i, j, e) sits
    // at row 16·i + g + 8·(e / 2), column 8·j + 2·t4 + e % 2 of the
    // warp's piece. (Rows past m hold zero queries; their lists are never
    // written out.)
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, e1 = e & 1;
          // q·(s·v) = s·(q·v): the scale meets the whole dot
          const float dot = RAW && scales != nullptr
                                ? __fmul_rn(acc[i][j][e], scc[j][e1])
                                : acc[i][j][e];
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
          acc[i][j][e] = __fadd_rn(dist, penc[j][e1]);
        }
      }
    }
    offer_tile<MF, R, CAP>(acc, nullptr, c0 + wn * 32 + 2 * t4, list_v,
                           list_c, buf_v, buf_c, buf_n, k, lane, warp, wm,
                           g);

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

// ---- the wide form: past k = 256 ----
//
// Its own kernel beside fused_knn_kernel, whose tile loop and epilogue it
// repeats, so that the k-list plans compile as before (one template over
// both plans changed K4's narrow register allocation and cost it 2.4%;
// ivf_pq_scan.cu).
constexpr int kWideMF = 2;  // 64 queries a block
constexpr size_t kWideSel = (kThreads / 32) * lsel::kWarpBytes;

template <int METRIC, int S>
__global__ void __launch_bounds__(kThreads, 1)
fused_knn_wide_kernel(const float* __restrict__ q,
                      const float* __restrict__ qn,
                      const void* __restrict__ data,
                      const float* __restrict__ dn,
                      const float* __restrict__ pen,
                      const float* __restrict__ scales, int m, int n, int d,
                      int k, int rows_per_split, int vec, int a_res, int ns,
                      int cap, float* __restrict__ buf_v,
                      int* __restrict__ buf_c, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  constexpr int MF = kWideMF;
  constexpr int BM = 32 * MF;
  constexpr bool RAW = S != kF32;       // rows staged as stored bytes
  constexpr bool BF = S == kBF16;       // bf16 products
  constexpr int NSIDE = RAW ? 3 : 2;    // (dn, pen[, scale]) a column
  const int nk = (d + BK - 1) / BK;
  const int dw = S == kI4 ? d / 2 : d;  // a stored row's elements
  // the query tile and the ns ring stages as fused_knn_kernel's; the
  // warps' selection space takes their place once the tiles are done
  const int a_bytes = a_res == 0 ? 0
                      : BF       ? nk * BM * BK * 2
                                 : a_res * nk * BM * BK * 4;
  const int stage = (a_res ? 0 : BM * BK * 4) + BN * BK * store_bytes<S>();
  const int tile_bytes = max(a_bytes + ns * stage, (int)kWideSel);
  extern __shared__ __align__(16) float smem[];
  float* a_tile = smem;
  unsigned char* ring = (unsigned char*)smem + a_bytes;
  // 4 x (dn, pen[, scale])
  float* sides = (float*)((unsigned char*)smem + tile_bytes);
  lsel::Key64* thr = (lsel::Key64*)(sides + 4 * NSIDE * BN);  // BM bounds
  int* cnt = (int*)(thr + BM);                                 // BM counts
  unsigned* hist = (unsigned*)(cnt + BM);  // a warp's kBins for its shrinks

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
  // query q0 + r's buffer in this split
  auto buffer = [&](int r) {
    return ((size_t)(q0 + r) * gridDim.y + split) * cap;
  };

  // rows past m take nothing (a bound below every key)
  for (int r = tid; r < BM; r += kThreads) {
    thr[r] = q0 + r < m ? lsel::kNone64 : 0ull;
    cnt[r] = 0;
  }

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

  // stage s: as fused_knn_kernel's
  auto load = [&](int s) {
    const int tile = s / nk;
    const int k0 = (s - tile * nk) * BK;
    const int c0 = c_begin + tile * BN;
    unsigned char* st = ring + (s % ns) * stage;
    if (!a_res) {
      copy_block<BM>((float*)st, q, q0, m, k0, d, vec & 1, tid);
      st += BM * BK * 4;
    }
    if constexpr (RAW) {
      copy_stage<S, BN>(st, data, c0, c_end, k0 % dw, dw, vec >> 1, tid);
    } else {
      copy_block<BN>((float*)st, (const float*)data, c0, c_end, k0, d,
                     vec & 1, tid);
    }
    if (k0 == 0) {
      const int c = tid & (BN - 1);
      const bool ok = c0 + c < c_end;
      const float* src = tid < BN ? dn : pen;
      float* side = sides + (tile & 3) * NSIDE * BN;
      if (src != nullptr) {
        cp_async4(side + tid, ok ? src + c0 + c : src, ok);
      }
      if (RAW && scales != nullptr && tid < BN) {
        cp_async4(side + 2 * BN + tid, ok ? scales + c0 + c : scales, ok);
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

  if constexpr (BF) {  // read before the loop's first barrier
    if (a_res) {
      bf16_tile<BM>((unsigned char*)a_tile, q, q0, m, d, nk, vec & 1, tid);
    }
  } else if (a_res) {
    for (int kc = 0; kc < nk; ++kc) {
      copy_block<BM>(a_tile + kc * BM * BK, q, q0, m, kc * BK, d, vec & 1,
                     tid);
    }
    cp_async_commit();
  }
  for (int s = 0; s < ns - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  if (!BF && a_res == 2) {  // the query tile landed: split it once
    cp_async_wait_stage(ns);
    __syncthreads();
    split_tile(a_tile, nk * BM * BK, tid);
  }
  for (int s = 0; s < total; ++s) {
    if (s + ns - 1 < total) load(s + ns - 1);
    cp_async_commit();
    cp_async_wait_stage(ns);  // stage s (and the query tile) landed
    __syncthreads();
    const unsigned char* st = ring + (s % ns) * stage;
    const float* As = a_res ? a_tile + (s % nk) * BM * BK : (const float*)st;
    const unsigned char* Bst = a_res ? st : st + BM * BK * 4;
    if constexpr (!RAW) {
      stage_dots<MF>(acc, As, a_res == 2 ? As + nk * BM * BK : nullptr,
                     (const float*)Bst, false, lane, wm, wn);
    } else if constexpr (BF) {  // the query tile is bf16 when resident
      stage_dots_bf16<MF>(
          acc,
          a_res ? (const unsigned char*)a_tile + (s % nk) * BM * BK * 2
                : nullptr,
          (const float*)st, Bst, lane, wm, wn);
    } else {
      stage_dots_bytes<MF, S>(acc, As,
                              a_res == 2 ? As + nk * BM * BK : nullptr, Bst,
                              S == kI4 && (s % nk) * BK >= dw, lane, wm, wn);
    }
    __syncthreads();  // slot s % ns is read before a load overwrites it
    if (s % nk != nk - 1) continue;

    // ---- the tile's dots are complete: offer them to the buffers ----
    const int tile = s / nk;
    const int c0 = c_begin + tile * BN;
    const float* side = sides + (tile & 3) * NSIDE * BN;
    float dnc[4][2], penc[4][2], scc[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int lc = wn * 32 + 8 * j + 2 * t4 + e1;
        dnc[j][e1] = METRIC != 2 ? side[lc] : 0.f;
        penc[j][e1] = c0 + lc >= c_end ? CUDART_INF_F
                      : pen != nullptr ? side[BN + lc] : 0.f;
        scc[j][e1] = RAW && scales != nullptr ? side[2 * BN + lc] : 1.f;
      }
    }
    // the distances as fused_knn_kernel's, bit for bit
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int h = e >> 1, e1 = e & 1;
          const float dot = RAW && scales != nullptr
                                ? __fmul_rn(acc[i][j][e], scc[j][e1])
                                : acc[i][j][e];
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
          acc[i][j][e] = __fadd_rn(dist, penc[j][e1]);
        }
      }
    }
    // a query's 32 values of this warp sit with the four threads of its
    // row group: their keys below the bound take slots of the buffer by
    // one atomic, in the threads' order
    const int col0 = c0 + wn * 32 + 2 * t4;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 * MF + 16 * i + g + 8 * h;
        const lsel::Key64 bound = thr[r];
        unsigned take = 0u;
        int mine = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const float v = acc[i][j][2 * h + e1];
            const unsigned ok = lsel::order_key(v);
            const lsel::Key64 key =
                ((lsel::Key64)ok << 32) |
                ((unsigned)(col0 + 8 * j + e1) << 1) |
                (__float_as_uint(v) == 0x80000000u ? 1u : 0u);
            if (ok != lsel::kNone && key < bound) {
              take |= 1u << (2 * j + e1);
              ++mine;
            }
          }
        }
        int incl = mine;
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          const int y = __shfl_up_sync(RAFT_FULL_MASK, incl, off, 4);
          if (t4 >= off) incl += y;
        }
        const int quad = __shfl_sync(RAFT_FULL_MASK, incl, 3, 4);
        int base = 0;
        if (t4 == 3 && quad > 0) base = atomicAdd(&cnt[r], quad);
        base = __shfl_sync(RAFT_FULL_MASK, base, 3, 4);
        if (take != 0u) {
          const size_t b = buffer(r) + base + incl - mine;
          int o = 0;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              if (take & (1u << (2 * j + e1))) {
                buf_v[b + o] = acc[i][j][2 * h + e1];
                buf_c[b + o] = col0 + 8 * j + e1;
                ++o;
              }
            }
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
    // every buffer keeps room for the next tile's 128 keys a query
    __syncthreads();
    for (int r = warp; r < BM; r += kThreads / 32) {
      const int held = cnt[r];
      if (held > cap - BN) {
        const size_t b = buffer(r);
        lsel::Key64 bound;
        const int kept =
            lsel::shrink_buffer(buf_v + b, buf_c + b, held, k, cap - BN,
                                hist + warp * lsel::kBins, bound, lane);
        if (lane == 0) {
          cnt[r] = kept;
          thr[r] = bound;
        }
        __syncwarp();
      }
    }
  }

  // the split is done: each query's buffer, selected in rounds, to the
  // split's k columns; warp w owns rows w, w + 8, ...
  __syncthreads();
  unsigned char* ws =
      reinterpret_cast<unsigned char*>(smem) + warp * lsel::kWarpBytes;
  const size_t stride = (size_t)gridDim.y * k;
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int qi = q0 + r;
    if (qi >= m) continue;
    const size_t b = buffer(r);
    float* ov = out_v + (size_t)qi * stride + (size_t)split * k;
    int* oi = out_i + (size_t)qi * stride + (size_t)split * k;
    lsel::select_rounds(
        lsel::BufferKeys{buf_v + b, buf_c + b}, cnt[r], k, ws,
        [&](int e, lsel::Key64 key) {
          ov[e] = lsel::buffer_value(key);
          oi[e] = lsel::buffer_column(key);
        },
        [&](int e) {
          ov[e] = CUDART_INF_F;
          oi[e] = -1;
        },
        lane);
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
template <int MF, int R, int CAP, int METRIC, int S>
cudaError_t prepare(int k, int d, Plan* p) {
  constexpr int BM = 32 * MF;
  constexpr bool RAW = S != kF32;
  p->kern = (const void*)fused_knn_kernel<MF, R, CAP, METRIC, S>;
  p->bm = BM;
  // the bf16 store keeps a bf16 copy of the query tile (a_res 1 or 0)
  p->smem = fit_tiles(BM, d, 3,
                      list_bytes(BM, k, CAP) +
                          sizeof(float) * 4 * (RAW ? 3 : 2) * BN,
                      &p->a_res, &p->ns, (size_t)store_bytes<S>() * BK * BN,
                      S == kBF16 ? 1 : 2, S == kBF16 ? 2 : sizeof(float));
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

// The wide form's shape: the tiles (the first layout, query tile split,
// resident or streamed, 3 ring stages then 2, that fits) share their
// space with the warps' selection space, whichever is larger; then the
// side buffers, the queries' bounds and counts, and each warp's histogram
// for its shrinks.
template <int METRIC, int S>
cudaError_t prepare_wide(int d, Plan* p) {
  constexpr int BM = 32 * kWideMF;
  constexpr bool RAW = S != kF32;
  constexpr bool BF = S == kBF16;
  const size_t nk = (d + BK - 1) / BK;
  const size_t b_stage = (size_t)store_bytes<S>() * BK * BN;
  const size_t a_elem = BF ? 2 : sizeof(float);
  const size_t fixed = sizeof(float) * 4 * (RAW ? 3 : 2) * BN +
                       (sizeof(lsel::Key64) + sizeof(int)) * BM +
                       sizeof(unsigned) * (kThreads / 32) * lsel::kBins;
  p->kern = (const void*)fused_knn_wide_kernel<METRIC, S>;
  p->bm = BM;
  p->smem = 0;
  for (int a = BF ? 1 : 2; a >= 0 && p->smem == 0; --a) {
    for (int ns = 3; ns >= 2 && p->smem == 0; --ns) {
      size_t tiles = a_elem * BK * a * nk * BM +
                     ns * (sizeof(float) * BK * (a ? 0 : BM) + b_stage);
      if (tiles < kWideSel) tiles = kWideSel;
      if (tiles + fixed <= kSmemLimit) {
        p->smem = tiles + fixed;
        p->a_res = a;
        p->ns = ns;
      }
    }
  }
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

template <int METRIC, int S>
cudaError_t plan_metric(int k, int d, Plan* p) {
  if (k <= 32) return prepare<4, 1, 32, METRIC, S>(k, d, p);
  if (k <= 64) return prepare<4, 2, 64, METRIC, S>(k, d, p);
  if (k <= 128) return prepare<2, 4, 128, METRIC, S>(k, d, p);
  if (k <= 256) return prepare<2, 8, 64, METRIC, S>(k, d, p);
  return prepare_wide<METRIC, S>(d, p);
}

// By k: 128 queries a block and a buffer of the queue's C keys up to
// k = 64; 64 queries above (the k-lists' shared memory), with 128 keys up
// to k = 128 and 64 up to 256; past 256 the wide form, 64 queries.
template <int S>
cudaError_t plan_for(int k, int d, int metric, Plan* p) {
  if (metric == 0) return plan_metric<0, S>(k, d, p);
  if (metric == 1) return plan_metric<1, S>(k, d, p);
  return plan_metric<2, S>(k, d, p);
}

// How many K2 blocks for (k, d, metric) the card `device` keeps resident
// at once (the wrapper splits the corpus by it); a negative CUDA error
// code on failure.
template <int S>
int fused_knn_slots(int k, int d, int metric, int device) {
  if (k < 1 || d < 1 || (S == kI4 && d % 128 != 0)) {
    return -(int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  Plan p;
  int per_sm = 0, sms = 0;
  err = plan_for<S>(k, d, metric, &p);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, p.kern,
                                                      kThreads, p.smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// metric: 0 = squared L2 (qn, dn squared norms), 1 = cosine (qn, dn
// norms), 2 = inner product (-dot; qn, dn unused). pen may be null, and
// scales (a store form's per-row factors; the f32 form takes none).
// q is (m, d) f32; data (n, d) in the store (int4: (n, d / 2) bytes, d a
// multiple of 128). 1 <= k <= 256 (past it fused_knn_wide_launch); each
// split's rows_per_split is a multiple of 128, and splits·rows_per_split
// >= n.
template <int S>
int fused_knn_launch(const void* q, const void* qn, const void* data,
                     const void* dn, const void* pen, const void* scales,
                     int m, int n, int d, int k, int metric, int splits,
                     int rows_per_split, void* out_v, void* out_i,
                     void* stream) {
  if (k < 1 || k > 256 || d < 1 || splits < 1 || rows_per_split < 1 ||
      (long long)splits * rows_per_split < n ||
      (long long)(splits - 1) * rows_per_split >= n ||
      (S == kI4 && d % 128 != 0) || (S == kF32 && scales != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return 0;
  // 16-byte copies: bit 0 for the query rows, bit 1 for the stored rows
  const int row_bytes = (S == kI4 ? d / 2 : d) * store_bytes<S>();
  const int vec_q = d % 4 == 0 && (uintptr_t)q % 16 == 0;
  const int vec_d = row_bytes % 16 == 0 && (uintptr_t)data % 16 == 0;
  const int vec = S == kF32 ? (vec_q && vec_d) * 3 : vec_q | (vec_d << 1);
  Plan p;
  cudaError_t err = plan_for<S>(k, d, metric, &p);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&q,     (void*)&qn,   (void*)&data,
                  (void*)&dn,    (void*)&pen,  (void*)&scales,
                  (void*)&m,     (void*)&n,    (void*)&d,
                  (void*)&k,     (void*)&rows_per_split,
                  (void*)&vec,   (void*)&p.a_res, (void*)&p.ns,
                  (void*)&out_v, (void*)&out_i};
  err = cudaLaunchKernel(p.kern, dim3((m + p.bm - 1) / p.bm, splits),
                         dim3(kThreads), args, p.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The wide form (k > 256) with fused_knn_launch's arguments and the
// candidate buffers: scratch holds m·splits·cap floats and as many ints
// after them; cap >= k + 128.
template <int S>
int fused_knn_wide_launch(const void* q, const void* qn, const void* data,
                          const void* dn, const void* pen,
                          const void* scales, int m, int n, int d, int k,
                          int metric, int splits, int rows_per_split,
                          int cap, void* scratch, void* out_v, void* out_i,
                          void* stream) {
  if (k <= 256 || k > n || d < 1 || splits < 1 || rows_per_split < 1 ||
      cap < k + BN || scratch == nullptr ||
      (long long)splits * rows_per_split < n ||
      (long long)(splits - 1) * rows_per_split >= n ||
      (S == kI4 && d % 128 != 0) || (S == kF32 && scales != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (m == 0) return 0;
  const int row_bytes = (S == kI4 ? d / 2 : d) * store_bytes<S>();
  const int vec_q = d % 4 == 0 && (uintptr_t)q % 16 == 0;
  const int vec_d = row_bytes % 16 == 0 && (uintptr_t)data % 16 == 0;
  const int vec = S == kF32 ? (vec_q && vec_d) * 3 : vec_q | (vec_d << 1);
  Plan p;
  cudaError_t err = plan_for<S>(k, d, metric, &p);
  if (err != cudaSuccess) return (int)err;
  float* buf_v = (float*)scratch;
  int* buf_c = (int*)(buf_v + (size_t)m * splits * cap);
  void* args[] = {(void*)&q,     (void*)&qn,   (void*)&data,
                  (void*)&dn,    (void*)&pen,  (void*)&scales,
                  (void*)&m,     (void*)&n,    (void*)&d,
                  (void*)&k,     (void*)&rows_per_split,
                  (void*)&vec,   (void*)&p.a_res, (void*)&p.ns,
                  (void*)&cap,   (void*)&buf_v, (void*)&buf_c,
                  (void*)&out_v, (void*)&out_i};
  err = cudaLaunchKernel(p.kern, dim3((m + p.bm - 1) / p.bm, splits),
                         dim3(kThreads), args, p.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// One store's C entries: raft_fused_knn_slots(k, d, metric, device),
// raft_fused_knn(q, qn, data, dn, pen, scales, m, n, d, k, metric, splits,
// rows_per_split, out_v, out_i, stream) for k <= 256 and
// raft_fused_knn_wide(the same with cap and scratch before out_v) past
// it, each library built from one fused_knn*.cu that names its store.
#define RAFT_FUSED_KNN_ENTRIES(S)                                           \
  extern "C" int raft_fused_knn_slots(int k, int d, int metric,             \
                                      int device) {                         \
    return fused_knn_slots<S>(k, d, metric, device);                        \
  }                                                                         \
  extern "C" int raft_fused_knn(                                            \
      const void* q, const void* qn, const void* data, const void* dn,      \
      const void* pen, const void* scales, int m, int n, int d, int k,      \
      int metric, int splits, int rows_per_split, void* out_v,              \
      void* out_i, void* stream) {                                          \
    return fused_knn_launch<S>(q, qn, data, dn, pen, scales, m, n, d, k,    \
                               metric, splits, rows_per_split, out_v,       \
                               out_i, stream);                              \
  }                                                                         \
  extern "C" int raft_fused_knn_wide(                                       \
      const void* q, const void* qn, const void* data, const void* dn,      \
      const void* pen, const void* scales, int m, int n, int d, int k,      \
      int metric, int splits, int rows_per_split, int cap, void* scratch,   \
      void* out_v, void* out_i, void* stream) {                             \
    return fused_knn_wide_launch<S>(q, qn, data, dn, pen, scales, m, n, d,  \
                                    k, metric, splits, rows_per_split, cap, \
                                    scratch, out_v, out_i, stream);         \
  }
