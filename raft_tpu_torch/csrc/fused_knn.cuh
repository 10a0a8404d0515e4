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
// A block of 8 warps owns BM = 32·MF queries (MF = 4) and walks its split of the corpus in tiles of BN = 128 rows; the
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
// (+inf, -1) slots. The k-lists cost BM·k·8 bytes of shared memory:
// 128 queries and CAP = the queue's C (32 keys) up to k = kListMaxK (24).
// Past it the wide form below: on the H100 it beats the k-list plans on
// f32 rows from k = 32 and on int8 rows from 33 (not on bf16 rows up to
// 64), and the plans of 64 queries that took k = 65 to 256 by 17–46%
// (PERF.md).
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
// Past the k-lists (fused_knn_wide_kernel + fused_knn_wide_select,
// raft_fused_knn_wide; kListMaxK): the k-lists would take BM·k·8 bytes of
// shared memory, so the wide form keeps none. Its tile loop, products and
// distances are the k = 10 plan's (MF = 4, 128 queries a block, the
// distance bits independent of MF), so a distance is the same bits in
// every form. Each (query, split) owns a candidate buffer of cap 64-bit
// keys in device memory (list_select.cuh's buffer keys: order bits,
// column, -0.0 flag), the wrapper's scratch, and each query a bound in
// shared memory below which its distances are offered: a distance is
// compared with the bound's value, and only one equal to it builds its
// key to compare; each thread takes the slots of its keys by one shared
// atomic and writes whole keys, and a thread that fills a buffer past
// cap - 128 keys (a tile offers at most 128 a query) marks the row, so a
// tile costs one barrier. A marked buffer is shrunk before the next tile
// by the whole block, out of line (block_select.cuh: every thread's loads
// in flight at once, the buffer staged in shared memory up to 2,048 keys,
// 10-bit histograms, a block-wide scan): its keys below the bound, or the
// k best and their bucket, at most fit of them, and the bound becomes the
// end of the k-th key's bucket. That bound holds for the query's every
// split: it has k keys below it. So a shrink publishes it (atomicMin on
// the query's bound in device memory) and reads the others' first, and
// every block starts from the bound the earlier splits left: the splits
// of a query tile that run in a later wave than its first offer about k
// keys where the first offers many times that. Keys at or past a bound
// stay in a buffer until its next shrink, and no key below the final
// bound is ever dropped. After the tile loop, one block a query selects
// the k best keys below its final bound from all its splits' buffers (in
// rounds of 2,048: a radix bucket, a gather into shared memory, a
// bitonic sort) into the query's k output slots: the splits meet there,
// not in K1. The keys are unique, so the result is the same bits
// whatever the order of the atomics and of the blocks. Measured on the
// H100 (PERF.md): the 64-query tile of the form before this one cost it
// ~24 of 177 ms at k = 1,024, its offers, one warp's shrinks (each load
// waiting on the last) and per-split selections most of the rest. Its
// bound on this card is the k-list plans' (the 3xTF32 products); the
// buffers add their keys' writes and the shrinks' reads.
#pragma once

#include "block_select.cuh"
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

// ---- the wide form: past the k-lists ----
//
// Its own kernels beside fused_knn_kernel, whose tile loop and epilogue
// the first repeats, so that the k-list plans compile as before (one
// template over both plans changed K4's narrow register allocation and
// cost it 2.4%; ivf_pq_scan.cu).
// the widest k of the k-list plans (ops/fused_knn.py, LIST_MAX_K)
constexpr int kListMaxK = 24;
constexpr int kWideMF = 4;  // 128 queries a block
constexpr int kWideBM = 32 * kWideMF;
constexpr int kWideStage = 2048;  // a buffer a shrink reads into shared memory

// The wide tile loop's per-query state in shared memory: its bound and
// its buffer's count; then the rows marked for a shrink.
struct WideRows {
  lsel::Key64 thr[kWideBM];
  int cnt[kWideBM];
  unsigned need[kWideBM / 32];
};

// A (query, split)'s key (list_select.cuh's buffer key order) from a
// distance v of column col whose order bits are ok.
__device__ __forceinline__ lsel::Key64 wide_key(unsigned ok, int col,
                                                float v) {
  return ((lsel::Key64)ok << 32) | ((unsigned)col << 1) |
         (__float_as_uint(v) == 0x80000000u ? 1u : 0u);
}

// Shrink query r's buffer buf (the whole block calls it): of its keys
// below the bound (the tighter of the block's and the query's in device
// memory, bound, which the other splits tighten), keep the k best and
// their bucket (at most fit), the bound becoming the bucket's end, which
// every split of the query may then use; or, where at most fit keys lie
// below the bound, keep those. A buffer of at most kWideStage keys is
// read once, into stage (shared memory), and its passes run there. Apart
// from the tile loop (not inlined): it runs on a few tiles in a hundred.
__device__ __noinline__ void wide_shrink(lsel::Key64* buf,
                                         lsel::Key64* stage, WideRows& rows,
                                         bsel::Scratch& sel,
                                         lsel::Key64* bound, int r, int k,
                                         int fit) {
  const int held = rows.cnt[r];
  const lsel::Key64 lim = min(rows.thr[r], __ldcg(bound));
  const lsel::Key64* from = buf;
  if (held <= kWideStage) {
    for (int i0 = 0; i0 < held; i0 += bsel::kBlock * bsel::kUnroll) {
      lsel::Key64 v[bsel::kUnroll];
#pragma unroll
      for (int u = 0; u < bsel::kUnroll; ++u) {
        const int i = i0 + u * bsel::kBlock + (int)threadIdx.x;
        v[u] = i < held ? buf[i] : lsel::kNone64;
      }
#pragma unroll
      for (int u = 0; u < bsel::kUnroll; ++u) {
        const int i = i0 + u * bsel::kBlock + (int)threadIdx.x;
        if (i < held) stage[i] = v[u];
      }
    }
    __syncthreads();
    from = stage;
  }
  const bsel::Segments<bsel::OneCount> src{from, 0, 1, {held}};
  int below;
  lsel::Key64 lo, hi;
  bsel::key_range(src, 0ull, lim, sel, below, lo, hi);
  lsel::Key64 thr = lim;
  if (below > fit) {
    const bsel::Bucket b =
        bsel::find_bucket(src, 0ull, lim, lo, hi, k, fit, false, sel);
    const lsel::Key64 end = b.sh >= 64 ? 0ull : (b.pre + 1ull) << b.sh;
    if (end != 0ull && end < lim) thr = end;
  }
  const int kept = bsel::gather(
      src, buf, [&](lsel::Key64 key) { return key < thr; }, sel);
  if (threadIdx.x == 0) {
    rows.cnt[r] = kept;
    rows.thr[r] = thr;
    if (thr < lim) atomicMin(bound, thr);
  }
  __syncthreads();
}

template <int METRIC, int S>
__global__ void __launch_bounds__(kThreads, 1)
fused_knn_wide_kernel(const float* __restrict__ q,
                      const float* __restrict__ qn,
                      const void* __restrict__ data,
                      const float* __restrict__ dn,
                      const float* __restrict__ pen,
                      const float* __restrict__ scales, int m, int n, int d,
                      int k, int rows_per_split, int vec, int a_res, int ns,
                      int cap, int fit, lsel::Key64* __restrict__ keys,
                      lsel::Key64* __restrict__ bounds,
                      int* __restrict__ counts) {
  constexpr int MF = kWideMF;
  constexpr int BM = kWideBM;
  constexpr bool RAW = S != kF32;       // rows staged as stored bytes
  constexpr bool BF = S == kBF16;       // bf16 products
  constexpr int NSIDE = RAW ? 3 : 2;    // (dn, pen[, scale]) a column
  const int nk = (d + BK - 1) / BK;
  const int dw = S == kI4 ? d / 2 : d;  // a stored row's elements
  // the query tile and the ns ring stages as fused_knn_kernel's
  const int a_bytes = a_res == 0 ? 0
                      : BF       ? nk * BM * BK * 2
                                 : a_res * nk * BM * BK * 4;
  const int stage = (a_res ? 0 : BM * BK * 4) + BN * BK * store_bytes<S>();
  extern __shared__ __align__(16) float smem[];
  float* a_tile = smem;
  unsigned char* ring = (unsigned char*)smem + a_bytes;
  bsel::Scratch& sel =
      *reinterpret_cast<bsel::Scratch*>(ring + ns * stage);
  WideRows& rows = *reinterpret_cast<WideRows*>(&sel + 1);
  // 4 x (dn, pen[, scale]), then a shrink's copy of a buffer
  float* sides = reinterpret_cast<float*>(&rows + 1);
  lsel::Key64* stage_keys =
      reinterpret_cast<lsel::Key64*>(sides + 4 * NSIDE * BN);

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
    return keys + ((size_t)(q0 + r) * gridDim.y + split) * cap;
  };

  // each query starts from the bound the splits before it left (rows past
  // m take nothing: a bound below every key)
  for (int r = tid; r < BM; r += kThreads) {
    rows.thr[r] = q0 + r < m ? __ldcg(bounds + q0 + r) : 0ull;
    rows.cnt[r] = 0;
  }
  if (tid < BM / 32) rows.need[tid] = 0u;

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
    // row group: each thread's keys below the bound take slots of the
    // buffer by one atomic; a thread that fills the buffer past
    // cap - 128 keys marks the row for a shrink
    const int col0 = c0 + wn * 32 + 2 * t4;
    bool full = false;
#pragma unroll
    for (int i = 0; i < MF; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 * MF + 16 * i + g + 8 * h;
        const lsel::Key64 bound = rows.thr[r];
        // the bound's value: a distance below it is taken, one equal to it
        // where its key is below the bound (no bound: below +inf)
        const float bv = bound == lsel::kNone64
                             ? CUDART_INF_F
                             : lsel::buffer_value(bound & ~1ull);
        unsigned take = 0u, tie = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e1 = 0; e1 < 2; ++e1) {
            const float v = acc[i][j][2 * h + e1];
            take |= (v < bv ? 1u : 0u) << (2 * j + e1);
            tie |= (v == bv ? 1u : 0u) << (2 * j + e1);
          }
        }
        if (tie != 0u) {  // rare: a value equal to the bound's
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              const float v = acc[i][j][2 * h + e1];
              if ((tie >> (2 * j + e1) & 1u) && v < CUDART_INF_F &&
                  wide_key(lsel::order_key(v), col0 + 8 * j + e1, v) <
                      bound) {
                take |= 1u << (2 * j + e1);
              }
            }
          }
        }
        if (take != 0u) {
          const int mine = __popc(take);
          const int base = atomicAdd(&rows.cnt[r], mine);
          if (base + mine > cap - BN) {
            atomicOr(&rows.need[r >> 5], 1u << (r & 31));
            full = true;
          }
          lsel::Key64* out = buffer(r) + base;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e1 = 0; e1 < 2; ++e1) {
              if (take & (1u << (2 * j + e1))) {
                const float v = acc[i][j][2 * h + e1];
                *out++ = wide_key(lsel::order_key(v), col0 + 8 * j + e1, v);
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
    // every buffer keeps room for the next tile's 128 keys a query: the
    // marked rows are shrunk, one at a time by the block
    if (__syncthreads_or(full)) {
      unsigned marked[BM / 32];
#pragma unroll
      for (int w = 0; w < BM / 32; ++w) marked[w] = rows.need[w];
      __syncthreads();  // every thread has the marks before they clear
      if (tid < BM / 32) rows.need[tid] = 0u;
#pragma unroll
      for (int w = 0; w < BM / 32; ++w) {
        for (unsigned left = marked[w]; left != 0u; left &= left - 1u) {
          const int r = w * 32 + __ffs(left) - 1;
          wide_shrink(buffer(r), stage_keys, rows, sel, bounds + q0 + r, r,
                      k, fit);
        }
      }
    }
  }

  // the split is done: its buffers' counts to the selection
  for (int r = tid; r < BM; r += kThreads) {
    if (q0 + r < m) counts[(size_t)(q0 + r) * gridDim.y + split] = rows.cnt[r];
  }
}

// The wide form's selection: one block a query, the k best keys below the
// query's final bound over its splits' buffers, sorted, to its k output
// slots (block_select.cuh). A key at or past the bound cannot be among the
// k best, and every key that can is in a buffer; the keys are unique, so
// this is the (value, lowest column) order of the JAX kernel.
__global__ void __launch_bounds__(bsel::kBlock)
fused_knn_wide_select(const lsel::Key64* __restrict__ keys,
                      const lsel::Key64* __restrict__ bounds,
                      const int* __restrict__ counts, int splits, int cap,
                      int k, float* __restrict__ out_v,
                      int* __restrict__ out_i) {
  __shared__ bsel::Scratch sel;
  __shared__ lsel::Key64 cand[bsel::kRound];
  const int qi = blockIdx.x;
  const int* cnt = counts + (size_t)qi * splits;
  const bsel::Segments<bsel::ManyCounts> src{
      keys + (size_t)qi * splits * cap, (size_t)cap, splits, {cnt}};
  float* ov = out_v + (size_t)qi * k;
  int* oi = out_i + (size_t)qi * k;
  bsel::select(
      src, bounds[qi], k, cand, sel,
      [&](int e, lsel::Key64 key) {
        ov[e] = lsel::buffer_value(key);
        oi[e] = lsel::buffer_column(key);
      },
      [&](int e) {
        ov[e] = CUDART_INF_F;
        oi[e] = -1;
      });
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

// The wide form's shape: the first tile layout that fits (the query tile
// split, resident or streamed, 3 ring stages then 2), then the selection
// scratch, the queries' rows and the side buffers.
template <int METRIC, int S>
cudaError_t prepare_wide(int d, Plan* p) {
  constexpr bool RAW = S != kF32;
  p->kern = (const void*)fused_knn_wide_kernel<METRIC, S>;
  p->bm = kWideBM;
  p->smem = fit_tiles(kWideBM, d, 3,
                      sizeof(bsel::Scratch) + sizeof(WideRows) +
                          sizeof(float) * 4 * (RAW ? 3 : 2) * BN +
                          sizeof(lsel::Key64) * kWideStage,
                      &p->a_res, &p->ns, (size_t)store_bytes<S>() * BK * BN,
                      S == kBF16 ? 1 : 2, S == kBF16 ? 2 : sizeof(float));
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

template <int METRIC, int S>
cudaError_t plan_metric(int k, int d, bool wide, Plan* p) {
  if (wide) return prepare_wide<METRIC, S>(d, p);
  return prepare<4, 1, 32, METRIC, S>(k, d, p);
}

// By k: 128 queries a block and a buffer of the queue's C keys up to
// kListMaxK; past it the wide form, 128 queries (wide: the wide form at
// any k).
template <int S>
cudaError_t plan_for(int k, int d, int metric, Plan* p, bool wide = false) {
  wide = wide || k > kListMaxK;
  if (metric == 0) return plan_metric<0, S>(k, d, wide, p);
  if (metric == 1) return plan_metric<1, S>(k, d, wide, p);
  return plan_metric<2, S>(k, d, wide, p);
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
// multiple of 128). 1 <= k <= kListMaxK (past it fused_knn_wide_launch); each
// split's rows_per_split is a multiple of 128, and splits·rows_per_split
// >= n.
template <int S>
int fused_knn_launch(const void* q, const void* qn, const void* data,
                     const void* dn, const void* pen, const void* scales,
                     int m, int n, int d, int k, int metric, int splits,
                     int rows_per_split, void* out_v, void* out_i,
                     void* stream) {
  if (k < 1 || k > kListMaxK || d < 1 || splits < 1 ||
      rows_per_split < 1 || (long long)splits * rows_per_split < n ||
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

// The wide form's scratch: m·splits·cap keys of 8 bytes (the candidate
// buffers), then m bounds of 8 bytes and m·splits counts of 4.
inline size_t fused_knn_wide_scratch(int m, int splits, int cap) {
  return sizeof(lsel::Key64) * ((size_t)m * splits * cap + m) +
         sizeof(int) * (size_t)m * splits;
}

// The wide form, at any 1 <= k <= n, with fused_knn_launch's arguments and
// its scratch (fused_knn_wide_scratch's bytes); cap >= k + 128. Writes
// the k best of the whole corpus to out_v, out_i (m, k): the splits'
// buffers meet in the selection, so there is nothing to merge after it.
template <int S>
int fused_knn_wide_launch(const void* q, const void* qn, const void* data,
                          const void* dn, const void* pen,
                          const void* scales, int m, int n, int d, int k,
                          int metric, int splits, int rows_per_split,
                          int cap, void* scratch, void* out_v, void* out_i,
                          void* stream) {
  if (k < 1 || k > n || d < 1 || splits < 1 || rows_per_split < 1 ||
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
  cudaError_t err = plan_for<S>(k, d, metric, &p, true);
  if (err != cudaSuccess) return (int)err;
  // a shrink keeps the k best and their bucket, at most this many keys
  const int fit = k + (cap - BN - k) / 4;
  lsel::Key64* keys = (lsel::Key64*)scratch;
  lsel::Key64* bounds = keys + (size_t)m * splits * cap;
  int* counts = (int*)(bounds + m);
  const cudaStream_t st = (cudaStream_t)stream;
  err = cudaMemsetAsync(bounds, 0xff, sizeof(lsel::Key64) * m, st);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&q,      (void*)&qn,   (void*)&data,
                  (void*)&dn,     (void*)&pen,  (void*)&scales,
                  (void*)&m,      (void*)&n,    (void*)&d,
                  (void*)&k,      (void*)&rows_per_split,
                  (void*)&vec,    (void*)&p.a_res, (void*)&p.ns,
                  (void*)&cap,    (void*)&fit,  (void*)&keys,
                  (void*)&bounds, (void*)&counts};
  err = cudaLaunchKernel(p.kern, dim3((m + p.bm - 1) / p.bm, splits),
                         dim3(kThreads), args, p.smem, st);
  if (err != cudaSuccess) return (int)err;
  fused_knn_wide_select<<<m, bsel::kBlock, 0, st>>>(
      keys, bounds, counts, splits, cap, k, (float*)out_v, (int*)out_i);
  return (int)cudaGetLastError();
}

}  // namespace

// One store's C entries: raft_fused_knn_slots(k, d, metric, device),
// raft_fused_knn(q, qn, data, dn, pen, scales, m, n, d, k, metric, splits,
// rows_per_split, out_v, out_i, stream) for k <= kListMaxK and
// raft_fused_knn_wide(the same with cap and scratch before out_v; out
// (m, k)) past it, raft_fused_knn_wide_scratch(m, splits, cap) its
// scratch's bytes, each library built from one fused_knn*.cu that names
// its store.
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
  }                                                                         \
  extern "C" size_t raft_fused_knn_wide_scratch(int m, int splits,          \
                                                int cap) {                  \
    return fused_knn_wide_scratch(m, splits, cap);                          \
  }
