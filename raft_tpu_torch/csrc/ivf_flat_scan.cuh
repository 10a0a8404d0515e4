// K3 — IVF-Flat list scan: per (query, probe) pair, the k nearest rows of
// the probed list.
//
// Replaces the TPU kernel raft_tpu/ops/ivf_scan.py::_scan_groups (kernel
// _kernel -> _kernel_body): (query, probe) pairs packed 128 to a group per
// list, so that each grid step reads its list once and scores a dense
// (group x list) block on the MXU; per-pair top-k of row ids; dead groups
// skipped; filter as an additive penalty row.
//
// Two forms: the wrapper takes the grouped one at every k
// (ops/ivf_scan.py::scan_form) and the per-pair one by name.
//
// The grouped form (its k-list plans up to k = 512, raft_ivf_flat_scan_group;
// past 512 the wide plan below) keeps the TPU kernel's
// grouping. The wrapper packs the pairs by list (pack_pairs: one stable sort of
// the pairs' list ids; each list's pairs cut into group tiles of BM = 128
// queries for k <= 64, 64 up to 256, 32 up to 512: plan_for), and one block of
// 8 warps owns one group tile. It gathers the group's query rows into shared
// memory once (resident, split into TF32 parts where they fit, as in K2), and
// streams the list's rows through a cp.async ring of 128-row x 32-dimension
// stages, so a list is read once per group and not once per pair. The group x
// list product runs on the tensor cores as 3xTF32 with K2's split,
// fresh-accumulator and rounded-add rules, and the selection works from the
// accumulator fragments into per-query k-lists with K1's warp queue
// (tf32_tile.cuh, shared with K2 and K4). The epilogue keeps the per-pair
// form's order: l2 from the norms, cosine, or -dot, then the penalty row where
// there is one; rows past the list are +inf and never offered. Ties go to the
// smaller row. Each pair writes its sorted k best to its own k columns of the
// (m, p*k) buffer (slot pair·k: query pair / p, probe rank pair % p), and the
// wrapper merges each query's row with K1, exactly as merge_pairs orders the
// pairs. An empty (or filter-pruned) list writes (+inf, -1). No atomic decides
// an order between equal keys, so two launches give the same bits.
//
// The per-pair form (by name, k up to 1024, raft_ivf_flat_scan_pair): one block of
// 128 threads owns one (query, probe) pair, the role of
// ivf_flat_interleaved_scan-inl.cuh:1085 in the CUDA reference; the query
// sits in shared memory, the list's rows stream through shared memory 128
// rows x 32 dimensions at a time, each thread accumulating one row's dot
// in FP32, and warp 0 keeps the pair's sorted k-best list (warp_insert).
// Every pair reads its whole list.
//
// Bound on this card: the work is 2·d FP32 operations per (pair, row),
// about 88 GFLOP at m = 10,000, p = 20 over 1,024 lists of 1M rows, 1.3 ms
// at 67 TFLOP/s; the bytes of the probed lists, each read once, take
// less. The grouped form does this work as three TF32 products on the
// tensor cores (its 3xTF32 bound, at 495 TFLOP/s, is ~0.5 ms) and reads a
// list once per group tile; the per-pair form reads a list once per pair
// and runs at the rate of device memory.
//
// The store forms (template parameter S; one translation unit a store,
// ivf_flat_scan{,_bfloat16,_int8,_uint8}.cu) replace the TPU kernel's
// low-precision list modes: bf16, int8 with per-row scales and uint8
// lists. The grouped form stages a tile's stored bytes (copy_stage) and
// each warp builds its B fragments from them in registers
// (tf32_tile.cuh::stage_dots_bytes: a byte by one prmt into the mantissa
// of 2^23, a bf16 halfword shifted into the top of an f32 word), with no
// widened block and no barrier of its own: a stage costs two barriers, as
// the f32 form's. Every stored value is exact in TF32, so the f32 query's
// hi and lo parts against the row give the dot as 2xTF32, in the order of
// the f32 form's products less the two that read the row's lo parts
// (exact zeros), so a store form gives the f32 form's bits on the same
// rows widened (the TPU's Pallas scan rounds the query to bf16 for every
// such store; this kernel keeps the f32 query, as the JAX package's XLA
// engine does). The per-pair form widens each value as it stages it
// (widen1). The row's scale multiplies the finished dot, (q·r)·s, before
// the distance formula; it never multiplies a partial sum. Only int8
// lists carry scales (ops/quant.py), so the grouped instance knows at
// compile time whether it has them (SC) and the tile's epilogue holds no
// per-value branch on it: decided at run time there, it cost a fifth of
// the scan at k = 10 (tools/scan_ab.py on an H100).
//
// Past k = 512 (raft_ivf_flat_scan_wide) the grouped form is K4's wide
// plan (ivf_pq_scan.cu) over this tile loop: the plans above keep 32
// k-lists in shared memory, 8·32·(k + 128) bytes, which 512 fills. Here
// 32 queries a group, no k-list: persistent blocks (a counter hands out
// the groups, two blocks an SM where the tiles leave room), each writing
// its pairs' distances, tile by tile, to its own rows of a scratch in
// device memory (the wrapper's, from torch.empty a call, sized by the
// longest list and not by k), then one warp a pair selects its k best in
// rounds of 512 keys (list_select.cuh::select_rounds) in the grouped
// plans' order: ties to the lower row, -0.0 equal to 0.0 and written as
// computed, (+inf, -1) past the list. A list is still read once a group
// and its products are the same bits as the plans' up to 512, so at
// 513 <= k <= 1024 the form gives the per-pair form's bits on integer
// inputs and the first 512 columns of the plan at 512 on any input. Its
// bound is the grouped form's (the (pair, row) products); the scratch
// rows, written and read once a pair, stay in L2 (two blocks an SM keep
// 64 rows of the longest list each).
#pragma once

#include "list_select.cuh"
#include "tf32_tile.cuh"
#include "wide_plan.cuh"

namespace {

template <int MF, int R, int CAP, int RB, int S>
__global__ void __launch_bounds__(kThreads, 1)
ivf_group_kernel(const void* __restrict__ data, const float* __restrict__ dn,
                 const float* __restrict__ pen,
                 const float* __restrict__ scales, const float* __restrict__ q,
                 const float* __restrict__ qn, const int* __restrict__ order,
                 const int* __restrict__ glist,
                 const int* __restrict__ gstart,
                 const int* __restrict__ gcount,
                 const int* __restrict__ offsets,
                 const int* __restrict__ sizes, int p, int d, int k,
                 int metric, int vec, int a_res, int ns,
                 float* __restrict__ out_v, int* __restrict__ out_i) {
  constexpr int BM = 32 * MF;
  constexpr bool RAW = S != kF32;       // rows staged as stored bytes
  constexpr int NSIDE = RAW ? 3 : 2;    // (dn, pen[, scale]) a row
  constexpr bool SC = S == kI8;         // the rows carry scales
  const int cnt = gcount[blockIdx.x];
  if (cnt <= 0) return;  // past the live groups (block-uniform)
  const int list = glist[blockIdx.x];
  const int start = gstart[blockIdx.x];
  const int c_begin = offsets[list];
  const int c_end = c_begin + max(sizes[list], 0);
  const int nk = (d + BK - 1) / BK;
  // as in K2: the query tile resident (a_res 1, or 2 split into its TF32
  // parts) or a part of every ring stage (0); then ns ring stages
  const int a_floats = a_res * nk * BM * BK;
  const int stage = (a_res ? 0 : BM * BK * 4) + BN * BK * store_bytes<S>();
  extern __shared__ __align__(16) float smem[];
  float* a_tile = smem;
  unsigned char* ring = (unsigned char*)(smem + a_floats);
  float* sides = (float*)(ring + ns * stage);  // 4 x (dn, pen[, scale])
  float* list_v = sides + 4 * NSIDE * BN;    // BM x k sorted keys
  int* list_c = (int*)(list_v + BM * k);
  float* buf_v = (float*)(list_c + BM * k);  // BM x CAP candidates
  int* buf_c = (int*)(buf_v + BM * CAP);
  int* buf_n = buf_c + BM * CAP;             // BM counts
  int* pairs = buf_n + BM;                   // the group's pairs (-1 past)
  int* qrow = pairs + BM;                    // and their queries

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // the fragment's row group
  const int t4 = lane & 3;   // and the thread in it
  const int wm = warp >> 2;  // 0..1 along the queries
  const int wn = warp & 3;   // 0..3 along the rows

  for (int r = tid; r < BM; r += kThreads) {
    const int pr = r < cnt ? order[start + r] : -1;
    pairs[r] = pr;
    qrow[r] = pr < 0 ? -1 : pr / p;
    buf_n[r] = 0;
  }
  for (int e = tid; e < BM * k; e += kThreads) {
    list_v[e] = CUDART_INF_F;
    list_c[e] = INT_MAX;
  }
  __syncthreads();
  if (c_end <= c_begin) {  // an empty or filter-pruned list (block-uniform)
    for (int e = tid; e < cnt * k; e += kThreads) {
      const size_t o = (size_t)pairs[e / k] * k + e % k;
      out_v[o] = CUDART_INF_F;
      out_i[o] = -1;
    }
    return;
  }

  // this thread's rows of the tile: wm·16·MF + 16·i + g + 8·h
  float qnr[MF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int qi = qrow[wm * 16 * MF + 16 * i + g + 8 * h];
      qnr[i][h] = (metric != 2 && qi >= 0) ? qn[qi] : 0.f;
    }
  }

  const int total = (c_end - c_begin + BN - 1) / BN * nk;

  // stage s: list tile s / nk, dimensions [32·(s % nk), +32), in ring slot
  // s % ns (with the group's queries' same dimensions unless resident);
  // with a tile's first stage, its rows' norms and penalties, into side
  // buffer tile % 4 (a load runs at most two stages ahead)
  auto load = [&](int s) {
    const int tile = s / nk;
    const int k0 = (s - tile * nk) * BK;
    const int c0 = c_begin + tile * BN;
    unsigned char* st = ring + (s % ns) * stage;
    if (!a_res) {
      copy_gather<BM>((float*)st, q, qrow, k0, d, vec & 1, tid);
      st += BM * BK * 4;
    }
    if constexpr (RAW) {
      copy_stage<S, BN>(st, data, c0, c_end, k0, d, vec >> 1, tid);
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
      if (SC && tid < BN) {
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

  if (a_res) {
    for (int kc = 0; kc < nk; ++kc) {
      copy_gather<BM>(a_tile + kc * BM * BK, q, qrow, kc * BK, d, vec & 1,
                      tid);
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
    const float* a_lo = a_res == 2 ? As + nk * BM * BK : nullptr;
    if constexpr (RAW) {  // B fragments from the stored bytes
      stage_dots_bytes<MF, S>(acc, As, a_lo, Bst, false, lane, wm, wn);
    } else {
      stage_dots<MF>(acc, As, a_lo, (const float*)Bst, false, lane, wm, wn);
    }
    __syncthreads();  // slot s % ns is read before a load overwrites it
    if (s % nk != nk - 1) continue;

    // ---- the tile's dots are complete: distances, then the selection ----
    const int tile = s / nk;
    const int c0 = c_begin + tile * BN;
    const float* side = sides + (tile & 3) * NSIDE * BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int lc = wn * 32 + 8 * j + 2 * t4 + e1;
        const bool past = c0 + lc >= c_end;
        const float dnc = metric != 2 ? side[lc] : 0.f;
        const float scc = SC ? side[2 * BN + lc] : 1.f;
#pragma unroll
        for (int i = 0; i < MF; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // q·(s·r) = s·(q·r): the scale meets the whole dot
            const float dot = SC ? __fmul_rn(acc[i][j][2 * h + e1], scc)
                                 : acc[i][j][2 * h + e1];
            float dist;
            if (metric == 0) {
              dist = fmaxf(__fsub_rn(__fadd_rn(qnr[i][h], dnc),
                                     __fmul_rn(2.f, dot)),
                           0.f);
            } else if (metric == 1) {
              dist = __fsub_rn(
                  1.f, __fdiv_rn(dot, fmaxf(__fmul_rn(qnr[i][h], dnc),
                                            1e-30f)));
            } else {
              dist = -dot;
            }
            if (pen != nullptr) dist = __fadd_rn(dist, side[BN + lc]);
            acc[i][j][2 * h + e1] = past ? CUDART_INF_F : dist;
          }
        }
      }
    }
    offer_tile<MF, R, CAP, RB>(acc, qrow, c0 + wn * 32 + 2 * t4, list_v,
                               list_c, buf_v, buf_c, buf_n, k, lane, warp,
                               wm, g);
#pragma unroll
    for (int i = 0; i < MF; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  // fold what is left, then write each pair's list into its own k
  // columns: warp w owns rows w, w + 8, ...
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int nb = buf_n[r];
    if (nb > 0) {
      fold_row<R, CAP, RB>(list_v, list_c, buf_v, buf_c, buf_n, r, nb, k,
                           lane);
    }
    __syncwarp();
    if (r >= cnt) continue;
    const size_t o = (size_t)pairs[r] * k;
    for (int e = lane; e < k; e += 32) {
      const int c = list_c[r * k + e];
      out_v[o + e] = list_v[r * k + e];
      out_i[o + e] = c == INT_MAX ? -1 : c;
    }
  }
}

// A grouped launch's shape: the kernel, its shared memory, the queries a
// block, whether the query tile stays resident and the ring's stages.
struct Plan {
  const void* kern;
  size_t smem;
  int bm, a_res, ns;
};

template <int MF, int R, int CAP, int RB, int S>
cudaError_t prepare(int k, int d, Plan* p) {
  constexpr int BM = 32 * MF;
  constexpr bool RAW = S != kF32;
  p->kern = (const void*)ivf_group_kernel<MF, R, CAP, RB, S>;
  p->bm = BM;
  p->smem = fit_tiles(BM, d, 3,
                      list_bytes(BM, k, CAP) +
                          sizeof(float) * 4 * (RAW ? 3 : 2) * BN +
                          sizeof(int) * 2 * BM,
                      &p->a_res, &p->ns,
                      (size_t)store_bytes<S>() * BK * BN);
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

// By k, as K2 up to 256: 128 queries a group and a buffer of the queue's
// C keys up to k = 64; 64 queries above, with 128 keys up to k = 128 and
// 64 up to 256. Past 256 (K2 stops there): 32 queries a group, a queue of
// 512 keys (R = 16) and buffers of 128, sorted in 4 registers a fold
// (RB), so that the k-lists and buffers, 8·32·(k + 128) bytes, leave room
// for the ring at k = 512 (164 KB of lists; at k = 257 the first 3 tiles
// of every list all enter the buffers, 3 folds before a threshold
// exists). Past 512 the wide plan (prepare_wide, every k).
// ops/ivf_scan.py::group_plan states these plans in Python.

// ---- the grouped form past k = 512 ----
//
// Its own kernel beside ivf_group_kernel, whose tile loop it repeats at
// MF = 1, so that the k-list plans compile as before (as K4's wide plan,
// ivf_pq_scan.cu). Its scratch, grid, group loop and selection are
// wide_plan.cuh's, which K4's wide plan shares.
// The wide kernel's arguments: the frame (wide_plan.cuh), then the
// grouped entry's.
struct WideArgs : wide::Frame {
  const void* data;
  const float* dn;
  const float* pen;
  const float* scales;
  const float* q;
  const float* qn;
  const int* order;
  const int* glist;
  const int* gstart;
  const int* gcount;
  const int* offsets;
  const int* sizes;
  int p, d, k, metric, vec, a_res, ns;
};

// One group tile gi (cnt > 0 pairs of one list) by the whole block: the
// tile loop of ivf_group_kernel at MF = 1, each finished tile's distances
// written to the pairs' rows of the block's scratch; then one warp a pair
// selects its k best in rounds.
template <int S>
__device__ __forceinline__ void scan_wide(const WideArgs& a, int gi, int cnt,
                                          float* smem) {
  constexpr int BM = wide::kBM;
  constexpr bool RAW = S != kF32;     // rows staged as stored bytes
  constexpr int NSIDE = RAW ? 3 : 2;  // (dn, pen[, scale]) a row
  constexpr bool SC = S == kI8;       // the rows carry scales
  const int p = a.p, d = a.d, k = a.k, metric = a.metric;
  const int a_res = a.a_res, ns = a.ns;
  const int list = a.glist[gi];
  const int start = a.gstart[gi];
  const int c_begin = a.offsets[list];
  const int c_end = c_begin + max(a.sizes[list], 0);
  const int nk = (d + BK - 1) / BK;
  // the query tile and the ns ring stages, as ivf_group_kernel's; the
  // warps' selection space takes their place once the tiles are done
  const int a_floats = a_res * nk * BM * BK;
  const int stage = (a_res ? 0 : BM * BK * 4) + BN * BK * store_bytes<S>();
  const int tile_bytes =
      max(4 * a_floats + ns * stage, (kThreads / 32) * lsel::kWarpBytes);
  float* a_tile = smem;
  unsigned char* ring = (unsigned char*)(smem + a_floats);
  // 4 x (dn, pen[, scale])
  float* sides = (float*)((unsigned char*)smem + tile_bytes);
  int* pairs = (int*)(sides + 4 * NSIDE * BN);  // the group's pairs (-1 past)
  int* qrow = pairs + BM;                       // and their queries

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;   // the fragment's row group
  const int t4 = lane & 3;   // and the thread in it
  const int wm = warp >> 2;  // 0..1 along the queries
  const int wn = warp & 3;   // 0..3 along the rows

  for (int r = tid; r < BM; r += kThreads) {
    const int pr = r < cnt ? a.order[start + r] : -1;
    pairs[r] = pr;
    qrow[r] = pr < 0 ? -1 : pr / p;
  }
  __syncthreads();
  if (c_end <= c_begin) {  // an empty or filter-pruned list (block-uniform)
    for (int e = tid; e < cnt * k; e += kThreads) {
      const size_t o = (size_t)pairs[e / k] * k + e % k;
      a.out_v[o] = CUDART_INF_F;
      a.out_i[o] = -1;
    }
    return;
  }

  // this thread's rows of the tile: wm·16 + g + 8·h
  float qnr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qi = qrow[wm * 16 + g + 8 * h];
    qnr[h] = (metric != 2 && qi >= 0) ? a.qn[qi] : 0.f;
  }

  const int total = (c_end - c_begin + BN - 1) / BN * nk;

  // the stages as ivf_group_kernel's (a tile's norms, penalties and
  // scales into side buffer tile % 4 with its first stage)
  auto load = [&](int s) {
    const int tile = s / nk;
    const int k0 = (s - tile * nk) * BK;
    const int c0 = c_begin + tile * BN;
    unsigned char* st = ring + (s % ns) * stage;
    if (!a_res) {
      copy_gather<BM>((float*)st, a.q, qrow, k0, d, a.vec & 1, tid);
      st += BM * BK * 4;
    }
    if constexpr (RAW) {
      copy_stage<S, BN>(st, a.data, c0, c_end, k0, d, a.vec >> 1, tid);
    } else {
      copy_block<BN>((float*)st, (const float*)a.data, c0, c_end, k0, d,
                     a.vec & 1, tid);
    }
    if (k0 == 0) {
      const int c = tid & (BN - 1);
      const bool ok = c0 + c < c_end;
      const float* src = tid < BN ? a.dn : a.pen;
      float* side = sides + (tile & 3) * NSIDE * BN;
      if (src != nullptr) {
        cp_async4(side + tid, ok ? src + c0 + c : src, ok);
      }
      if (SC && tid < BN) {
        cp_async4(side + 2 * BN + tid, ok ? a.scales + c0 + c : a.scales,
                  ok);
      }
    }
  };

  float acc[1][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;

  if (a_res) {
    for (int kc = 0; kc < nk; ++kc) {
      copy_gather<BM>(a_tile + kc * BM * BK, a.q, qrow, kc * BK, d,
                      a.vec & 1, tid);
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
    const float* a_lo = a_res == 2 ? As + nk * BM * BK : nullptr;
    if constexpr (RAW) {  // B fragments from the stored bytes
      stage_dots_bytes<1, S>(acc, As, a_lo, Bst, false, lane, wm, wn);
    } else {
      stage_dots<1>(acc, As, a_lo, (const float*)Bst, false, lane, wm, wn);
    }
    __syncthreads();  // slot s % ns is read before a load overwrites it
    if (s % nk != nk - 1) continue;

    // ---- the tile's dots are complete: its distances to the rows ----
    const int tile = s / nk;
    const int c0 = c_begin + tile * BN;
    const float* side = sides + (tile & 3) * NSIDE * BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int lc = wn * 32 + 8 * j + 2 * t4 + e1;
        const bool past = c0 + lc >= c_end;
        const float dnc = metric != 2 ? side[lc] : 0.f;
        const float scc = SC ? side[2 * BN + lc] : 1.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          // q·(s·r) = s·(q·r): the scale meets the whole dot
          const float dot = SC ? __fmul_rn(acc[0][j][2 * h + e1], scc)
                               : acc[0][j][2 * h + e1];
          float dist;
          if (metric == 0) {
            dist = fmaxf(__fsub_rn(__fadd_rn(qnr[h], dnc),
                                   __fmul_rn(2.f, dot)),
                         0.f);
          } else if (metric == 1) {
            dist = __fsub_rn(
                1.f,
                __fdiv_rn(dot, fmaxf(__fmul_rn(qnr[h], dnc), 1e-30f)));
          } else {
            dist = -dot;
          }
          if (a.pen != nullptr) dist = __fadd_rn(dist, side[BN + lc]);
          acc[0][j][2 * h + e1] = past ? CUDART_INF_F : dist;
        }
      }
    }
    // each pair's distances to its row of the block's rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g + 8 * h;
      float* dst = wide::block_row(a, r) + tile * BN + wn * 32 + 2 * t4;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        *reinterpret_cast<float2*>(dst + 8 * j) =
            make_float2(acc[0][j][2 * h], acc[0][j][2 * h + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  }

  // the rows are written: one warp a pair selects its k best
  __syncthreads();
  unsigned char* ws =
      reinterpret_cast<unsigned char*>(smem) + warp * lsel::kWarpBytes;
  const int n = c_end - c_begin;
  for (int r = warp; r < cnt; r += kThreads / 32) {
    wide::select_pair(a, wide::block_row(a, r), n, k,
                      (size_t)pairs[r] * k, c_begin, ws, lane);
  }
}

// Persistent blocks, each with its 32 distance rows.
template <int S>
__global__ void __launch_bounds__(kThreads, 2)
ivf_wide_kernel(const WideArgs a) {
  extern __shared__ __align__(16) float smem[];
  wide::for_each_group(a, a.gcount, [&](int gi, int cnt) {
    scan_wide<S>(a, gi, cnt, smem);
  });
}

// The wide plan: 32 queries a group; the tiles (the first layout, query
// tile split, resident or streamed, 3 ring stages then 2, that leaves room
// for two blocks an SM, else one) share their space with the warps'
// selection space, whichever is larger; then the side buffers and the
// group's pairs and queries; beside the dynamic bytes, one 128-byte unit
// of static ones (the next group). ops/ivf_scan.py::group_smem states it.
template <int S>
cudaError_t prepare_wide(int d, Plan* p) {
  constexpr int BM = wide::kBM;
  constexpr bool RAW = S != kF32;
  constexpr size_t kSel = (kThreads / 32) * lsel::kWarpBytes;
  const size_t nk = (d + BK - 1) / BK;
  const size_t b_stage = (size_t)store_bytes<S>() * BK * BN;
  const size_t fixed =
      sizeof(float) * 4 * (RAW ? 3 : 2) * BN + sizeof(int) * 2 * BM;
  p->kern = (const void*)ivf_wide_kernel<S>;
  p->bm = BM;
  p->smem = 0;
  const size_t limits[2] = {kTwoBlocks, kSmemLimit};
  for (size_t limit : limits) {
    for (int a = 2; a >= 0 && p->smem == 0; --a) {
      for (int ns = 3; ns >= 2 && p->smem == 0; --ns) {
        size_t tiles = sizeof(float) * BK * a * nk * BM +
                       ns * (sizeof(float) * BK * (a ? 0 : BM) + b_stage);
        if (tiles < kSel) tiles = kSel;
        if (tiles + fixed + kStaticUnit <= limit) {
          p->smem = tiles + fixed;
          p->a_res = a;
          p->ns = ns;
        }
      }
    }
    if (p->smem != 0) break;
  }
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

template <int S>
cudaError_t plan_for(int k, int d, Plan* p) {
  if (k <= 32) return prepare<4, 1, 32, 1, S>(k, d, p);
  if (k <= 64) return prepare<4, 2, 64, 2, S>(k, d, p);
  if (k <= 128) return prepare<2, 4, 128, 4, S>(k, d, p);
  if (k <= 256) return prepare<2, 8, 64, 8, S>(k, d, p);
  if (k <= kGroupMaxK) return prepare<1, 16, 128, 4, S>(k, d, p);
  return prepare_wide<S>(d, p);
}

// ---- the per-pair form ----

constexpr int kRows = 128;     // rows per shared-memory tile = threads
constexpr int BKD = 32;        // dimensions per step
constexpr int RS = BKD + 1;    // padded tile row stride

// One stored value widened to f32 (bf16: its bits in the top of the
// word; the integer stores: the integer), exact.
template <int S>
__device__ __forceinline__ float widen1(typename TileStore<S>::T v) {
  if constexpr (S == kBF16) {
    return __uint_as_float((unsigned)v << 16);
  } else {
    return (float)v;
  }
}

template <int S>
__global__ void __launch_bounds__(kRows)
ivf_pair_kernel(const typename TileStore<S>::T* __restrict__ data,
                const float* __restrict__ dn, const float* __restrict__ pen,
                const float* __restrict__ scales, const float* __restrict__ q,
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
                               ? widen1<S>(data[(size_t)(off + row) * d + kk])
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
      if (scales != nullptr) acc = __fmul_rn(acc, scales[g]);
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

// metric: 0 = squared L2 (qn, dn squared norms), 1 = cosine (qn, dn
// norms), 2 = inner product (-dot). scales, the rows' factors, go with
// int8 lists and no others; pen and, for "ip", qn and dn may be null.
// data is the (rows, d) store; q (m, d) f32. order is the stable sort of
// the m*p pairs by list id; group g of the n_groups (pack_pairs) scans list
// glist[g] for the gcount[g] pairs order[gstart[g] ...] (none past the
// live groups); qg, the group's rows, must be the form's for k (128 up to
// k = 64, 64 up to 256, 32 up to 512). 1 <= k <= 512 (past it
// scan_wide_entry).
template <int S>
int scan_group(const void* data, const void* dn, const void* pen,
               const void* scales, const void* q, const void* qn,
               const void* order, const void* glist, const void* gstart,
               const void* gcount, const void* offsets, const void* sizes,
               int n_groups, int qg, int p, int d, int k, int metric,
               void* out_v, void* out_i, void* stream) {
  if (k < 1 || k > kGroupMaxK || d < 1 || n_groups < 0 ||
      (S == kI8) != (scales != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  cudaError_t err = plan_for<S>(k, d, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.bm != qg) return (int)cudaErrorInvalidValue;
  if (n_groups == 0) return 0;
  // 16-byte copies: bit 0 for the query rows, bit 1 for the stored rows
  const int vec_q = d % 4 == 0 && (uintptr_t)q % 16 == 0;
  const int vec_d = d * store_bytes<S>() % 16 == 0 &&
                    (uintptr_t)data % 16 == 0;
  const int vec = S == kF32 ? (vec_q && vec_d) * 3 : vec_q | (vec_d << 1);
  void* args[] = {(void*)&data,   (void*)&dn,      (void*)&pen,
                  (void*)&scales, (void*)&q,       (void*)&qn,
                  (void*)&order,  (void*)&glist,   (void*)&gstart,
                  (void*)&gcount, (void*)&offsets, (void*)&sizes,
                  (void*)&p,      (void*)&d,       (void*)&k,
                  (void*)&metric, (void*)&vec,     (void*)&pl.a_res,
                  (void*)&pl.ns,  (void*)&out_v,   (void*)&out_i};
  err = cudaLaunchKernel(pl.kern, dim3(n_groups), dim3(kThreads), args,
                         pl.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grouped form's plan for (k, d) at any k (past 512 the wide plan's):
// out[0..4) = the queries a group, the query tile's layout (a_res), the
// ring's stages and the shared memory of a block.
template <int S>
int group_plan(int k, int d, int* out) {
  if (k < 1 || d < 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  const cudaError_t err = plan_for<S>(k, d, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.bm;
  out[1] = pl.a_res;
  out[2] = pl.ns;
  out[3] = (int)pl.smem;
  return 0;
}

// The grouped form past k = 512, as scan_group's arguments but for
// scratch, raft_ivf_flat_scan_wide_scratch(k, d, lmax) bytes of device
// memory, and lmax, the longest list's rows; qg must be 32.
template <int S>
int scan_wide_entry(const void* data, const void* dn, const void* pen,
                    const void* scales, const void* q, const void* qn,
                    const void* order, const void* glist, const void* gstart,
                    const void* gcount, const void* offsets,
                    const void* sizes, void* scratch, int n_groups, int qg,
                    int p, int d, int k, int metric, int lmax, void* out_v,
                    void* out_i, void* stream) {
  if (k <= kGroupMaxK || d < 1 || n_groups < 0 || lmax < 1 ||
      scratch == nullptr || (S == kI8) != (scales != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  cudaError_t err = plan_for<S>(k, d, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.bm != qg) return (int)cudaErrorInvalidValue;
  const int vec_q = d % 4 == 0 && (uintptr_t)q % 16 == 0;
  const int vec_d = d * store_bytes<S>() % 16 == 0 &&
                    (uintptr_t)data % 16 == 0;
  const int vec = S == kF32 ? (vec_q && vec_d) * 3 : vec_q | (vec_d << 1);
  const WideArgs a{wide::frame(n_groups, out_v, out_i, scratch, lmax),
                   data, (const float*)dn, (const float*)pen,
                   (const float*)scales, (const float*)q, (const float*)qn,
                   (const int*)order, (const int*)glist, (const int*)gstart,
                   (const int*)gcount, (const int*)offsets,
                   (const int*)sizes, p, d, k, metric, vec, pl.a_res, pl.ns};
  return (int)wide::launch(pl.kern, pl.smem, a, (cudaStream_t)stream);
}

// The wide plan's scratch for (k, d, lmax) on the current card: out[0] =
// its bytes, out[1] = the persistent blocks, out[2] = the blocks an SM
// keeps resident (all 0 at k <= 512, whose plans keep none).
template <int S>
int wide_scratch_entry(int k, int d, int lmax, long long* out) {
  if (k < 1 || d < 1 || lmax < 0) return (int)cudaErrorInvalidValue;
  out[0] = out[1] = out[2] = 0;
  if (k <= kGroupMaxK) return 0;
  Plan pl;
  const cudaError_t err = plan_for<S>(k, d, &pl);
  if (err != cudaSuccess) return (int)err;
  return (int)wide::scratch_info(pl.kern, pl.smem, lmax, out);
}

// The per-pair form: probed is (m, p), order a permutation of the m*p
// pairs (the launch order); k up to 1024 (its k-list in shared memory;
// the wrapper checks).
template <int S>
int scan_pair(const void* data, const void* dn, const void* pen,
              const void* scales, const void* q, const void* qn,
              const void* probed, const void* order, const void* offsets,
              const void* sizes, int m, int p, int d, int k, int metric,
              void* out_v, void* out_i, void* stream) {
  if ((S == kI8) != (scales != nullptr)) return (int)cudaErrorInvalidValue;
  const int d_pad = (d + BKD - 1) / BKD * BKD;
  const size_t smem = sizeof(float) * (size_t)(d_pad + kRows * RS + kRows) +
                      (sizeof(float) + sizeof(int)) * (size_t)k;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_pair_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long pairs = (long long)m * p;
  if (pairs > 0) {
    ivf_pair_kernel<S><<<(unsigned)pairs, kRows, smem,
                         (cudaStream_t)stream>>>(
        (const typename TileStore<S>::T*)data, (const float*)dn,
        (const float*)pen, (const float*)scales, (const float*)q,
        (const float*)qn, (const int*)probed, (const int*)order,
        (const int*)offsets, (const int*)sizes, p, d, d_pad, k, metric,
        (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One store's C entries, raft_ivf_flat_scan_group(data, dn, pen, scales,
// q, qn, order, glist, gstart, gcount, offsets, sizes, n_groups, qg, p, d,
// k, metric, out_v, out_i, stream), raft_ivf_flat_scan_wide(the same with
// scratch after sizes and lmax after metric; k > 512),
// raft_ivf_flat_scan_pair(data, dn, pen, scales, q, qn, probed, order,
// offsets, sizes, m, p, d, k, metric, out_v, out_i, stream),
// raft_ivf_flat_scan_group_plan(k, d, out) and
// raft_ivf_flat_scan_wide_scratch(k, d, lmax, out), each library built
// from one ivf_flat_scan*.cu that names its store.
#define RAFT_IVF_FLAT_SCAN_ENTRIES(S)                                       \
  extern "C" int raft_ivf_flat_scan_group(                                  \
      const void* data, const void* dn, const void* pen,                    \
      const void* scales, const void* q, const void* qn,                    \
      const void* order, const void* glist, const void* gstart,             \
      const void* gcount, const void* offsets, const void* sizes,           \
      int n_groups, int qg, int p, int d, int k, int metric, void* out_v,   \
      void* out_i, void* stream) {                                          \
    return scan_group<S>(data, dn, pen, scales, q, qn, order, glist,        \
                         gstart, gcount, offsets, sizes, n_groups, qg, p,   \
                         d, k, metric, out_v, out_i, stream);               \
  }                                                                         \
  extern "C" int raft_ivf_flat_scan_pair(                                   \
      const void* data, const void* dn, const void* pen,                    \
      const void* scales, const void* q, const void* qn,                    \
      const void* probed, const void* order, const void* offsets,           \
      const void* sizes, int m, int p, int d, int k, int metric,            \
      void* out_v, void* out_i, void* stream) {                             \
    return scan_pair<S>(data, dn, pen, scales, q, qn, probed, order,        \
                        offsets, sizes, m, p, d, k, metric, out_v, out_i,   \
                        stream);                                            \
  }                                                                         \
  extern "C" int raft_ivf_flat_scan_group_plan(int k, int d, int* out) {    \
    return group_plan<S>(k, d, out);                                        \
  }                                                                         \
  extern "C" int raft_ivf_flat_scan_wide(                                   \
      const void* data, const void* dn, const void* pen,                    \
      const void* scales, const void* q, const void* qn,                    \
      const void* order, const void* glist, const void* gstart,             \
      const void* gcount, const void* offsets, const void* sizes,           \
      void* scratch, int n_groups, int qg, int p, int d, int k, int metric, \
      int lmax, void* out_v, void* out_i, void* stream) {                   \
    return scan_wide_entry<S>(data, dn, pen, scales, q, qn, order, glist,   \
                              gstart, gcount, offsets, sizes, scratch,      \
                              n_groups, qg, p, d, k, metric, lmax, out_v,   \
                              out_i, stream);                               \
  }                                                                         \
  extern "C" int raft_ivf_flat_scan_wide_scratch(int k, int d, int lmax,    \
                                                 long long* out) {          \
    return wide_scratch_entry<S>(k, d, lmax, out);                          \
  }
