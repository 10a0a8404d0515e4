// K4 — IVF-PQ list scan: per (query, probe) pair, the k nearest PQ-coded
// rows of the probed list.
//
// Replaces the TPU kernel raft_tpu/ops/ivf_pq_scan.py::_scan_groups
// (kernel _kernel -> _kernel_body): (query, probe) pairs packed 128 to a
// group per list; the group's PQ distances in expanded form,
//   l2: max(||q||² + ||c_l + dec_i||² - 2·q·c_l - 2·q·dec_i, 0)
//   ip: -q·c_l - q·dec_i,
// with the list's codes decoded into rows (a one-hot GEMM against a
// block-diagonal codebook matrix on the MXU: f32, bf16 or int8 codebook)
// and the group's queries multiplied by the decoded rows; the additive
// penalty row; rows outside the list masked; a per-pair top-k with ties
// to the lower row.
//
// Two forms, chosen by k in the wrapper (ops/ivf_scan.py::scan_form).
//
// The grouped form (k <= 512, raft_ivf_pq_scan_group) keeps the TPU
// kernel's grouping and its decode. One block of 8 warps owns one group
// tile of the wrapper's pack_pairs (BM = 128 queries of one list for
// k <= 64, 64 up to 256, 32 up to 512: K3's plans). It gathers the
// group's rotated queries into shared memory once (resident, split into
// TF32 parts where they fit, else streamed beside each stage), and
// computes q·c_l and ||q||² once per
// (group query, list). No block builds a lookup table: each 32-dimension
// stage of a 128-row tile is decoded into dense float32 rows in shared
// memory, dec[r, s·pq_len + l] = cb[s, code[r, s], l], from the codes and
// the codebook (the LUT mode's, always float32, read through the L1
// cache), so a list's codes are decoded once per group and not once per
// pair. Stages are decoded one ahead of the products into a 2-slot ring:
// each thread has a stage's 16 code loads in flight together, two stages
// ahead, and its 16 codebook loads behind the products of the stage
// before, with one barrier a stage. The group x tile product runs on the
// tensor cores as 3xTF32 with K2's rules (tf32_tile.cuh). Where every
// codebook value is exact in TF32 — the bf16 LUT mode, whose codebook is
// rounded to bfloat16 — the decoded rows' lo parts are zero and the two
// products that read them are skipped: the sums are the same bits (the
// wrapper computes that flag on the card). The sum q·dec_i is thus a dot
// over the rotated dimensions, where the plain version sums lookup-table
// entries subspace by subspace; on integer-valued inputs both are exact.
// The epilogue keeps _kernel_body's order with __fadd_rn/__fmul_rn, so
// nvcc cannot contract it into FMAs: max(((||q||² + dn) - 2·qc) +
// (-2·Σ), 0), then + pen where there is a penalty row. Up to k = 256 the
// selection from the accumulator fragments is K3's grouped form's; so are
// the per-pair output slots (pair·k of the (m, p*k) buffer, merged by the
// wrapper's K1 exactly as merge_pairs orders the pairs) and the (+inf,
// -1) of an empty or filter-pruned list.
//
// Past k = 256 (CAGRA's IVF-PQ graph pass: k = 2·128 + 1 = 257, 4-bit
// codes at pq_len 1, int8 LUT, lists of ~1,590 rows) a pair keeps about a
// sixth of its list, which a streaming k-list pays for in folds that stall
// the block (such a plan spent 64% of its time selecting there). K4's own
// plan there: 32 queries a group, no k-lists in shared memory, so two
// blocks fit an SM; the blocks are persistent (a counter hands out the
// groups), and each writes its 32 pairs' distances, tile by tile, to its
// own rows of a scratch in device memory (the wrapper's, sized by the
// longest list; at the pass ~170 MB, of which the rows in use stay in
// L2), with each pair's least and greatest order key. When the list is done, one
// warp a pair selects its k best at once (list_select.cuh: a radix select
// on the keys' histogram, then one sort of at most 512 keys), in the
// order of the streaming selection, so both plans give the same bits.
//
// The per-pair form (k up to 1024, raft_ivf_pq_scan_pair): one block of
// 256 threads owns one (query, probe) pair, the role of
// ivf_pq_compute_similarity-inl.cuh:271 in the CUDA reference; it builds
// the pair's lookup table lut[s][b] = Σ_l q[s·pq_len + l]·cb[s][b][l] in
// shared memory, then sums each row's pq_dim entries in subspace order,
// and warp 0 keeps the pair's k-best list (warp_offer). Every pair
// rebuilds its table and re-reads its list's codes.
//
// Bound on this card: the LUT once per query (2·pq_len FLOPs per entry,
// 0.66 G at m = 10,000, pq_dim = 64, book = 256, ~0.01 ms at 67 TFLOP/s
// FP32) and one add per (pair, row, subspace) (~24 G over p = 20 probes
// of 1,024 lists of 1M rows, ~0.72 ms at 33.5 T adds/s: a lone add is
// half an FMA's two FLOPs); the distinct code bytes (~68 MB) take less.
// That is the least work for the function; the grouped form does more
// operations (a dot of rot_dim over each (group query, row) on the tensor
// cores) to read and decode each list once per group.
#include "list_select.cuh"
#include "tf32_tile.cuh"

// A diagnostic build switch of tools/scan_ab.py's split, 0 in every
// library the port builds: 1 keeps the products and the epilogue's
// distances but selects and writes nothing; 2 keeps the products alone;
// 3 (the wide plan) also writes the distances and key ranges but selects
// nothing.
#ifndef RAFT_SCAN_SPLIT
#define RAFT_SCAN_SPLIT 0
#endif

namespace {

template <int MF, int R, int CAP, int RB>
__global__ void __launch_bounds__(kThreads, 1)
ivf_pq_group_kernel(const uint8_t* __restrict__ codes,
                    const float* __restrict__ dn,
                    const float* __restrict__ pen,
                    const float* __restrict__ cb,
                    const float* __restrict__ centers,
                    const float* __restrict__ q,
                    const int* __restrict__ exact,
                    const int* __restrict__ order,
                    const int* __restrict__ glist,
                    const int* __restrict__ gstart,
                    const int* __restrict__ gcount,
                    const int* __restrict__ offsets,
                    const int* __restrict__ sizes, int p, int pq_dim,
                    int pq_len, int book, int k, int metric, int vec,
                    int a_res, float* __restrict__ out_v,
                    int* __restrict__ out_i) {
  constexpr int BM = 32 * MF;
  const int cnt = gcount[blockIdx.x];
  if (cnt <= 0) return;  // past the live groups (block-uniform)
  const int list = glist[blockIdx.x];
  const int start = gstart[blockIdx.x];
  const int c_begin = offsets[list];
  const int c_end = c_begin + max(sizes[list], 0);
  const int d = pq_dim * pq_len;  // rot_dim
  const int nk = (d + BK - 1) / BK;
  // the query tile resident (a_res 1, or 2 split into its TF32 parts) or
  // a part of every ring stage (0); then the 2 ring stages
  const int a_floats = a_res * nk * BM * BK;
  const int stage = (a_res ? 0 : BM * BK) + BN * BK;
  extern __shared__ __align__(16) float smem[];
  float* a_tile = smem;
  float* ring = smem + a_floats;
  float* sides = ring + 2 * stage;           // 2 x (dn, pen) of a tile
  float* list_v = sides + 2 * 2 * BN;        // BM x k sorted keys
  int* list_c = (int*)(list_v + BM * k);
  float* buf_v = (float*)(list_c + BM * k);  // BM x CAP candidates
  int* buf_c = (int*)(buf_v + BM * CAP);
  int* buf_n = buf_c + BM * CAP;             // BM counts
  int* pairs = buf_n + BM;                   // the group's pairs (-1 past)
  int* qrow = pairs + BM;                    // and their queries
  float* qn_s = (float*)(qrow + BM);         // ||q||² of each
  float* qc_s = qn_s + BM;                   // q·c_l of each
  int* col_sub = (int*)(qc_s + BM);          // a dimension's subspace
  int* col_cb = col_sub + nk * BK;           // and its codebook offset

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
  for (int c = tid; c < nk * BK; c += kThreads) {
    const int s = c / pq_len;
    col_sub[c] = c < d ? s : -1;
    col_cb[c] = (s * book) * pq_len + (c - s * pq_len);
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
  // q·c_l and ||q||² once per group query: warp w takes rows w, w + 8, ...
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int qi = qrow[r];
    float qc = 0.f, qq = 0.f;
    if (qi >= 0) {
      const float* qr = q + (size_t)qi * d;
      const float* cl = centers + (size_t)list * d;
      for (int c = lane; c < d; c += 32) {
        const float a = qr[c];
        qc = fmaf(a, cl[c], qc);
        qq = fmaf(a, a, qq);
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      qc += __shfl_xor_sync(RAFT_FULL_MASK, qc, s);
      qq += __shfl_xor_sync(RAFT_FULL_MASK, qq, s);
    }
    if (lane == 0) {
      qc_s[r] = qc;
      qn_s[r] = qq;
    }
  }
  const bool b_exact = exact != nullptr && *exact != 0;
  const int total = (c_end - c_begin + BN - 1) / BN * nk;

  // stage s: tile s / nk, dimensions [32·(s % nk), +32), in ring slot
  // s % 2. The group's queries' part (unless resident) comes by cp.async;
  // the tile's part is decoded from the codes in three steps, so that the
  // loads of a stage are in flight together and behind the products of
  // the stage before: its codes to registers (fetch_codes, two stages
  // ahead), its codebook values to registers (fetch_values, one ahead),
  // and those into the slot (store_values). Thread (warp w, lane c)
  // decodes column c of rows w, w + 8, ... With a tile's first stage its
  // rows' norms and penalties go to side buffer tile % 2.
  constexpr int kDec = BN * BK / kThreads;  // values a thread decodes
  constexpr unsigned kNoCode = 0xffffffffu;
  unsigned code[kDec];
  float val[kDec];
  float side_v = 0.f;
  auto load_queries = [&](int s) {
    if (!a_res) {
      copy_gather<BM>(ring + (s & 1) * stage, q, qrow, (s % nk) * BK, d,
                      vec, tid);
    }
  };
  auto fetch_codes = [&](int s) {
    const int tile = s / nk;
    const int sub = col_sub[(s - tile * nk) * BK + lane];
    const int r0 = c_begin + tile * BN + warp;
#pragma unroll
    for (int i = 0; i < kDec; ++i) {
      const int row = r0 + 8 * i;
      code[i] = row < c_end && sub >= 0
                    ? (unsigned)__ldg(codes + (size_t)row * pq_dim + sub)
                    : kNoCode;
    }
  };
  auto fetch_values = [&](int s) {
    const int tile = s / nk;
    const int k0 = (s - tile * nk) * BK;
    const float* cbc = cb + col_cb[k0 + lane];
#pragma unroll
    for (int i = 0; i < kDec; ++i) {
      val[i] = code[i] != kNoCode ? __ldg(cbc + code[i] * pq_len) : 0.f;
    }
    if (k0 == 0) {
      const int r = c_begin + tile * BN + (tid & (BN - 1));
      const float* src = tid < BN ? dn : pen;
      side_v = src != nullptr && r < c_end ? src[r] : 0.f;
    }
  };
  auto store_values = [&](int s) {
    const int tile = s / nk;
    float* dst = ring + (s & 1) * stage + (a_res ? 0 : BM * BK);
#pragma unroll
    for (int i = 0; i < kDec; ++i) dst[swz(warp + 8 * i, lane)] = val[i];
    if (s == tile * nk) sides[(tile & 1) * 2 * BN + tid] = side_v;
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
      copy_gather<BM>(a_tile + kc * BM * BK, q, qrow, kc * BK, d, vec, tid);
    }
  }
  load_queries(0);
  cp_async_commit();
  fetch_codes(0);
  fetch_values(0);
  store_values(0);
  if (total > 1) fetch_codes(1);
  cp_async_wait_all();
  __syncthreads();
  if (a_res == 2) {  // the query tile landed: split it once
    split_tile(a_tile, nk * BM * BK, tid);
    __syncthreads();
  }
  // this thread's rows of the tile: wm·16·MF + 16·i + g + 8·h
  float qnr[MF][2], qcr[MF][2];
#pragma unroll
  for (int i = 0; i < MF; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 * MF + 16 * i + g + 8 * h;
      qnr[i][h] = qn_s[r];
      qcr[i][h] = qc_s[r];
    }
  }
  for (int s = 0; s < total; ++s) {
    // the other slot was last read before the previous barrier
    if (s + 1 < total) {
      load_queries(s + 1);
      fetch_values(s + 1);
    }
    cp_async_commit();
    const float* st = ring + (s & 1) * stage;
    const float* As = a_res ? a_tile + (s % nk) * BM * BK : st;
    const float* Bs = a_res ? st : st + BM * BK;
    stage_dots<MF>(acc, As, a_res == 2 ? As + nk * BM * BK : nullptr, Bs,
                   b_exact, lane, wm, wn);
    if (s + 1 < total) store_values(s + 1);
    if (s + 2 < total) fetch_codes(s + 2);
    cp_async_wait_all();
    __syncthreads();
    if (s % nk != nk - 1) continue;

    // ---- the tile's dots are complete: distances, then the selection ----
    const int tile = s / nk;
    const int c0 = c_begin + tile * BN;
    const float* side = sides + (tile & 1) * 2 * BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int lc = wn * 32 + 8 * j + 2 * t4 + e1;
        const bool past = c0 + lc >= c_end;
#pragma unroll
        for (int i = 0; i < MF; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float dot = acc[i][j][2 * h + e1];
            float dist;
            if (metric == 0) {
              dist = fmaxf(
                  __fadd_rn(__fsub_rn(__fadd_rn(qnr[i][h], side[lc]),
                                      __fmul_rn(2.f, qcr[i][h])),
                            __fmul_rn(-2.f, dot)),
                  0.f);
            } else {
              dist = __fadd_rn(-qcr[i][h], __fmul_rn(-1.f, dot));
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

  // fold what is left, then write each pair's list into its own k columns
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

// ---- the plan past k = 256 ----
//
// Its own kernel beside ivf_pq_group_kernel, whose tile loop (decode,
// stage_dots, epilogue) it repeats: one template over both changed the
// narrow plans' register allocation and cost K4 at the path's k = 20
// 2.4% on an H100 (tools/scan_ab.py), and kept apart the narrow plans
// compile to the same SASS as before the wide plan existed.

// The wide kernel's arguments: the grouped entry's, the next group's
// counter and the blocks' distance rows (32 a block, stride floats apart).
struct WideArgs {
  const uint8_t* codes;
  const float* dn;
  const float* pen;
  const float* cb;
  const float* centers;
  const float* q;
  const int* exact;
  const int* order;
  const int* glist;
  const int* gstart;
  const int* gcount;
  const int* offsets;
  const int* sizes;
  int n_groups, p, pq_dim, pq_len, book, k, metric, vec, a_res;
  float* out_v;
  int* out_i;
  int* counter;
  float* rows;
  int stride;
};

constexpr int kWideBM = 32;  // queries a group
constexpr int kSides = 3;    // side buffer slots (see scan_wide)

// The wide plan's shared memory beside its tiles at rot_dim d: the side
// buffers (dn, pen of a tile), the group's pairs, queries, ||q||² and
// q·c_l, each dimension's subspace and codebook offset, each pair's key
// range.
inline size_t wide_side_bytes(int d) {
  const size_t nk = (d + BK - 1) / BK;
  return sizeof(float) * kSides * 2 * BN + sizeof(int) * 6 * kWideBM +
         sizeof(int) * 2 * nk * BK;
}

// One group tile gi (cnt > 0 pairs of one list) by the whole block: the
// tile loop as ivf_pq_group_kernel's, each finished tile's distances
// written to the pairs' rows of the block's scratch with their key range;
// then one warp a pair selects its k best (list_select.cuh).
__device__ __forceinline__ void scan_wide(const WideArgs& a, int gi, int cnt,
                                          float* smem) {
  constexpr int BM = kWideBM;
  const int p = a.p, pq_dim = a.pq_dim, pq_len = a.pq_len, k = a.k;
  const int a_res = a.a_res;
  const int list = a.glist[gi];
  const int start = a.gstart[gi];
  const int c_begin = a.offsets[list];
  const int c_end = c_begin + max(a.sizes[list], 0);
  const int d = pq_dim * pq_len;  // rot_dim
  const int nk = (d + BK - 1) / BK;
  // the query tile resident (a_res 1, or 2 split into its TF32 parts) or
  // a part of every ring stage (0); then the 2 ring stages; the warps'
  // selection space takes their place once the tiles are done
  const int a_floats = a_res * nk * BM * BK;
  const int stage = (a_res ? 0 : BM * BK) + BN * BK;
  const int tile_floats = max(a_floats + 2 * stage,
                              (kThreads / 32) * lsel::kWarpBytes / 4);
  float* a_tile = smem;
  float* ring = smem + a_floats;
  // 3 side slots: the epilogue has no barrier after it, so a tile's slot
  // is written again only two barriers on, whatever nk
  float* sides = smem + tile_floats;
  int* pairs = (int*)(sides + kSides * 2 * BN);  // the group's pairs (-1 past)
  int* qrow = pairs + BM;                        // and their queries
  float* qn_s = (float*)(qrow + BM);             // ||q||² of each
  float* qc_s = qn_s + BM;                       // q·c_l of each
  int* col_sub = (int*)(qc_s + BM);              // a dimension's subspace
  int* col_cb = col_sub + nk * BK;               // and its codebook offset
  unsigned* key_lo = (unsigned*)(col_cb + nk * BK);  // a pair's keys' least
  unsigned* key_hi = key_lo + BM;                    // and greatest

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
    key_lo[r] = lsel::kNone;
    key_hi[r] = 0u;
  }
  for (int c = tid; c < nk * BK; c += kThreads) {
    const int s = c / pq_len;
    col_sub[c] = c < d ? s : -1;
    col_cb[c] = (s * a.book) * pq_len + (c - s * pq_len);
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
  // q·c_l and ||q||² once per group query: warp w takes rows w, w + 8, ...
  for (int r = warp; r < BM; r += kThreads / 32) {
    const int qi = qrow[r];
    float qc = 0.f, qq = 0.f;
    if (qi >= 0) {
      const float* qr = a.q + (size_t)qi * d;
      const float* cl = a.centers + (size_t)list * d;
      for (int c = lane; c < d; c += 32) {
        const float x = qr[c];
        qc = fmaf(x, cl[c], qc);
        qq = fmaf(x, x, qq);
      }
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1) {
      qc += __shfl_xor_sync(RAFT_FULL_MASK, qc, s);
      qq += __shfl_xor_sync(RAFT_FULL_MASK, qq, s);
    }
    if (lane == 0) {
      qc_s[r] = qc;
      qn_s[r] = qq;
    }
  }
  const bool b_exact = a.exact != nullptr && *a.exact != 0;
  const int total = (c_end - c_begin + BN - 1) / BN * nk;

  // the stages as ivf_pq_group_kernel's: codes two stages ahead, codebook
  // values one ahead, stored behind the products; a tile's norms and
  // penalties with its first stage, to side slot tile % 3
  constexpr int kDec = BN * BK / kThreads;  // values a thread decodes
  constexpr unsigned kNoCode = 0xffffffffu;
  unsigned code[kDec];
  float val[kDec];
  float side_v = 0.f;
  auto load_queries = [&](int s) {
    if (!a_res) {
      copy_gather<BM>(ring + (s & 1) * stage, a.q, qrow, (s % nk) * BK, d,
                      a.vec, tid);
    }
  };
  auto fetch_codes = [&](int s) {
    const int tile = s / nk;
    const int sub = col_sub[(s - tile * nk) * BK + lane];
    const int r0 = c_begin + tile * BN + warp;
#pragma unroll
    for (int i = 0; i < kDec; ++i) {
      const int row = r0 + 8 * i;
      code[i] = row < c_end && sub >= 0
                    ? (unsigned)__ldg(a.codes + (size_t)row * pq_dim + sub)
                    : kNoCode;
    }
  };
  auto fetch_values = [&](int s) {
    const int tile = s / nk;
    const int k0 = (s - tile * nk) * BK;
    const float* cbc = a.cb + col_cb[k0 + lane];
#pragma unroll
    for (int i = 0; i < kDec; ++i) {
      val[i] = code[i] != kNoCode ? __ldg(cbc + code[i] * pq_len) : 0.f;
    }
    if (k0 == 0) {
      const int r = c_begin + tile * BN + (tid & (BN - 1));
      const float* src = tid < BN ? a.dn : a.pen;
      side_v = src != nullptr && r < c_end ? src[r] : 0.f;
    }
  };
  auto store_values = [&](int s) {
    const int tile = s / nk;
    float* dst = ring + (s & 1) * stage + (a_res ? 0 : BM * BK);
#pragma unroll
    for (int i = 0; i < kDec; ++i) dst[swz(warp + 8 * i, lane)] = val[i];
    if (s == tile * nk) sides[(tile % kSides) * 2 * BN + tid] = side_v;
  };

  float acc[1][4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;

  if (a_res) {
    for (int kc = 0; kc < nk; ++kc) {
      copy_gather<BM>(a_tile + kc * BM * BK, a.q, qrow, kc * BK, d, a.vec,
                      tid);
    }
  }
  load_queries(0);
  cp_async_commit();
  fetch_codes(0);
  fetch_values(0);
  store_values(0);
  if (total > 1) fetch_codes(1);
  cp_async_wait_all();
  __syncthreads();
  if (a_res == 2) {  // the query tile landed: split it once
    split_tile(a_tile, nk * BM * BK, tid);
    __syncthreads();
  }
  // this thread's rows of the tile: wm·16 + g + 8·h
  float qnr[2], qcr[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = wm * 16 + g + 8 * h;
    qnr[h] = qn_s[r];
    qcr[h] = qc_s[r];
  }
#if RAFT_SCAN_SPLIT == 2
  float kept = 0.f;  // the products alone: their sum, so they stay
#endif
  for (int s = 0; s < total; ++s) {
    // the other slot was last read before the previous barrier
    if (s + 1 < total) {
      load_queries(s + 1);
      fetch_values(s + 1);
    }
    cp_async_commit();
    const float* st = ring + (s & 1) * stage;
    const float* As = a_res ? a_tile + (s % nk) * BM * BK : st;
    const float* Bs = a_res ? st : st + BM * BK;
    stage_dots<1>(acc, As, a_res == 2 ? As + nk * BM * BK : nullptr, Bs,
                  b_exact, lane, wm, wn);
    if (s + 1 < total) store_values(s + 1);
    if (s + 2 < total) fetch_codes(s + 2);
    cp_async_wait_all();
    __syncthreads();
    if (s % nk != nk - 1) continue;

    // ---- the tile's dots are complete: its distances to the rows ----
    const int tile = s / nk;
    const int c0 = c_begin + tile * BN;
#if RAFT_SCAN_SPLIT == 2
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        kept += acc[0][j][e];
        acc[0][j][e] = 0.f;
      }
    continue;
#endif
    const float* side = sides + (tile % kSides) * 2 * BN;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e1 = 0; e1 < 2; ++e1) {
        const int lc = wn * 32 + 8 * j + 2 * t4 + e1;
        const bool past = c0 + lc >= c_end;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float dot = acc[0][j][2 * h + e1];
          float dist;
          if (a.metric == 0) {
            dist = fmaxf(__fadd_rn(__fsub_rn(__fadd_rn(qnr[h], side[lc]),
                                             __fmul_rn(2.f, qcr[h])),
                                   __fmul_rn(-2.f, dot)),
                         0.f);
          } else {
            dist = __fadd_rn(-qcr[h], __fmul_rn(-1.f, dot));
          }
          if (a.pen != nullptr) dist = __fadd_rn(dist, side[BN + lc]);
          acc[0][j][2 * h + e1] = past ? CUDART_INF_F : dist;
        }
      }
    }
#if RAFT_SCAN_SPLIT == 1
    {  // the distances alone: their sum, so they stay
      float kept = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) kept += acc[0][j][e];
      if (__float_as_uint(kept) == 0x7fc00001u) a.out_v[0] = kept;
    }
#else
    // each pair's distances to its row of the block's rows, and its keys'
    // range
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = wm * 16 + g + 8 * h;
      float* dst = a.rows + ((size_t)blockIdx.x * BM + r) * a.stride +
                   tile * BN + wn * 32 + 2 * t4;
      unsigned lo = lsel::kNone, hi = 0u;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float v0 = acc[0][j][2 * h], v1 = acc[0][j][2 * h + 1];
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(v0, v1);
        lsel::widen_range(v0, lo, hi);
        lsel::widen_range(v1, lo, hi);
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        lo = min(lo, __shfl_xor_sync(RAFT_FULL_MASK, lo, off));
        hi = max(hi, __shfl_xor_sync(RAFT_FULL_MASK, hi, off));
      }
      if (t4 == 0 && lo <= hi) {
        atomicMin(&key_lo[r], lo);
        atomicMax(&key_hi[r], hi);
      }
    }
#endif
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[0][j][e] = 0.f;
  }
#if RAFT_SCAN_SPLIT == 2
  if (__float_as_uint(kept) == 0x7fc00001u) a.out_v[0] = kept;
#endif
#if RAFT_SCAN_SPLIT == 0
  // the rows are written: one warp a pair selects its k best
  __syncthreads();
  unsigned char* ws =
      reinterpret_cast<unsigned char*>(smem) + warp * lsel::kWarpBytes;
  const int n = c_end - c_begin;
  for (int r = warp; r < cnt; r += kThreads / 32) {
    const size_t o = (size_t)pairs[r] * k;
    lsel::select_row(a.rows + ((size_t)blockIdx.x * BM + r) * a.stride, n,
                     key_lo[r], key_hi[r], k, ws, a.out_v + o, a.out_i + o,
                     c_begin, lane);
  }
#endif
}

// Persistent blocks, two an SM, each with its 32 distance rows; a block
// takes groups blockIdx.x, then the counter's.
__global__ void __launch_bounds__(kThreads, 2)
ivf_pq_wide_kernel(const WideArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int next;
  int gi = blockIdx.x;
  while (gi < a.n_groups) {
    const int cnt = a.gcount[gi];
    if (cnt <= 0) break;  // past the live groups, which come first
    scan_wide(a, gi, cnt, smem);
    if (threadIdx.x == 0) next = atomicAdd(a.counter, 1) + gridDim.x;
    __syncthreads();
    gi = next;
  }
}

struct Plan {
  const void* kern;
  size_t smem;
  int bm, a_res, ns;
  bool wide;
};

template <int MF, int R, int CAP, int RB = R>
cudaError_t prepare(int k, int d, Plan* p) {
  constexpr int BM = 32 * MF;
  const size_t nk = (d + BK - 1) / BK;
  p->kern = (const void*)ivf_pq_group_kernel<MF, R, CAP, RB>;
  p->bm = BM;
  p->wide = false;
  p->smem = fit_tiles(BM, d, 2,
                      list_bytes(BM, k, CAP) + sizeof(float) * 2 * 2 * BN +
                          sizeof(int) * 4 * BM + sizeof(int) * 2 * nk * BK,
                      &p->a_res, &p->ns);
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

// The wide plan: 32 queries a group; the tiles (the first layout of
// fit_tiles that leaves room for two blocks an SM, else one) share their
// space with the warps' selection space, whichever is larger; beside the
// dynamic bytes, one 128-byte unit of static ones (the next group).
constexpr size_t kTwoBlocks = 115712;  // (233,472 - 2 x 1 KB reserved) / 2
constexpr size_t kStaticUnit = 128;
cudaError_t prepare_wide(int d, Plan* p) {
  constexpr int BM = kWideBM;
  constexpr size_t kSel = (kThreads / 32) * lsel::kWarpBytes;
  const size_t nk = (d + BK - 1) / BK;
  p->kern = (const void*)ivf_pq_wide_kernel;
  p->bm = BM;
  p->wide = true;
  p->smem = 0;
  p->ns = 2;
  const size_t fixed = wide_side_bytes(d);
  const size_t limits[2] = {kTwoBlocks, kSmemLimit};
  for (size_t limit : limits) {
    for (int a = 2; a >= 0 && p->smem == 0; --a) {
      size_t tiles = sizeof(float) * (a * nk * BM * BK +
                                      2 * ((a ? 0 : BM * BK) + BN * BK));
      if (tiles < kSel) tiles = kSel;
      if (tiles + fixed + kStaticUnit <= limit) {
        p->smem = tiles + fixed;
        p->a_res = a;
      }
    }
    if (p->smem != 0) break;
  }
  if (p->smem == 0) return cudaErrorInvalidValue;
  return cudaFuncSetAttribute(p->kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)p->smem);
}

// By k, as K3 (ivf_flat_scan.cuh::plan_for, whose comment gives the
// plans; ops/ivf_scan.py::group_plan and group_smem state them in
// Python); past 256 K4's own plan.
cudaError_t plan_for(int k, int d, Plan* p) {
  if (k <= 32) return prepare<4, 1, 32>(k, d, p);
  if (k <= 64) return prepare<4, 2, 64>(k, d, p);
  if (k <= 128) return prepare<2, 4, 128>(k, d, p);
  if (k <= 256) return prepare<2, 8, 64>(k, d, p);
  return prepare_wide(d, p);
}

// The wide plan's persistent grid on the current card: blocks an SM and
// in all.
cudaError_t wide_blocks(const Plan& pl, int* per_sm, int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, pl.kern,
                                                      kThreads, pl.smem);
  if (err != cudaSuccess) return err;
  if (*per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = *per_sm * sms;
  return cudaSuccess;
}

// Bytes of the wide plan's scratch: the counter, then 32 rows of
// `stride` floats a block.
inline size_t wide_scratch(int blocks, int stride) {
  return 256 + sizeof(float) * (size_t)blocks * 32 * stride;
}
inline int row_stride(int lmax) { return (lmax + BN - 1) / BN * BN; }

// ---- the per-pair form ----

constexpr int kPairThreads = 256;  // rows per tile = threads of a block

__global__ void __launch_bounds__(kPairThreads)
ivf_pq_pair_kernel(const uint8_t* __restrict__ codes,
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
  float* cand = qs + rot_dim;           // kPairThreads
  float* lv = cand + kPairThreads;      // k
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
    for (int j = tid; j < k; j += kPairThreads) {
      out_v[o + j] = CUDART_INF_F;
      out_i[o + j] = -1;
    }
    return;
  }

  for (int c = tid; c < rot_dim; c += kPairThreads) {
    qs[c] = q[(size_t)qi * rot_dim + c];
  }
  for (int j = tid; j < k; j += kPairThreads) {
    lv[j] = CUDART_INF_F;
    li[j] = INT_MAX;
  }
  __syncthreads();

  for (int e = tid; e < entries; e += kPairThreads) {
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

  for (int r0 = 0; r0 < size; r0 += kPairThreads) {
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
      for (int h = 0; h < kPairThreads; h += 32) {
        warp_offer(lv, li, k, cand[h + lane], off + r0 + h + lane, lane);
      }
    }
    __syncthreads();
  }

  for (int j = tid; j < k; j += kPairThreads) {
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
// rotated queries. metric: 0 = squared L2, 1 = inner product (-dot).
//
// The grouped form: exact points to an int, nonzero when every cb value
// is exact in TF32 (or is null); order is the stable sort of the m*p
// pairs by list id; group g of the n_groups (pack_pairs) scans list
// glist[g] for the gcount[g] pairs order[gstart[g] ...] (none past the
// live groups); qg must be the form's rows for k (128 up to k = 64, 64
// up to 256, 32 up to 512). 1 <= k <= 512. Past k = 256 scratch holds
// raft_ivf_pq_scan_group_scratch(k, d, lmax) bytes of device memory and
// no list is longer than lmax rows (below, scratch may be null).
extern "C" int raft_ivf_pq_scan_group(
    const void* codes, const void* dn, const void* pen, const void* cb,
    const void* centers, const void* q, const void* exact,
    const void* order, const void* glist, const void* gstart,
    const void* gcount, const void* offsets, const void* sizes,
    void* scratch, int n_groups, int qg, int p, int pq_dim, int pq_len,
    int book, int k, int metric, int lmax, void* out_v, void* out_i,
    void* stream) {
  const int d = pq_dim * pq_len;
  if (k < 1 || k > kGroupMaxK || d < 1 || n_groups < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  cudaError_t err = plan_for(k, d, &pl);
  if (err != cudaSuccess) return (int)err;
  if (pl.bm != qg) return (int)cudaErrorInvalidValue;
  if (pl.wide && (scratch == nullptr || lmax < 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_groups == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int vec = d % 4 == 0 && (uintptr_t)q % 16 == 0;
  if (pl.wide) {
    int per_sm = 0, blocks = 0;
    err = wide_blocks(pl, &per_sm, &blocks);
    if (err != cudaSuccess) return (int)err;
    WideArgs a{(const uint8_t*)codes, (const float*)dn, (const float*)pen,
               (const float*)cb, (const float*)centers, (const float*)q,
               (const int*)exact, (const int*)order, (const int*)glist,
               (const int*)gstart, (const int*)gcount, (const int*)offsets,
               (const int*)sizes, n_groups, p, pq_dim, pq_len, book, k,
               metric, vec, pl.a_res, (float*)out_v, (int*)out_i,
               (int*)scratch, (float*)((char*)scratch + 256),
               row_stride(lmax)};
    void* args[] = {(void*)&a};
    err = cudaMemsetAsync(scratch, 0, sizeof(int), s);
    if (err != cudaSuccess) return (int)err;
    err = cudaLaunchKernel(pl.kern, dim3(n_groups < blocks ? n_groups
                                                           : blocks),
                           dim3(kThreads), args, pl.smem, s);
  } else {
    void* args[] = {(void*)&codes,  (void*)&dn,     (void*)&pen,
                    (void*)&cb,     (void*)&centers, (void*)&q,
                    (void*)&exact,  (void*)&order,  (void*)&glist,
                    (void*)&gstart, (void*)&gcount, (void*)&offsets,
                    (void*)&sizes,  (void*)&p,      (void*)&pq_dim,
                    (void*)&pq_len, (void*)&book,   (void*)&k,
                    (void*)&metric, (void*)&vec,    (void*)&pl.a_res,
                    (void*)&out_v,  (void*)&out_i};
    err = cudaLaunchKernel(pl.kern, dim3(n_groups), dim3(kThreads), args,
                           pl.smem, s);
  }
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The grouped form's plan for (k, d = pq_dim·pq_len): out[0..4) = the
// queries a group, the query tile's layout (a_res), the ring's stages and
// the shared memory of a block.
extern "C" int raft_ivf_pq_scan_group_plan(int k, int d, int* out) {
  if (k < 1 || k > kGroupMaxK || d < 1) return (int)cudaErrorInvalidValue;
  Plan pl;
  const cudaError_t err = plan_for(k, d, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = pl.bm;
  out[1] = pl.a_res;
  out[2] = pl.ns;
  out[3] = (int)pl.smem;
  return 0;
}

// The grouped form's scratch for (k, d, lmax) on the current card: out[0]
// = its bytes (0: the plan needs none), out[1] = the persistent blocks,
// out[2] = the blocks an SM keeps resident (0 and 0 below k = 257).
extern "C" int raft_ivf_pq_scan_group_scratch(int k, int d, int lmax,
                                              long long* out) {
  if (k < 1 || k > kGroupMaxK || d < 1 || lmax < 0) {
    return (int)cudaErrorInvalidValue;
  }
  Plan pl;
  cudaError_t err = plan_for(k, d, &pl);
  if (err != cudaSuccess) return (int)err;
  out[0] = out[1] = out[2] = 0;
  if (!pl.wide) return 0;
  int per_sm = 0, blocks = 0;
  err = wide_blocks(pl, &per_sm, &blocks);
  if (err != cudaSuccess) return (int)err;
  out[0] = (long long)wide_scratch(blocks, row_stride(lmax > 0 ? lmax : 1));
  out[1] = blocks;
  out[2] = per_sm;
  return 0;
}

// The per-pair form: probed is (m, p), order a permutation of the m*p
// pairs (the launch order); k up to 1024.
extern "C" int raft_ivf_pq_scan_pair(const void* codes, const void* dn,
                                     const void* pen, const void* cb,
                                     const void* centers, const void* q,
                                     const void* probed, const void* order,
                                     const void* offsets, const void* sizes,
                                     int m, int p, int pq_dim, int pq_len,
                                     int book, int k, int metric,
                                     void* out_v, void* out_i,
                                     void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)pq_dim * book + (size_t)pq_dim * pq_len +
                       kPairThreads) +
      (sizeof(float) + sizeof(int)) * (size_t)k;
  cudaError_t err = cudaFuncSetAttribute(
      ivf_pq_pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int vec16 =
      pq_dim % 16 == 0 && (reinterpret_cast<uintptr_t>(codes) & 15) == 0;
  const long long pairs = (long long)m * p;
  if (pairs > 0) {
    ivf_pq_pair_kernel<<<(unsigned)pairs, kPairThreads, smem,
                         (cudaStream_t)stream>>>(
        (const uint8_t*)codes, (const float*)dn, (const float*)pen,
        (const float*)cb, (const float*)centers, (const float*)q,
        (const int*)probed, (const int*)order, (const int*)offsets,
        (const int*)sizes, p, pq_dim, pq_len, book, k, metric, vec16,
        (float*)out_v, (int*)out_i);
  }
  return (int)cudaGetLastError();
}
