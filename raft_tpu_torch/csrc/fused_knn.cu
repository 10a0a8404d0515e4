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
#include "tf32_tile.cuh"

namespace {

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
    split_tile(a_tile, nk * BM * BK, tid);
  }
  for (int s = 0; s < total; ++s) {
    if (s + ns - 1 < total) load(s + ns - 1);
    cp_async_commit();
    cp_async_wait_stage(ns);  // stage s (and the query tile) landed
    __syncthreads();
    const float* st = ring + (s % ns) * stage;
    const float* As = a_res ? a_tile + (s % nk) * BM * BK : st;
    const float* Bs = a_res ? st : st + BM * BK;
    stage_dots<MF>(acc, As, a_res == 2 ? As + nk * BM * BK : nullptr, Bs,
                   false, lane, wm, wn);
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
  p->kern = (const void*)fused_knn_kernel<MF, R, CAP, METRIC>;
  p->bm = BM;
  p->smem = fit_tiles(BM, d, 3,
                      list_bytes(BM, k, CAP) + sizeof(float) * 4 * 2 * BN,
                      &p->a_res, &p->ns);
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
