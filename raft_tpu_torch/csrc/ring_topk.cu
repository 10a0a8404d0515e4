// K7 and K8 — the cross-shard top-k merge: one hop's fold, and the whole
// ring in one launch.
//
// K7 replaces the TPU kernel raft_tpu/ops/ring_topk.py::_merge_step_pallas
// (kernel _merge_step_kernel, fold _vmem_fold): the k best cells of the
// concatenation of an (m, w1) running list and an (m, w2) arriving block
// under the total order (±distance, position), carrying each cell's
// global id. K8 replaces ::_ring_pallas (kernel _ring_kernel): p shards'
// (m, k) candidate lists merged into one (m, k) list that every shard
// holds, in p−1 hops with no host step between them.
//
// K7 on Hopper: sort once, merge by ranks. Each of the two lists is
// sorted by (order key, position, index) — the inputs need not be sorted
// — and a cell's rank in the merged list is its index in its own sorted
// list plus a binary-search count of the other list's cells before it
// (on equal (key, position) the running list's cells come first, as
// their concat index is lower); a cell whose rank is below k is written
// to that output slot. Two forms, by W = max(w1, w2):
// W <= 32, a row takes G = the next power of two >= W lanes, 32 / G rows
// a warp, each lane one cell of each list in registers: the sorts are
// bitonic networks of shuffles and the rank searches binary searches over
// shuffles (K8's lane-group form with the index as a third key). W > 32,
// a row takes a warp and its cells (key, position, index: 12 B a cell)
// are staged in shared memory: warp_sort_cells (a bitonic network whose
// first step in each stage compares mirrored cells, so cells past the
// list's end never move and take no storage), then binary searches over
// the other sorted list; this covers every k <= w1 + w2 and w1 + w2 up to
// 16,384. A cell carries only its key, position and index through the
// sort; its distance and id are read again by index when it is written.
// The TPU's k extraction passes (and its padding of rows to 8 and k to
// 128) have no counterpart. Bound on this card: bytes — 12 B per input
// cell and 12 B per output cell; the sorts' O(w log² w) compares a row
// are this design's, not the function's.
//
// K8 on Hopper, after _ring_kernel's slot discipline: every block of the
// ring is resident at once (a cooperative launch, which refuses a grid
// that cannot be), one block per (shard, b). Block b of every shard owns
// the same rows [b·T, min(m, (b+1)·T)), T = ceil(m / B), so each block
// takes exactly p − 1 hop steps. The running lists live in
// the shard's outputs (out_d, out_g, plus run_p: each cell's position),
// in device memory that stays in L2, so T is not bounded by shared
// memory. Hop 0 sorts each own row by (order key, index) and writes the
// sorted copy as the running list and into the right neighbour's slot 0;
// from then on every list that arrives is sorted, and a hop merges two
// sorted lists. A cell carries (its shard)·k + (its index in its shard's
// sorted list) as its position, which orders cells as their true
// positions do (lexfold.cuh). Three forms of the row work, by k:
// k <= 32, a row takes the next power of two >= k lanes, several rows a
// warp, each cell in a register of its lane; the sort is a bitonic
// network of shuffles and a cell's rank in the merge is its index plus a
// binary-search count (over shuffles) of the other list's cells before
// it. 32 < k <= 256, a row takes a warp, C = the next power of two >= k
// cells in registers; the sort is a bitonic network, and the merge keeps
// the elementwise smaller of the running list and the arriving list
// reversed (the C smallest of both, a bitonic sequence) and
// bitonic-merges it. k > 256, a row takes a warp and is staged in shared
// memory: lexfold::warp_sort_pairs, then lexfold::warp_merge_ranks
// (ranks by binary search over shared memory). At hop h ≥ 1 a block
// forwards what arrived at h − 1 from its slot (h − 1) % 2 into its right
// neighbour's slot h % 2 (its own rows of an (m, k) slot, contiguous),
// raises that neighbour's arrival flag, credits its left neighbour for
// the slot it just forwarded, waits on its own flag and merges; a write
// into slot h % 2 from hop 2 on first waits for the credit of hop h − 2.
// The slots and flags live in each shard's device memory: on one card
// the neighbour's slot is local memory, across cards a peer pointer (the
// cross-card mode: one launch per card, __threadfence_system, after the
// wrapper enables peer access). Flags count hops, only grow within a
// call and are zeroed before each call (one buffer a card, with the
// status word), so nothing leaks from one call into the next; a block
// writes into a neighbour only what that neighbour waits for, so no
// write lands after its owner has finished. A wait that passes
// kTimeoutNs sets the status word and ends the block, so a fault is an
// error the wrapper raises, not a hung card. Bound on one card: bytes —
// each shard's input read once and its output written once; the slot
// and running-list traffic a hop (in L2) and the sort and merge compares
// are this design's, not the merge's.
#include "lexfold.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

constexpr int kStepWarps = 8;               // rows (or row groups) a block
constexpr size_t kStepSmemTarget = 48 * 1024;

struct StepArgs {
  const float* rd;  // the running list, (m, w1)
  const int* rp;
  const int* rg;
  const float* bd;  // the arriving block, (m, w2)
  const int* bp;
  const int* bg;
  float* od;        // the k best, (m, k)
  int* op;
  int* og;
  int w1, w2, m, k;
  float sign;       // -1 for a max merge
};

// Write cell `idx` of the running list (or of the block) of `row`, whose
// position is `pos`, to output slot `rank`.
__device__ __forceinline__ void step_emit(const StepArgs& a, size_t row,
                                          bool from_b, int idx, int pos,
                                          int rank) {
  const size_t o = row * a.k + rank;
  if (from_b) {
    const size_t i = row * a.w2 + idx;
    a.od[o] = a.bd[i];
    a.og[o] = a.bg[i];
  } else {
    const size_t i = row * a.w1 + idx;
    a.od[o] = a.rd[i];
    a.og[o] = a.rg[i];
  }
  a.op[o] = pos;
}

// Ascending bitonic sort of one cell a lane over the G lanes of a group.
__device__ __forceinline__ void lane_sort(int& key, int& pos, int& idx,
                                          int G, int gl) {
  for (int s = 2; s <= G; s <<= 1) {
    for (int j = s >> 1; j > 0; j >>= 1) {
      const int ok = __shfl_xor_sync(RAFT_FULL_MASK, key, j, G);
      const int op = __shfl_xor_sync(RAFT_FULL_MASK, pos, j, G);
      const int oi = __shfl_xor_sync(RAFT_FULL_MASK, idx, j, G);
      const bool keep_min = ((gl & j) == 0) == ((gl & s) == 0);
      if (keep_min == lexfold::lex_before(ok, op, oi, key, pos, idx)) {
        key = ok;
        pos = op;
        idx = oi;
      }
    }
  }
}

// Lists of at most 32 cells: a lane group a row.
__global__ void __launch_bounds__(kStepWarps * 32)
merge_step_lanes(StepArgs a, int G) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane / G, gl = lane % G;
  const long long r = ((long long)blockIdx.x * kStepWarps + warp) * (32 / G)
                      + grp;
  const bool live = r < a.m;  // every lane runs the shuffles
  const size_t row = live ? (size_t)r : 0;
  // an absent cell (INT_MAX, INT_MAX, INT_MAX) sorts after every cell
  int ak = INT_MAX, ap = INT_MAX, ai = INT_MAX;
  int bk = INT_MAX, bp = INT_MAX, bi = INT_MAX;
  if (live && gl < a.w1) {
    ak = lexfold::order_key(a.sign * a.rd[row * a.w1 + gl]);
    ap = a.rp[row * a.w1 + gl];
    ai = gl;
  }
  if (live && gl < a.w2) {
    bk = lexfold::order_key(a.sign * a.bd[row * a.w2 + gl]);
    bp = a.bp[row * a.w2 + gl];
    bi = gl;
  }
  lane_sort(ak, ap, ai, G, gl);
  lane_sort(bk, bp, bi, G, gl);
  // my running cell counts the block's cells strictly before it; my
  // block cell the running cells at or before its (key, position)
  int cb = 0, ca = 0;
  for (int step = G; step > 0; step >>= 1) {
    const int eb = cb + step - 1, ea = ca + step - 1;
    const int kb = __shfl_sync(RAFT_FULL_MASK, bk, min(eb, G - 1), G);
    const int pb = __shfl_sync(RAFT_FULL_MASK, bp, min(eb, G - 1), G);
    const int ka = __shfl_sync(RAFT_FULL_MASK, ak, min(ea, G - 1), G);
    const int pa = __shfl_sync(RAFT_FULL_MASK, ap, min(ea, G - 1), G);
    if (eb < a.w2 && (kb < ak || (kb == ak && pb < ap))) cb += step;
    if (ea < a.w1 && (ka < bk || (ka == bk && pa <= bp))) ca += step;
  }
  if (live && gl < a.w1 && gl + cb < a.k) step_emit(a, row, false, ai, ap,
                                                    gl + cb);
  if (live && gl < a.w2 && gl + ca < a.k) step_emit(a, row, true, bi, bp,
                                                    gl + ca);
}

// Sort the n cells (key, pos, idx) in shared memory ascending, in place,
// with one warp: a bitonic network over the next power of two >= n whose
// stages all sort ascending (the first step of a stage compares cell o of
// a block with cell s − 1 − o), so the cells past n, after every cell,
// never move and are never read. The caller syncs the warp before.
__device__ void warp_sort_cells(int* key, int* pos, int* idx, int n,
                                int lane) {
  int n2 = 1;
  while (n2 < n) n2 <<= 1;
  for (int s = 2; s <= n2; s <<= 1) {
    for (int j = s >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (n2 >> 1); t += 32) {
        const int o = t & (j - 1);
        const int base = (t & ~(j - 1)) << 1;
        const int i = base + o;
        const int q = j == (s >> 1) ? base + s - 1 - o : i + j;
        if (q < n) {
          const int ki = key[i], pi = pos[i], ii = idx[i];
          const int kq = key[q], pq = pos[q], iq = idx[q];
          if (lexfold::lex_before(kq, pq, iq, ki, pi, ii)) {
            key[i] = kq;
            pos[i] = pq;
            idx[i] = iq;
            key[q] = ki;
            pos[q] = pi;
            idx[q] = ii;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Lists of more than 32 cells: a warp a row, 12 B a cell in shared memory.
__global__ void __launch_bounds__(kStepWarps * 32)
merge_step_smem(StepArgs a) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * warps + warp;
  if (r >= a.m) return;  // warps are independent: no block barrier
  const size_t row = (size_t)r;
  const int w1 = a.w1, w2 = a.w2, k = a.k;
  int* ak = smem + (size_t)warp * 3 * (w1 + w2);
  int* ap = ak + w1;
  int* ai = ap + w1;
  int* bk = ai + w1;
  int* bp = bk + w2;
  int* bi = bp + w2;
  for (int c = lane; c < w1; c += 32) {
    ak[c] = lexfold::order_key(a.sign * a.rd[row * w1 + c]);
    ap[c] = a.rp[row * w1 + c];
    ai[c] = c;
  }
  for (int c = lane; c < w2; c += 32) {
    bk[c] = lexfold::order_key(a.sign * a.bd[row * w2 + c]);
    bp[c] = a.bp[row * w2 + c];
    bi[c] = c;
  }
  __syncwarp();
  warp_sort_cells(ak, ap, ai, w1, lane);
  warp_sort_cells(bk, bp, bi, w2, lane);
  for (int i = lane; i < w1 && i < k; i += 32) {
    const int key = ak[i], pos = ap[i];
    int lo = 0, hi = min(w2, k - i);  // the block's cells before mine
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (bk[mid] < key || (bk[mid] == key && bp[mid] < pos)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (i + lo < k) step_emit(a, row, false, ai[i], pos, i + lo);
  }
  for (int j = lane; j < w2 && j < k; j += 32) {
    const int key = bk[j], pos = bp[j];
    int lo = 0, hi = min(w1, k - j);  // the running cells at or before
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (ak[mid] < key || (ak[mid] == key && ap[mid] <= pos)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (j + lo < k) step_emit(a, row, true, bi[j], pos, j + lo);
  }
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int kMaxShards = 16;
constexpr int kWarps = 4;                // rows in flight a block, one a warp
constexpr int kThreads = kWarps * 32;
constexpr unsigned long long kTimeoutNs = 2000000000ull;

struct RingArgs {
  const float* in_d[kMaxShards];  // per shard (m, k)
  const int* in_g[kMaxShards];
  float* out_d[kMaxShards];       // per shard (m, k): the running list
  int* out_g[kMaxShards];
  int* run_p[kMaxShards];         // per shard (m, k): each cell's position
  float* slot_d[kMaxShards];      // per shard (2, m, k): its slots
  int* slot_g[kMaxShards];
  int* flags[kMaxShards];         // per shard (2, B): arrivals, credits
  int shard[kMaxShards];          // blockIdx.y -> shard
  int* status;                    // set to 1 on a timeout
  int p, m, k, rows, negate, system;
};

// the shared-memory form's warp: the running row (d, gid, position) and
// the arriving one (d, gid); hop 0's sort uses the first 2·k2 < 4·k words
__host__ __device__ inline size_t ring_smem(int k) {
  return (size_t)kWarps * 5 * k * sizeof(int);
}

__device__ __forceinline__ int load_acquire(const int* f, int system) {
  int v;
  if (system) {
    asm volatile("ld.acquire.sys.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(f) : "memory");
  } else {
    asm volatile("ld.acquire.gpu.global.b32 %0, [%1];"
                 : "=r"(v) : "l"(f) : "memory");
  }
  return v;
}

__device__ __forceinline__ void store_release(int* f, int v, int system) {
  if (system) {
    asm volatile("st.release.sys.global.b32 [%0], %1;"
                 :: "l"(f), "r"(v) : "memory");
  } else {
    asm volatile("st.release.gpu.global.b32 [%0], %1;"
                 :: "l"(f), "r"(v) : "memory");
  }
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Thread 0 waits, with acquire loads, until *f >= target or kTimeoutNs
// pass; the whole block learns which. Called by every thread.
__device__ bool block_wait(const int* f, int target, int system, int* s_ok) {
  if (threadIdx.x == 0) {
    int ok = 1;
    const unsigned long long t0 = now_ns();
    while (load_acquire(f, system) < target) {
      if (now_ns() - t0 > kTimeoutNs) {
        ok = 0;
        break;
      }
      __nanosleep(32);
    }
    *s_ok = ok;
  }
  __syncthreads();
  const bool ok = *s_ok != 0;
  __syncthreads();  // s_ok is rewritten by the next wait
  return ok;
}

// Publish every thread's earlier writes (and the end of its reads), then
// set *f = value: a fence by each thread, a barrier, thread 0's release
// store. Called by every thread.
__device__ void block_signal(int* f, int value, int system) {
  if (system) {
    __threadfence_system();
  } else {
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) store_release(f, value, system);
}

// The rows of block b, at the shard the block serves. A running cell's
// position is (its shard)·k + (its index in its shard's sorted list),
// which orders cells as their true positions do (lexfold.cuh).
struct RingRows {
  const float* in_d;
  const int* in_g;
  float* out_d;
  int* out_g;
  int* run_p;
  float* right_d;  // the right neighbour's slot 0
  int* right_g;
  int row0, row1, k, r;
  float sign;
};

__device__ __forceinline__ bool cell_less(int ka, int pa, int kb, int pb) {
  return ka < kb || (ka == kb && pa < pb);
}

// ---- lists of k <= 32 cells: a lane group a row ---------------------------
// G = the next power of two >= k lanes a row, 32 / G rows a warp at once,
// every cell in a register of its own lane: the sort and the rank
// searches are shuffles within the row's lanes. Every lane of the warp
// runs the same steps (the shuffles take the full mask); a lane without a
// cell carries the empty key.
__device__ __forceinline__ int group_width(int k) {
  int g = 1;
  while (g < k) g <<= 1;
  return g;
}

// Hop 0: sort each own row by (order key, index) into the running list
// and the right neighbour's slot 0.
__device__ void sort_rows_lanes(const RingRows& w, int warp, int lane) {
  const int k = w.k, G = group_width(k), per_warp = 32 / G;
  const int grp = lane / G, gl = lane % G;
  for (int base = w.row0 + warp * per_warp; base < w.row1;
       base += kWarps * per_warp) {
    const int row = base + grp;
    const bool live = row < w.row1 && gl < k;
    const size_t io = (size_t)row * k;
    float d = 0.f;
    int g = 0, key = INT_MAX, idx = gl;  // idx >= k sorts after any NaN
    if (live) {
      d = w.in_d[io + gl];
      g = w.in_g[io + gl];
      key = lexfold::order_key(w.sign * d);
    }
    for (int s = 2; s <= G; s <<= 1) {
      for (int j = s >> 1; j > 0; j >>= 1) {
        const int ok = __shfl_xor_sync(RAFT_FULL_MASK, key, j, G);
        const int oi = __shfl_xor_sync(RAFT_FULL_MASK, idx, j, G);
        const float od = __shfl_xor_sync(RAFT_FULL_MASK, d, j, G);
        const int og = __shfl_xor_sync(RAFT_FULL_MASK, g, j, G);
        const bool keep_min = ((gl & j) == 0) == ((gl & s) == 0);
        if (keep_min == cell_less(ok, oi, key, idx)) {
          key = ok;
          idx = oi;
          d = od;
          g = og;
        }
      }
    }
    if (live) {
      w.out_d[io + gl] = d;
      w.out_g[io + gl] = g;
      w.run_p[io + gl] = w.r * k + gl;
      w.right_d[io + gl] = d;
      w.right_g[io + gl] = g;
    }
  }
}

// Hop h: merge the block of shard src (slot `arr`) into each running row.
// A cell's rank is its index plus the count of the other list's cells
// before it, found by a binary search over shuffles.
__device__ void merge_rows_lanes(const RingRows& w, const float* arr_d,
                                 const int* arr_g, int src, int warp,
                                 int lane) {
  const int k = w.k, G = group_width(k), per_warp = 32 / G;
  const int grp = lane / G, gl = lane % G;
  const int stride = kWarps * per_warp;
  const int pb0 = src * k;  // the arriving cell j's position: pb0 + j
  // the row's cells, loaded one row ahead so the loads overlap the work
  float nrd = 0.f, nad = 0.f;
  int nrg = 0, nrp = 0, nag = 0;
  auto load = [&](int row) {
    if (row < w.row1 && gl < k) {
      const size_t io = (size_t)row * k + gl;
      nrd = __ldcg(w.out_d + io);
      nrg = __ldcg(w.out_g + io);
      nrp = __ldcg(w.run_p + io);
      nad = __ldcg(arr_d + io);
      nag = __ldcg(arr_g + io);
    }
  };
  load(w.row0 + warp * per_warp + grp);
  for (int base = w.row0 + warp * per_warp; base < w.row1;
       base += stride) {
    const int row = base + grp;
    const bool live = row < w.row1 && gl < k;
    const size_t io = (size_t)row * k;
    const float rd = nrd, ad = nad;
    const int rg = nrg, rp = nrp, ag = nag;
    __syncwarp();  // every read of the row before any write to it
    load(row + stride);
    const int rk = live ? lexfold::order_key(w.sign * rd) : INT_MAX;
    const int ak = live ? lexfold::order_key(w.sign * ad) : INT_MAX;
    const int ap = pb0 + gl;
    int cr = 0, ca = 0;  // cells of the other list before mine
    for (int step = G; step > 0; step >>= 1) {
      const int er = cr + step - 1, ea = ca + step - 1;
      const int ka = __shfl_sync(RAFT_FULL_MASK, ak, min(er, G - 1), G);
      const int kr = __shfl_sync(RAFT_FULL_MASK, rk, min(ea, G - 1), G);
      const int pr = __shfl_sync(RAFT_FULL_MASK, rp, min(ea, G - 1), G);
      if (er < k && cell_less(ka, pb0 + er, rk, rp)) cr += step;
      if (ea < k && cell_less(kr, pr, ak, ap)) ca += step;
    }
    if (live && gl + cr < k) {
      w.out_d[io + gl + cr] = rd;
      w.out_g[io + gl + cr] = rg;
      w.run_p[io + gl + cr] = rp;
    }
    if (live && gl + ca < k) {
      w.out_d[io + gl + ca] = ad;
      w.out_g[io + gl + ca] = ag;
      w.run_p[io + gl + ca] = ap;
    }
  }
}

// ---- lists of 32 < k <= 256 cells: a warp a row, in registers -------------
// C = 32·R >= k cells a row, cell e in register e / 32 of lane e % 32, the
// empty cell (INT_MAX, INT_MAX) past k. Hop 0 sorts with a bitonic network
// (shuffles across lanes, swaps within a lane); a hop loads the arriving
// list reversed (descending), keeps the elementwise smaller of the two
// lists — the C smallest of both, as a bitonic sequence — and
// bitonic-merges it: no shared memory, no search.
template <int R>
struct Cells {
  int key[R];
  int pos[R];
  float d[R];
  int g[R];
};

// One compare-exchange step over the C cells, partners at distance j;
// cell e ends ascending against its partner when (e & s) == 0.
template <int R>
__device__ __forceinline__ void cells_step(Cells<R>& c, int s, int j,
                                           int lane) {
  if (j >= 32) {
    const int jr = j >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & jr) continue;
      const int r2 = r | jr;
      const bool asc = ((r * 32 + lane) & s) == 0;
      const bool swap = asc ? cell_less(c.key[r2], c.pos[r2], c.key[r],
                                        c.pos[r])
                            : cell_less(c.key[r], c.pos[r], c.key[r2],
                                        c.pos[r2]);
      if (swap) {
        const int tk = c.key[r], tp = c.pos[r], tg = c.g[r];
        const float td = c.d[r];
        c.key[r] = c.key[r2];
        c.pos[r] = c.pos[r2];
        c.d[r] = c.d[r2];
        c.g[r] = c.g[r2];
        c.key[r2] = tk;
        c.pos[r2] = tp;
        c.d[r2] = td;
        c.g[r2] = tg;
      }
    }
  } else {
    const bool lower = (lane & j) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int ok = __shfl_xor_sync(RAFT_FULL_MASK, c.key[r], j);
      const int op = __shfl_xor_sync(RAFT_FULL_MASK, c.pos[r], j);
      const float od = __shfl_xor_sync(RAFT_FULL_MASK, c.d[r], j);
      const int og = __shfl_xor_sync(RAFT_FULL_MASK, c.g[r], j);
      const bool asc = ((r * 32 + lane) & s) == 0;
      if ((lower == asc) == cell_less(ok, op, c.key[r], c.pos[r])) {
        c.key[r] = ok;
        c.pos[r] = op;
        c.d[r] = od;
        c.g[r] = og;
      }
    }
  }
}

template <int R>
__device__ void sort_rows_regs(const RingRows& w, int warp, int lane) {
  const int k = w.k;
  for (int row = w.row0 + warp; row < w.row1; row += kWarps) {
    const size_t io = (size_t)row * k;
    Cells<R> c;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      c.pos[r] = e;  // the index breaks ties; e >= k sorts after any NaN
      c.key[r] = INT_MAX;
      c.d[r] = 0.f;
      c.g[r] = 0;
      if (e < k) {
        c.d[r] = w.in_d[io + e];
        c.g[r] = w.in_g[io + e];
        c.key[r] = lexfold::order_key(w.sign * c.d[r]);
      }
    }
#pragma unroll
    for (int s = 2; s <= 32 * R; s <<= 1) {
#pragma unroll
      for (int j = s >> 1; j > 0; j >>= 1) cells_step<R>(c, s, j, lane);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (e < k) {
        w.out_d[io + e] = c.d[r];
        w.out_g[io + e] = c.g[r];
        w.run_p[io + e] = w.r * k + e;
        w.right_d[io + e] = c.d[r];
        w.right_g[io + e] = c.g[r];
      }
    }
  }
}

template <int R>
__device__ void merge_rows_regs(const RingRows& w, const float* arr_d,
                                const int* arr_g, int src, int warp,
                                int lane) {
  constexpr int C = 32 * R;
  const int k = w.k;
  for (int row = w.row0 + warp; row < w.row1; row += kWarps) {
    const size_t io = (size_t)row * k;
    Cells<R> q, b;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      const int i = C - 1 - e;  // b holds the arriving list descending
      q.key[r] = b.key[r] = INT_MAX;
      q.pos[r] = b.pos[r] = INT_MAX;
      q.d[r] = b.d[r] = 0.f;
      q.g[r] = b.g[r] = 0;
      if (e < k) {
        q.d[r] = __ldcg(w.out_d + io + e);
        q.g[r] = __ldcg(w.out_g + io + e);
        q.pos[r] = __ldcg(w.run_p + io + e);
      }
      if (i < k) {
        b.d[r] = __ldcg(arr_d + io + i);
        b.g[r] = __ldcg(arr_g + io + i);
        b.pos[r] = src * k + i;
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (e < k) q.key[r] = lexfold::order_key(w.sign * q.d[r]);
      if (C - 1 - e < k) b.key[r] = lexfold::order_key(w.sign * b.d[r]);
      if (cell_less(b.key[r], b.pos[r], q.key[r], q.pos[r])) {
        q.key[r] = b.key[r];
        q.pos[r] = b.pos[r];
        q.d[r] = b.d[r];
        q.g[r] = b.g[r];
      }
    }
    __syncwarp();  // every read of the row before any write to it
#pragma unroll
    for (int j = C / 2; j > 0; j >>= 1) cells_step<R>(q, 2 * C, j, lane);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int e = r * 32 + lane;
      if (e < k) {
        w.out_d[io + e] = q.d[r];
        w.out_g[io + e] = q.g[r];
        w.run_p[io + e] = q.pos[r];
      }
    }
  }
}

// ---- lists of k > 256 cells: a warp a row, staged in shared memory --------
// (ws: the warp's 5·k words)
__device__ void sort_rows_smem(const RingRows& w, int* ws, int warp,
                               int lane) {
  const int k = w.k;
  int k2 = 1;
  while (k2 < k) k2 <<= 1;
  int* key = ws;
  int* idx = ws + k2;
  for (int row = w.row0 + warp; row < w.row1; row += kWarps) {
    const size_t io = (size_t)row * k;
    for (int e = lane; e < k2; e += 32) {
      key[e] = e < k ? lexfold::order_key(w.sign * w.in_d[io + e]) : INT_MAX;
      idx[e] = e;  // the padding's idx >= k sorts it after every NaN
    }
    __syncwarp();
    lexfold::warp_sort_pairs(key, idx, k2, lane);
    for (int e = lane; e < k; e += 32) {
      const int j = idx[e];
      const float d = w.in_d[io + j];
      const int g = w.in_g[io + j];
      w.out_d[io + e] = d;
      w.out_g[io + e] = g;
      w.run_p[io + e] = w.r * k + e;
      w.right_d[io + e] = d;
      w.right_g[io + e] = g;
    }
    __syncwarp();  // key and idx are rewritten by the next row
  }
}

__device__ void merge_rows_smem(const RingRows& w, int* ws,
                                const float* arr_d, const int* arr_g,
                                int src, int warp, int lane) {
  const int k = w.k;
  float* rd = (float*)ws;  // the running row
  int* rg = ws + k;
  int* rp = ws + 2 * k;
  float* ad = (float*)(ws + 3 * k);  // the arriving row
  int* ag = ws + 4 * k;
  const float sign = w.sign;
  for (int row = w.row0 + warp; row < w.row1; row += kWarps) {
    const size_t io = (size_t)row * k;
    for (int j = lane; j < k; j += 32) {
      rd[j] = __ldcg(w.out_d + io + j);
      rg[j] = __ldcg(w.out_g + io + j);
      rp[j] = __ldcg(w.run_p + io + j);
      ad[j] = __ldcg(arr_d + io + j);
      ag[j] = __ldcg(arr_g + io + j);
    }
    __syncwarp();
    lexfold::warp_merge_ranks(
        [&](int i) { return lexfold::order_key(sign * rd[i]); }, rp, k,
        [&](int j) { return lexfold::order_key(sign * ad[j]); }, src * k, k,
        k, lane, [&](bool from_b, int i, int rank) {
          w.out_d[io + rank] = from_b ? ad[i] : rd[i];
          w.out_g[io + rank] = from_b ? ag[i] : rg[i];
          w.run_p[io + rank] = from_b ? src * k + i : rp[i];
        });
    __syncwarp();  // the staged row is rewritten by the next row
  }
}

// The row work of each form: kForm = 0 lane groups (k <= 32), R = 2, 4
// or 8 registers a lane (k <= 32·R), kSmem shared memory (k > 256).
constexpr int kSmem = -1;

template <int kForm>
__device__ __forceinline__ void sort_rows(const RingRows& w, int* ws,
                                          int warp, int lane) {
  if constexpr (kForm == 0) {
    sort_rows_lanes(w, warp, lane);
  } else if constexpr (kForm == kSmem) {
    sort_rows_smem(w, ws, warp, lane);
  } else {
    sort_rows_regs<kForm>(w, warp, lane);
  }
}

template <int kForm>
__device__ __forceinline__ void merge_rows(const RingRows& w, int* ws,
                                           const float* arr_d,
                                           const int* arr_g, int src,
                                           int warp, int lane) {
  if constexpr (kForm == 0) {
    merge_rows_lanes(w, arr_d, arr_g, src, warp, lane);
  } else if constexpr (kForm == kSmem) {
    merge_rows_smem(w, ws, arr_d, arr_g, src, warp, lane);
  } else {
    merge_rows_regs<kForm>(w, arr_d, arr_g, src, warp, lane);
  }
}

template <int kForm>
__global__ void __launch_bounds__(kThreads) ring_kernel(RingArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_ok;
  const int k = a.k, p = a.p, hops = p - 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = a.shard[blockIdx.y];
  const int right = (r + 1) % p, left = (r + p - 1) % p;
  const int b = blockIdx.x, nb = gridDim.x;
  const size_t slot = (size_t)a.m * k;  // cells of one slot
  RingRows w{a.in_d[r], a.in_g[r], a.out_d[r], a.out_g[r], a.run_p[r],
             a.slot_d[right], a.slot_g[right], b * a.rows,
             min(a.m, (b + 1) * a.rows), k, r, a.negate ? -1.f : 1.f};
  int* ws = smem + (size_t)warp * 5 * k;

  int* arrived = a.flags[r] + b;          // raised by the left neighbour
  int* credits = a.flags[r] + nb + b;     // raised by the right neighbour
  int* right_arrived = a.flags[right] + b;
  int* left_credits = a.flags[left] + nb + b;
  const float* mine_d = a.slot_d[r];
  const int* mine_g = a.slot_g[r];

  sort_rows<kForm>(w, ws, warp, lane);
  for (int h = 0; h < hops; ++h) {
    if (h >= 1) {
      // the right neighbour's slot h % 2 is free once it forwarded hop
      // h − 2's block
      if (h >= 2 && !block_wait(credits, h - 1, a.system, &s_ok)) break;
      // forward hop h − 1's block: this block's rows of the slot
      const size_t from = (size_t)((h - 1) & 1) * slot + (size_t)w.row0 * k;
      const size_t to = (size_t)(h & 1) * slot + (size_t)w.row0 * k;
      const int n = (w.row1 - w.row0) * k;
      constexpr int kBatch = 4;  // loads in flight a thread
      for (int i0 = threadIdx.x; i0 < n; i0 += kThreads * kBatch) {
        float vd[kBatch];
        int vg[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < n) {
            vd[u] = __ldcg(mine_d + from + i);
            vg[u] = __ldcg(mine_g + from + i);
          }
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
          const int i = i0 + u * kThreads;
          if (i < n) {
            w.right_d[to + i] = vd[u];
            w.right_g[to + i] = vg[u];
          }
        }
      }
    }
    block_signal(right_arrived, h + 1, a.system);
    // hop h − 1's slot was merged and now forwarded: free for the left
    // neighbour (only credits it will wait for are sent)
    if (h >= 1 && h <= hops - 2 && threadIdx.x == 0) {
      store_release(left_credits, h, a.system);
    }
    if (!block_wait(arrived, h + 1, a.system, &s_ok)) break;
    const int src = (r + p - 1 - h) % p;  // the block's origin shard
    const size_t cur = (size_t)(h & 1) * slot;
    merge_rows<kForm>(w, ws, mine_d + cur, mine_g + cur, src, warp, lane);
    if (h + 1 == hops) return;
  }
  // a wait timed out
  if (threadIdx.x == 0) atomicExch(a.status, 1);
}

// the form of the ring kernel for lists of width k, and its shared memory
inline const void* ring_kernel_for(int k) {
  if (k <= 32) return (const void*)ring_kernel<0>;
  if (k <= 64) return (const void*)ring_kernel<2>;
  if (k <= 128) return (const void*)ring_kernel<4>;
  if (k <= 256) return (const void*)ring_kernel<8>;
  return (const void*)ring_kernel<kSmem>;
}

inline size_t ring_smem_for(int k) { return k <= 256 ? 0 : ring_smem(k); }

}  // namespace

// K7. All pointers on the card `device`; (m, w1) running and (m, w2)
// block arrays, (m, k) outputs, k <= w1 + w2.
extern "C" int raft_merge_step(const void* rd, const void* rp, const void* rg,
                               int w1, const void* bd, const void* bp,
                               const void* bg, int w2, int m, int k,
                               int select_min, void* od, void* op, void* og,
                               int device, void* stream) {
  if (w1 < 0 || w2 < 0 || k < 1 || k > w1 + w2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  StepArgs a{(const float*)rd, (const int*)rp, (const int*)rg,
             (const float*)bd, (const int*)bp, (const int*)bg,
             (float*)od,       (int*)op,       (int*)og,
             w1, w2, m, k, select_min ? 1.f : -1.f};
  const int w = w1 > w2 ? w1 : w2;
  if (w <= 32) {
    int G = 1;
    while (G < w) G <<= 1;
    const int rows = kStepWarps * (32 / G);  // rows a block
    if (m > 0) {
      merge_step_lanes<<<(m + rows - 1) / rows, kStepWarps * 32, 0,
                         (cudaStream_t)stream>>>(a, G);
    }
    return (int)cudaGetLastError();
  }
  const size_t row_bytes = 3 * (size_t)(w1 + w2) * sizeof(int);
  int warps = (int)(kStepSmemTarget / row_bytes);
  warps = warps < 1 ? 1 : (warps > kStepWarps ? kStepWarps : warps);
  const size_t smem = warps * row_bytes;
  err = cudaFuncSetAttribute(merge_step_smem,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    merge_step_smem<<<(m + warps - 1) / warps, warps * 32, smem,
                      (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

// K8: how many ring blocks the card `device` keeps resident at once for
// lists of width k (a launch's blocks over all its shards may not exceed
// it); a negative CUDA error code on failure.
extern "C" int raft_ring_topk_capacity(int device, int k) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const void* kern = ring_kernel_for(k);
  const size_t smem = ring_smem_for(k);
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      kThreads, smem);
  if (err != cudaSuccess) return -(int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// K8, cross-card mode: let `device` write into `peer`'s memory.
extern "C" int raft_ring_enable_peer(int device, int peer) {
  int can = 0;
  cudaError_t err = cudaDeviceCanAccessPeer(&can, device, peer);
  if (err != cudaSuccess) return (int)err;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceEnablePeerAccess(peer, 0);
  if (err == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear it: access is what was asked for
    return 0;
  }
  return (int)err;
}

// K8: one cooperative launch on the card `device` for the n_launch shards
// listed in `shards` (all p shards when they share the card). `table`
// holds 8 rows of p device pointers, one per shard: in_d, in_g, out_d,
// out_g, run_p, slot_d, slot_g, flags; `blocks` ring blocks per shard of
// `rows` rows each, the same in every launch of a call, with
// blocks·rows >= m. The (2, blocks) flags of the launch's shards, in
// `shards` order, and then the status word are one run of words, which
// the entry zeroes (one memset) before the launch when `zero` is set;
// across cards the caller zeroes them instead, before it orders the
// cards' streams, since a card's ring writes into its neighbours' flags.
extern "C" int raft_ring_topk(const unsigned long long* table,
                              const int* shards, int n_launch, int p, int m,
                              int k, int select_min, int blocks, int rows,
                              int system, int zero, int device,
                              void* status, void* stream) {
  if (p < 2 || p > kMaxShards || n_launch < 1 || n_launch > p ||
      blocks < 1 || rows < 1 || (long long)blocks * rows < m) {
    return (int)cudaErrorInvalidValue;
  }
  RingArgs a{};
  for (int s = 0; s < p; ++s) {
    a.in_d[s] = (const float*)table[s];
    a.in_g[s] = (const int*)table[p + s];
    a.out_d[s] = (float*)table[2 * p + s];
    a.out_g[s] = (int*)table[3 * p + s];
    a.run_p[s] = (int*)table[4 * p + s];
    a.slot_d[s] = (float*)table[5 * p + s];
    a.slot_g[s] = (int*)table[6 * p + s];
    a.flags[s] = (int*)table[7 * p + s];
  }
  for (int s = 0; s < n_launch; ++s) a.shard[s] = shards[s];
  a.status = (int*)status;
  a.p = p;
  a.m = m;
  a.k = k;
  a.rows = rows;
  a.negate = select_min ? 0 : 1;
  a.system = system;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const void* kern = ring_kernel_for(k);
  const size_t smem = ring_smem_for(k);
  if (smem > 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  if (zero) {
    err = cudaMemsetAsync(a.flags[shards[0]], 0,
                          ((size_t)n_launch * 2 * blocks + 1) * sizeof(int),
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel(kern,
                                    dim3(blocks, n_launch), dim3(kThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
