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
// K7 on Hopper: one warp per row. The warp stages the row's w1 + w2 order
// keys and positions in shared memory and ranks every cell by counting
// the cells before it (lexfold::warp_lex_select); a cell whose rank is
// below k is written to that output slot. The TPU's k extraction passes
// (and its padding of rows to 8 and k to 128) have no counterpart. Bound
// on this card: bytes — 12 B per input cell and 12 B per output cell (the
// O(w²) rank compares a row are this design's, not the function's); at
// the sharded path's k = 10 (w = 20) launch overhead dominates.
//
// K8 on Hopper, after _ring_kernel's slot discipline: every block of the
// ring is resident at once (a cooperative launch, which refuses a grid
// that cannot be), one block per (shard, b), blocks b = 0..B−1 walking
// the row tiles b, b + B, ... in the same order on every shard, a tile
// being kRows rows with one warp each. A block keeps its tile's running
// (key, position, gid) lists in shared memory. At hop h it writes its
// forward block (its own input at h = 0, then what arrived at h − 1)
// into its right neighbour's slot h % 2, raises that neighbour's arrival
// flag, waits on its own, folds what arrived with K7's compare, and
// credits its left neighbour once a slot of its own is consumed; a write
// into slot h % 2 from hop 2 on first waits for the credit of hop h − 2.
// The slots and flags live in each shard's device memory: on one card
// the neighbour's slot is local memory, across cards a peer pointer (the
// cross-card mode: one launch per card, __threadfence_system, after the
// wrapper enables peer access). Flags count hops and only grow within a
// call and are zeroed before each call, so nothing leaks from one call
// into the next; a block writes into a neighbour only what that
// neighbour waits for, so no write lands after its owner has finished.
// A wait that passes kTimeoutNs sets the status word and ends the block,
// so a fault is an error the wrapper raises, not a hung card. Bound on
// one card: bytes — each shard's input read once and its output written
// once; the slot traffic a hop and the O(k²) rank compares of each fold
// are this design's, not the merge's.
#include "lexfold.cuh"

namespace {

// ---------------------------------------------------------------------------
// K7
// ---------------------------------------------------------------------------

constexpr int kStepMaxWarps = 8;
constexpr size_t kStepSmemTarget = 48 * 1024;

__global__ void __launch_bounds__(kStepMaxWarps * 32)
merge_step_kernel(const float* __restrict__ rd, const int* __restrict__ rp,
                  const int* __restrict__ rg, int w1,
                  const float* __restrict__ bd, const int* __restrict__ bp,
                  const int* __restrict__ bg, int w2, int m, int k,
                  int negate, float* __restrict__ od, int* __restrict__ op,
                  int* __restrict__ og) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * warps + warp;
  if (row >= m) return;  // warps are independent: no block barrier
  const int w = w1 + w2;
  int* key = smem + (size_t)warp * 2 * w;
  int* pos = key + w;
  const size_t r1 = (size_t)row * w1, r2 = (size_t)row * w2;
  for (int c = lane; c < w; c += 32) {
    const float v = c < w1 ? rd[r1 + c] : bd[r2 + c - w1];
    key[c] = lexfold::order_key(negate ? -v : v);
    pos[c] = c < w1 ? rp[r1 + c] : bp[r2 + c - w1];
  }
  __syncwarp();
  const size_t o = (size_t)row * k;
  lexfold::warp_lex_select(key, pos, w, k, lane, [&](int c, int r) {
    od[o + r] = c < w1 ? rd[r1 + c] : bd[r2 + c - w1];
    op[o + r] = pos[c];
    og[o + r] = c < w1 ? rg[r1 + c] : bg[r2 + c - w1];
  });
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

constexpr int kMaxShards = 16;
constexpr int kRows = 4;                 // rows of a tile, one warp each
constexpr int kThreads = kRows * 32;
constexpr unsigned long long kTimeoutNs = 2000000000ull;

struct RingArgs {
  const float* in_d[kMaxShards];  // per shard (m, k)
  const int* in_g[kMaxShards];
  float* out_d[kMaxShards];       // per shard (m, k)
  int* out_g[kMaxShards];
  float* slot_d[kMaxShards];      // per shard (B, 2, kRows, k): its slots
  int* slot_g[kMaxShards];
  int* flags[kMaxShards];         // per shard (2, B): arrivals, credits
  int shard[kMaxShards];          // blockIdx.y -> shard
  int* status;                    // set to 1 on a timeout
  int p, m, k, negate, system;
};

__host__ __device__ inline size_t ring_smem(int k) {
  return (size_t)kRows * 11 * k * sizeof(int);
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
      __nanosleep(64);
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

__global__ void __launch_bounds__(kThreads) ring_kernel(RingArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_ok;
  const int k = a.k, p = a.p;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = a.shard[blockIdx.y];
  const int right = (r + 1) % p, left = (r + p - 1) % p;
  const int b = blockIdx.x, nb = gridDim.x;
  const int n_tiles = (a.m + kRows - 1) / kRows;
  const int tiles = b < n_tiles ? (n_tiles - 1 - b) / nb + 1 : 0;
  const int hops = tiles * (p - 1);  // this block's hops over all tiles
  const size_t rk = (size_t)kRows * k;  // cells of one slot
  const float sign = a.negate ? -1.f : 1.f;

  // this warp's row: cells [0, k) the running list, [k, 2k) the arrival;
  // then the fold's output
  float* v = (float*)smem + (size_t)warp * 11 * k;
  int* key = (int*)(v + 2 * k);
  int* pos = key + 2 * k;
  int* gid = pos + 2 * k;
  float* nv = (float*)(gid + 2 * k);
  int* npos = (int*)(nv + k);
  int* ngid = npos + k;

  int* arrived = a.flags[r] + b;          // raised by the left neighbour
  int* credits = a.flags[r] + nb + b;     // raised by the right neighbour
  int* right_arrived = a.flags[right] + b;
  int* left_credits = a.flags[left] + nb + b;
  // this warp's row in block b's two slots
  const size_t base = (size_t)b * 2 * rk + (size_t)warp * k;
  const float* mine_d = a.slot_d[r] + base;
  const int* mine_g = a.slot_g[r] + base;
  float* right_d = a.slot_d[right] + base;
  int* right_g = a.slot_g[right] + base;

  int g = 0;  // hops run so far; slot g % 2 carries hop g
  for (int i = 0; i < tiles; ++i) {
    const int row = (b + i * nb) * kRows + warp;
    const bool live = row < a.m;
    const size_t io = (size_t)row * k;
    if (live) {
      for (int j = lane; j < k; j += 32) {
        const float x = sign * a.in_d[r][io + j];
        v[j] = x;
        key[j] = lexfold::order_key(x);
        pos[j] = r * k + j;
        gid[j] = a.in_g[r][io + j];
      }
    }
    __syncwarp();
    for (int h = 0; h + 1 < p; ++h, ++g) {
      const size_t cur = (size_t)(g & 1) * rk;
      const size_t prev = (size_t)((g + 1) & 1) * rk;
      // the right neighbour's slot g % 2 is free once it consumed hop g−2
      if (g >= 2 && !block_wait(credits, g - 1, a.system, &s_ok)) break;
      if (live) {
        for (int j = lane; j < k; j += 32) {
          const float x = h == 0 ? v[j] : __ldcg(mine_d + prev + j);
          const int id = h == 0 ? gid[j] : __ldcg(mine_g + prev + j);
          right_d[cur + j] = x;
          right_g[cur + j] = id;
        }
      }
      block_signal(right_arrived, g + 1, a.system);
      // hop g−1's slot was folded and now forwarded: free for the left
      // neighbour (only credits it will wait for are sent)
      if (h >= 1 && g <= hops - 2 && threadIdx.x == 0) {
        store_release(left_credits, g, a.system);
      }
      if (!block_wait(arrived, g + 1, a.system, &s_ok)) break;
      if (live) {
        const int src = (r + p - 1 - h) % p;  // the block's origin shard
        for (int j = lane; j < k; j += 32) {
          const float x = __ldcg(mine_d + cur + j);
          v[k + j] = x;
          key[k + j] = lexfold::order_key(x);
          pos[k + j] = src * k + j;
          gid[k + j] = __ldcg(mine_g + cur + j);
        }
        __syncwarp();
        lexfold::warp_lex_select(key, pos, 2 * k, k, lane, [&](int c, int s) {
          nv[s] = v[c];
          npos[s] = pos[c];
          ngid[s] = gid[c];
        });
        __syncwarp();
        for (int j = lane; j < k; j += 32) {
          v[j] = nv[j];
          key[j] = lexfold::order_key(nv[j]);
          pos[j] = npos[j];
          gid[j] = ngid[j];
        }
        __syncwarp();
      }
      // the tile's last hop: its slot is not forwarded, so it is free now
      if (h + 2 == p && g + 1 <= hops - 2) {
        block_signal(left_credits, g + 1, a.system);
      }
    }
    if (g < (i + 1) * (p - 1)) {  // a wait timed out
      if (threadIdx.x == 0) atomicExch(a.status, 1);
      return;
    }
    if (live) {
      for (int j = lane; j < k; j += 32) {
        a.out_d[r][io + j] = sign * v[j];
        a.out_g[r][io + j] = gid[j];
      }
    }
    __syncwarp();
  }
}

}  // namespace

// K7. All pointers on the card `device`; (m, w1) running and (m, w2)
// block arrays, (m, k) outputs, k <= w1 + w2.
extern "C" int raft_merge_step(const void* rd, const void* rp, const void* rg,
                               int w1, const void* bd, const void* bp,
                               const void* bg, int w2, int m, int k,
                               int select_min, void* od, void* op, void* og,
                               int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t row_bytes = 2 * (size_t)(w1 + w2) * sizeof(int);
  int warps = (int)(kStepSmemTarget / row_bytes);
  warps = warps < 1 ? 1 : (warps > kStepMaxWarps ? kStepMaxWarps : warps);
  const size_t smem = warps * row_bytes;
  err = cudaFuncSetAttribute(merge_step_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  if (m > 0) {
    merge_step_kernel<<<(m + warps - 1) / warps, warps * 32, smem,
                        (cudaStream_t)stream>>>(
        (const float*)rd, (const int*)rp, (const int*)rg, w1,
        (const float*)bd, (const int*)bp, (const int*)bg, w2, m, k,
        select_min ? 0 : 1, (float*)od, (int*)op, (int*)og);
  }
  return (int)cudaGetLastError();
}

// K8: how many ring blocks the card `device` keeps resident at once for
// lists of width k (a launch's blocks over all its shards may not exceed
// it); a negative CUDA error code on failure.
extern "C" int raft_ring_topk_capacity(int device, int k) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return -(int)err;
  const size_t smem = ring_smem(k);
  err = cudaFuncSetAttribute(
      ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return -(int)err;
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_kernel,
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
// listed in `shards` (all p shards when they share the card). in_d ..
// flags are host arrays of p device pointers, one per shard; `blocks`
// ring blocks per shard, the same in every launch of a call.
extern "C" int raft_ring_topk(const unsigned long long* in_d,
                              const unsigned long long* in_g,
                              const unsigned long long* out_d,
                              const unsigned long long* out_g,
                              const unsigned long long* slot_d,
                              const unsigned long long* slot_g,
                              const unsigned long long* flags,
                              const int* shards, int n_launch, int p, int m,
                              int k, int select_min, int blocks, int system,
                              int device, void* status, void* stream) {
  if (p < 2 || p > kMaxShards || n_launch < 1 || n_launch > p ||
      blocks < 1) {
    return (int)cudaErrorInvalidValue;
  }
  RingArgs a{};
  for (int s = 0; s < p; ++s) {
    a.in_d[s] = (const float*)in_d[s];
    a.in_g[s] = (const int*)in_g[s];
    a.out_d[s] = (float*)out_d[s];
    a.out_g[s] = (int*)out_g[s];
    a.slot_d[s] = (float*)slot_d[s];
    a.slot_g[s] = (int*)slot_g[s];
    a.flags[s] = (int*)flags[s];
  }
  for (int s = 0; s < n_launch; ++s) a.shard[s] = shards[s];
  a.status = (int*)status;
  a.p = p;
  a.m = m;
  a.k = k;
  a.negate = select_min ? 0 : 1;
  a.system = system;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = ring_smem(k);
  err = cudaFuncSetAttribute(
      ring_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&a};
  err = cudaLaunchCooperativeKernel((const void*)ring_kernel,
                                    dim3(blocks, n_launch), dim3(kThreads),
                                    args, smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
