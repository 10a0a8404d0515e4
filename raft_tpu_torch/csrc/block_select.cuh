// Block-wide selection over 64-bit keys, for K2's wide form
// (fused_knn.cuh): the shrinks of its candidate buffers inside the tile
// loop, and the selection that turns a query's buffers into its k best.
//
// The keys are list_select.cuh's buffer keys (a distance's order bits,
// its column, a -0.0 flag), unique within a query, so the k best are one
// set whatever the order the keys were written in. Every routine here is
// called by all kBlock threads of a block with the same arguments: each
// pass over the keys loads kUnroll of them a thread at once (the loads
// of the whole block in flight together: one round trip to L2 or device
// memory a pass, where a warp's loop over a buffer waits on one load a
// lane at a time), histograms 10 bits of them with one shared atomic a
// key, and finds the bucket by a block-wide scan of the bins. A
// compaction writes the kept keys in no fixed order (a warp's keys by
// one shared atomic a warp); a selection gathers at most kRound keys into
// shared memory and sorts them by a bitonic network.
#pragma once

#include "list_select.cuh"

namespace bsel {

using lsel::Key64;
using lsel::kNone64;

constexpr int kBlock = 256;  // threads a block
constexpr int kWarps = kBlock / 32;
constexpr int kUnroll = 8;   // keys a thread loads at once
constexpr int kBins = lsel::kBins;
constexpr int kRound = 2048;  // keys a selection round sorts at most

// The block's scratch for its selections (in shared memory).
struct __align__(16) Scratch {
  unsigned hist[kBins];
  Key64 wlo[kWarps], whi[kWarps];
  int wsum[kWarps];
  int count, dig, before, bucket, out;
};

// A segment count: one held by the caller, or one a segment in memory.
struct OneCount {
  int n;
  __device__ __forceinline__ int operator()(int) const { return n; }
};
struct ManyCounts {
  const int* n;
  __device__ __forceinline__ int operator()(int s) const { return n[s]; }
};

// A query's keys: nseg segments of device memory, segment s at
// base + s·stride holding n(s) keys.
template <class Count>
struct Segments {
  const Key64* base;
  size_t stride;
  int nseg;
  Count n;
  // f(key) for every key; kNone64 for the slots past a segment's count
  template <class F>
  __device__ __forceinline__ void each(F f) const {
    for (int s = 0; s < nseg; ++s) {
      const Key64* p = base + (size_t)s * stride;
      const int cnt = n(s);
      for (int i0 = 0; i0 < cnt; i0 += kBlock * kUnroll) {
        Key64 v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int i = i0 + u * kBlock + (int)threadIdx.x;
          v[u] = i < cnt ? p[i] : kNone64;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) f(v[u]);
      }
    }
  }
};

// Inclusive sum of x over the block's threads in order (s.wsum reused:
// the caller syncs before the next call).
__device__ __forceinline__ int block_incl(int x, Scratch& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int v = lsel::warp_incl(x, lane);
  if (lane == 31) s.wsum[warp] = v;
  __syncthreads();
  int add = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) add += w < warp ? s.wsum[w] : 0;
  return v + add;
}

// How many keys lie in (floor, lim), the least and the greatest of them.
template <class Src>
__device__ __forceinline__ void key_range(const Src& src, Key64 floor,
                                          Key64 lim, Scratch& s, int& count,
                                          Key64& lo, Key64& hi) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int c = 0;
  Key64 l = kNone64, h = 0ull;
  src.each([&](Key64 key) {
    if (key > floor && key < lim) {
      ++c;
      l = min(l, key);
      h = max(h, key);
    }
  });
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    c += __shfl_xor_sync(RAFT_FULL_MASK, c, off);
  }
  l = lsel::warp_min64(l);
  h = lsel::warp_max64(h);
  if (lane == 0) {
    s.wsum[warp] = c;
    s.wlo[warp] = l;
    s.whi[warp] = h;
  }
  __syncthreads();
  count = 0;
  lo = kNone64;
  hi = 0ull;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    count += s.wsum[w];
    lo = min(lo, s.wlo[w]);
    hi = max(hi, s.whi[w]);
  }
  __syncthreads();
}

// The bucket of the c-th key in (floor, lim) (keys whose bits above sh are
// pre): less of those keys lie below it and count in it. [lo, hi] holds
// every such key. The passes stop once less + count <= fit or the bucket
// is one key (sh = 0); with all_fit, a first pass that finds at most fit
// keys in all stops at once with all set (then pre, sh mean nothing).
struct Bucket {
  Key64 pre;
  int sh, less, count;
  bool all;
};
template <class Src>
__device__ __forceinline__ Bucket find_bucket(const Src& src, Key64 floor,
                                              Key64 lim, Key64 lo, Key64 hi,
                                              int c, int fit, bool all_fit,
                                              Scratch& s) {
  Bucket b{lo, 0, 0, 1, false};
  if (lo == hi) {  // one key: keys are unique
    b.all = all_fit;
    return b;
  }
  const int tid = threadIdx.x;
  int sh = 64 - __clzll(lo ^ hi);
  Key64 pre = lsel::above64(lo, sh);
  int less = 0, krem = c, bucket = 0;
  for (bool first = true;; first = false) {
    const int nb = sh < lsel::kDigit ? sh : lsel::kDigit;
    const int sh2 = sh - nb;
    for (int i = tid; i < kBins / 4; i += kBlock) {
      reinterpret_cast<uint4*>(s.hist)[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
    src.each([&](Key64 key) {
      if (key > floor && key < lim && lsel::above64(key, sh) == pre) {
        atomicAdd(&s.hist[(unsigned)(key >> sh2) & ((1u << nb) - 1u)], 1u);
      }
    });
    __syncthreads();
    // thread t sums bins [4t, 4t + 4)
    const uint4 hv = reinterpret_cast<const uint4*>(s.hist)[tid];
    const int own = (int)(hv.x + hv.y + hv.z + hv.w);
    const int incl = block_incl(own, s);
    if (tid == kBlock - 1) s.count = incl;
    if (incl >= krem && incl - own < krem) {
      const unsigned h[4] = {hv.x, hv.y, hv.z, hv.w};
      int acc = incl - own;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (acc < krem && acc + (int)h[j] >= krem) {
          s.dig = 4 * tid + j;
          s.before = acc;
          s.bucket = (int)h[j];
        }
        acc += (int)h[j];
      }
    }
    __syncthreads();
    if (first && all_fit && s.count <= fit) {
      b.all = true;
      __syncthreads();
      return b;
    }
    const int dig = s.dig;
    less += s.before;
    krem -= s.before;
    bucket = s.bucket;
    pre = (pre << nb) | (Key64)dig;
    sh = sh2;
    __syncthreads();  // the bins and s are read before the next pass
    if (sh == 0 || less + bucket <= fit) break;
  }
  b.pre = pre;
  b.sh = sh;
  b.less = less;
  b.count = bucket;
  return b;
}

// Each key of src that keep(key) takes, to dst[0, ...) in no fixed order
// (a warp's keys by one atomic); returns how many. dst may be src's own
// single segment (a compaction in place: each chunk of the keys is read
// by the whole block before any of it is written over, and a chunk's
// kept keys land below its end).
template <class Src, class Keep>
__device__ __forceinline__ int gather(const Src& src, Key64* dst,
                                      const Keep& keep, Scratch& s) {
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) s.out = 0;
  __syncthreads();
  for (int seg = 0; seg < src.nseg; ++seg) {
    const Key64* p = src.base + (size_t)seg * src.stride;
    const int cnt = src.n(seg);
    for (int i0 = 0; i0 < cnt; i0 += kBlock * kUnroll) {
      Key64 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = i0 + u * kBlock + (int)threadIdx.x;
        v[u] = i < cnt ? p[i] : kNone64;
      }
      __syncthreads();  // the chunk is read before it is written over
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const bool take = v[u] != kNone64 && keep(v[u]);
        const unsigned ball = __ballot_sync(RAFT_FULL_MASK, take);
        if (ball == 0u) continue;
        int base = 0;
        if (lane == 0) base = atomicAdd(&s.out, __popc(ball));
        base = __shfl_sync(RAFT_FULL_MASK, base, 0);
        if (take) dst[base + __popc(ball & ((1u << lane) - 1u))] = v[u];
      }
    }
  }
  __syncthreads();
  const int got = s.out;
  __syncthreads();
  return got;
}

// Sort cand[0, n) ascending (n <= kRound), a bitonic network over the
// next power of two, padded with kNone64.
__device__ __forceinline__ void sort_keys(Key64* cand, int n) {
  int p = 2;
  while (p < n) p <<= 1;
  for (int i = n + (int)threadIdx.x; i < p; i += kBlock) cand[i] = kNone64;
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < p / 2; i += kBlock) {
        const int a = 2 * i - (i & (stride - 1));
        const int b = a + stride;
        const bool asc = (a & size) == 0;
        const Key64 x = cand[a], y = cand[b];
        if ((y < x) == asc) {
          cand[a] = y;
          cand[b] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The k best keys below lim of src, sorted, in rounds of at most kRound:
// emit(slot, key) for each slot a key fills, none(slot) for the slots past
// the keys. cand: kRound keys of shared memory.
template <class Src, class Emit, class None>
__device__ __forceinline__ void select(const Src& src, Key64 lim, int k,
                                       Key64* cand, Scratch& s,
                                       const Emit& emit, const None& none) {
  Key64 floor = 0ull;  // below every key
  int done = 0;
  while (done < k) {
    int count;
    Key64 lo, hi;
    key_range(src, floor, lim, s, count, lo, hi);
    if (count == 0) break;
    const int c = min(kRound, k - done);
    Key64 pre = 0ull;
    int sh = 64;  // count <= kRound: every key in (floor, lim)
    if (count > kRound) {
      const Bucket b = find_bucket(src, floor, lim, lo, hi, c, kRound,
                                   false, s);
      pre = b.pre;
      sh = b.sh;
    }
    const int got = gather(src, cand, [&](Key64 key) {
      return key > floor && key < lim && lsel::above64(key, sh) <= pre;
    }, s);
    sort_keys(cand, got);
    const int t = min(c, got);
    for (int e = threadIdx.x; e < t; e += kBlock) emit(done + e, cand[e]);
    floor = cand[t - 1];
    __syncthreads();  // cand is read before the next round writes it
    done += t;
    if (count <= c) break;  // every key is written
  }
  for (int e = done + (int)threadIdx.x; e < k; e += kBlock) none(e);
}

}  // namespace bsel
