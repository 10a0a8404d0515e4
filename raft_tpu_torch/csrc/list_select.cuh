// The selection of K4's grouped form past k = 256 (ivf_pq_scan.cu): a
// pair's k best of its whole list at once, from its distances kept in
// device memory, instead of streaming folds into a k-list.
//
// At the IVF-PQ graph pass a pair keeps 257 of its list's ~1,590 rows, so
// a running threshold turns away few rows: a random order offers about
// k·(1 + ln(n / k)) ~ 730 of them, and a k-list of 512 keys folded in
// 128-key buffers costs about six bitonic merges a pair, each with the
// block stalled on the fullest buffer. Here the tile loop only writes each
// pair's distances to its row of the block's scratch (which stays in L2)
// and keeps the pair's least and greatest order key; then one warp a pair
//   1. finds the bucket of the k-th key by a radix select: a histogram in
//      shared memory of the next 10 bits below the bits every key shares
//      (from those two keys), and again on the bucket's next 10 bits while
//      the keys below the bucket and in it pass kCap = 512 (at the pass's
//      distances one pass over the list's ~1,590 keys leaves a bucket of
//      a few keys; a list of at most k taken keys keeps them all);
//   2. compacts the keys below the bucket (fewer than k) and, after them,
//      the bucket's — at the last bit, where the bucket is the k-th key,
//      its first ties in row order that complete the k;
//   3. sorts each of the two by (value, row) as 64-bit keys (the value's
//      order bits over the row), a bitonic network in registers as wide
//      as its keys need (256 and 32 at k = 257), and writes the first k
//      with their values re-read from the scratch.
// Work linear in the list plus sorts of about k keys a pair.
//
// The order is the streaming selection's (tf32_tile.cuh::offer_tile):
// only values below +inf are taken (no +inf, no NaN), equal values go to
// the lower row, -0.0 ties with 0.0 (so the order key of -0.0 is 0.0's,
// and the value written is the one the scan computed), and short or empty
// lists end in (+inf, -1). So the two give the same bits.
#pragma once

#include "topk_common.cuh"

namespace lsel {

constexpr unsigned kNone = 0xffffffffu;  // the key of +inf and NaN: not taken
constexpr int kDigit = 10;               // bits a histogram pass
constexpr int kBins = 1 << kDigit;
constexpr int kCap = 512;                // the widest k
// shared memory a warp: the k keys kept, then the histogram
constexpr int kWarpBytes = kCap * 8 + kBins * 4;

// The order bits of a distance: ascending keys are ascending values,
// -0.0 keyed as 0.0; kNone for +inf and NaN.
__device__ __forceinline__ unsigned order_key(float v) {
  if (!(v < CUDART_INF_F)) return kNone;
  unsigned u = __float_as_uint(v);
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// Widen [lo, hi] to v's key, if v is taken at all.
__device__ __forceinline__ void widen_range(float v, unsigned& lo,
                                            unsigned& hi) {
  const unsigned key = order_key(v);
  if (key != kNone) {
    lo = min(lo, key);
    hi = max(hi, key);
  }
}

// The bits of key above bit sh (sh <= 32).
__device__ __forceinline__ unsigned above(unsigned key, int sh) {
  return sh >= 32 ? 0u : key >> sh;
}

// Rows a pass reads at once: four 128-row chunks, their loads in flight
// together.
constexpr int kSpan = 512;

// Lane l's rows base + 128u + 4l + j (j < 4) of d into v[4u + j]; rows
// at or past n read as +inf. d's rows are readable up to n rounded up to
// 128.
__device__ __forceinline__ void load_span(const float* d, int base, int n,
                                          int lane, float (&v)[kSpan / 32]) {
#pragma unroll
  for (int u = 0; u < kSpan / 128; ++u) {
    const int row = base + 128 * u + 4 * lane;
    float4 x = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                           CUDART_INF_F);
    if (base + 128 * u < n) x = *reinterpret_cast<const float4*>(d + row);
    v[4 * u] = row < n ? x.x : CUDART_INF_F;
    v[4 * u + 1] = row + 1 < n ? x.y : CUDART_INF_F;
    v[4 * u + 2] = row + 2 < n ? x.z : CUDART_INF_F;
    v[4 * u + 3] = row + 3 < n ? x.w : CUDART_INF_F;
  }
}

// Inclusive sum over the warp's lanes in order.
__device__ __forceinline__ int warp_incl(int x, int lane) {
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(RAFT_FULL_MASK, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// One compare-exchange step (S, J) of a bitonic network over the warp's
// NG·32 keys, element n = 32g + lane in key[g]; then J / 2 ... 1.
template <int NG, int S, int J>
__device__ __forceinline__ void sort_step(unsigned long long (&key)[NG],
                                          int lane) {
  if constexpr (J >= 32) {  // partners in one lane's registers
    constexpr int jr = J / 32;
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      if ((g & jr) == 0) {
        const bool asc = ((g * 32) & S) == 0;
        const unsigned long long a = key[g], b = key[g | jr];
        const bool sw = asc ? (b < a) : (a < b);
        key[g] = sw ? b : a;
        key[g | jr] = sw ? a : b;
      }
    }
  } else {
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int n = g * 32 + lane;
      const unsigned long long o = __shfl_xor_sync(RAFT_FULL_MASK, key[g], J);
      const bool keep_min = ((n & J) == 0) == ((n & S) == 0);
      key[g] = ((o < key[g]) == keep_min) ? o : key[g];
    }
  }
  if constexpr (J > 1) sort_step<NG, S, J / 2>(key, lane);
}

template <int NG, int S>
__device__ __forceinline__ void sort_stage(unsigned long long (&key)[NG],
                                           int lane) {
  sort_step<NG, S, S / 2>(key, lane);
  if constexpr (S < NG * 32) sort_stage<NG, S * 2>(key, lane);
}

// Sort cand[0, count) in place by the warp (count <= 32·NG), ascending.
template <int NG>
__device__ __forceinline__ void sort_prefix(unsigned long long* cand,
                                            int count, int lane) {
  unsigned long long key[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int e = g * 32 + lane;
    key[g] = e < count ? cand[e] : ~0ull;
  }
  sort_stage<NG, 2>(key, lane);
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const int e = g * 32 + lane;
    if (e < count) cand[e] = key[g];
  }
}

// Sort cand[0, count) (count <= kCap) by a network as wide as it needs.
__device__ __forceinline__ void sort_keys(unsigned long long* cand,
                                          int count, int lane) {
  if (count > 256) {
    sort_prefix<16>(cand, count, lane);
  } else if (count > 128) {
    sort_prefix<8>(cand, count, lane);
  } else if (count > 32) {
    sort_prefix<4>(cand, count, lane);
  } else if (count > 1) {
    sort_prefix<1>(cand, count, lane);
  }
}

// The k best (value, row) of one pair, by one warp. d: the pair's
// distances (16-byte aligned; past n up to the next multiple of 128 they
// are read and ignored), n the list's rows, [lo, hi] the range of its
// keys (lo > hi: none is taken), ws the warp's kWarpBytes of shared
// memory; out_v / out_i the pair's k slots, rows numbered from c_begin.
// k <= kCap.
__device__ __forceinline__ void select_row(const float* d, int n,
                                           unsigned lo, unsigned hi, int k,
                                           unsigned char* ws, float* out_v,
                                           int* out_i, int c_begin,
                                           int lane) {
  unsigned long long* cand = reinterpret_cast<unsigned long long*>(ws);
  unsigned* hist = reinterpret_cast<unsigned*>(ws + kCap * 8);
  int total = 0;  // keys written, sorted, to the pair's first slots
  if (lo <= hi) {
    // every taken key shares its bits from sh up (pre); find the k-th
    // key kDigit bits a pass: `less` keys lie below it, and krem of its
    // ties in row order complete the k
    int sh = 32 - __clz(lo ^ hi);
    unsigned pre = above(lo, sh);
    int less = 0, krem = k, bucket = 0;
    bool all = false;
    for (bool first = true;; first = false) {
      const int nb = sh < kDigit ? sh : kDigit;
      const int sh2 = sh - nb;
      for (int b = lane; b < kBins / 4; b += 32) {
        reinterpret_cast<uint4*>(hist)[b] = make_uint4(0u, 0u, 0u, 0u);
      }
      __syncwarp();
      for (int base = 0; base < n; base += kSpan) {
        float v[kSpan / 32];
        load_span(d, base, n, lane, v);
#pragma unroll
        for (int j = 0; j < kSpan / 32; ++j) {
          const unsigned key = order_key(v[j]);
          if (key != kNone && above(key, sh) == pre) {
            atomicAdd(&hist[(key >> sh2) & ((1u << nb) - 1u)], 1u);
          }
        }
      }
      __syncwarp();
      // lane l sums bins [32l, 32l + 32)
      int own = 0;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const uint4 h = reinterpret_cast<const uint4*>(hist)[lane * 8 + b];
        own += (int)(h.x + h.y + h.z + h.w);
      }
      const int incl = warp_incl(own, lane);
      if (first && __shfl_sync(RAFT_FULL_MASK, incl, 31) <= k) {
        all = true;  // no more than k keys are taken: every one is kept
        break;
      }
      const int hit = __ffs(__ballot_sync(RAFT_FULL_MASK, incl >= krem)) - 1;
      int dig = 0, before = 0, cnt = 0;
      if (lane == hit) {
        int c = incl - own;
        for (int b = 0; b < 32; ++b) {
          const int h = (int)hist[32 * hit + b];
          if (c + h >= krem) {
            dig = 32 * hit + b;
            before = c;
            cnt = h;
            break;
          }
          c += h;
        }
      }
      dig = __shfl_sync(RAFT_FULL_MASK, dig, hit);
      before = __shfl_sync(RAFT_FULL_MASK, before, hit);
      bucket = __shfl_sync(RAFT_FULL_MASK, cnt, hit);
      less += before;
      krem -= before;
      pre = nb == 0 ? pre : (pre << nb) | (unsigned)dig;
      sh = sh2;
      // the bucket is the k-th key itself, or it and the keys below it
      // fit the kept keys' space
      if (sh == 0 || less + bucket <= kCap) break;
      __syncwarp();  // the bins are read before the next pass zeroes them
    }
    // the keys below the bucket to cand[0, less), the bucket's after them
    // in row order — at the last bit (ties of the k-th key) its first
    // krem only (all: every taken key to cand[0, ...))
    int n_lt = 0, n_eq = 0;
    for (int base = 0; base < n; base += kSpan) {
      float v[kSpan / 32];
      load_span(d, base, n, lane, v);
#pragma unroll
      for (int u = 0; u < kSpan / 128; ++u) {  // 128 rows, in row order
        unsigned key[4];
        int lt = 0, eq = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          key[j] = order_key(v[4 * u + j]);
          const bool ok = key[j] != kNone;
          const unsigned a = above(key[j], sh);
          lt += (ok && (all || a < pre)) ? 1 : 0;
          eq += (ok && !all && a == pre) ? 1 : 0;
        }
        const int inc_lt = warp_incl(lt, lane);
        const int inc_eq = warp_incl(eq, lane);
        int s_lt = n_lt + inc_lt - lt;
        int r_eq = n_eq + inc_eq - eq;
        const int row0 = base + 128 * u + 4 * lane;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (key[j] == kNone) continue;
          const unsigned long long c =
              ((unsigned long long)key[j] << 32) | (unsigned)(row0 + j);
          const unsigned a = above(key[j], sh);
          if (all || a < pre) {
            cand[s_lt++] = c;
          } else if (a == pre) {
            if (sh > 0 || r_eq < krem) cand[less + r_eq] = c;
            ++r_eq;
          }
        }
        n_lt += __shfl_sync(RAFT_FULL_MASK, inc_lt, 31);
        n_eq += __shfl_sync(RAFT_FULL_MASK, inc_eq, 31);
      }
    }
    __syncwarp();
    // the keys below the bucket sorted, then the bucket's (unless the
    // bucket is the k-th key, whose ties are in row order), each by a sort
    // as wide as its keys need
    sort_keys(cand, n_lt, lane);
    if (!all && sh > 0) sort_keys(cand + less, bucket, lane);
    __syncwarp();
    total = all ? n_lt : k;
  }
  for (int e = lane; e < k; e += 32) {
    const bool real = e < total;
    const unsigned pos = real ? (unsigned)cand[e] : 0u;
    out_v[e] = real ? d[pos] : CUDART_INF_F;
    out_i[e] = real ? c_begin + (int)pos : -1;
  }
  __syncwarp();  // every lane is done with ws before the next pair
}

}  // namespace lsel
