// The warp-select queue of K1 (select_k.cu), K2 (fused_knn.cu) and the
// grouped forms of K3 and K4 (tf32_tile.cuh): the form of RAFT's
// select_warpsort.cuh, written anew.
//
// A warp keeps the C = 32·R best keys it has seen sorted across its
// registers, key e in register e / 32 of lane e % 32. Keys are (key,
// column) pairs ordered by key_less; the key is an int (K1: the float's
// place in the selection order) or a float (K2–K4: a distance). Candidates
// collect in a buffer of up to C keys in shared memory; fold_buffer loads
// it into registers, sorts it descending with a bitonic network (shuffles
// across lanes, register swaps within a lane), keeps the elementwise
// smaller of queue and buffer (the C smallest of both, as a bitonic
// sequence) and bitonic-merges that back into ascending order.
#pragma once

#include "topk_common.cuh"

namespace warpq {

// The empty key: after every key a caller can offer (K1: (INT_MAX,
// INT_MAX), after a legal INT_MAX key, whose column is smaller; K2:
// (+inf, INT_MAX), and K2 offers no +inf distance).
__device__ __forceinline__ void set_empty(int& v, int& i) {
  v = INT_MAX;
  i = INT_MAX;
}
__device__ __forceinline__ void set_empty(float& v, int& i) {
  v = CUDART_INF_F;
  i = INT_MAX;
}

// One compare-exchange step of a bitonic network over the warp's C = 32·R
// keys, partners at distance j. Key e ends ascending against its partner
// when (e & s) == 0, descending otherwise, flipped by `desc`; s = 2C
// makes the whole step ascending.
template <typename T, int R>
__device__ __forceinline__ void bitonic_step(T (&v)[R], int (&c)[R], int s,
                                             int j, bool desc, int lane) {
  if (j >= 32) {
    const int jr = j >> 5;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (r & jr) continue;
      const int r2 = r | jr;
      const int e = r * 32 + lane;
      const bool asc = ((e & s) == 0) != desc;
      const bool swap = asc ? key_less(v[r2], c[r2], v[r], c[r])
                            : key_less(v[r], c[r], v[r2], c[r2]);
      if (swap) {
        const T tv = v[r];
        const int tc = c[r];
        v[r] = v[r2];
        c[r] = c[r2];
        v[r2] = tv;
        c[r2] = tc;
      }
    }
  } else {
    const bool lower = (lane & j) == 0;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const T ov = __shfl_xor_sync(RAFT_FULL_MASK, v[r], j);
      const int oc = __shfl_xor_sync(RAFT_FULL_MASK, c[r], j);
      const int e = r * 32 + lane;
      const bool asc = ((e & s) == 0) != desc;
      // the lower key of an ascending pair keeps the smaller key
      const bool keep_min = lower == asc;
      const bool other_less = key_less(ov, oc, v[r], c[r]);
      if (keep_min == other_less) {
        v[r] = ov;
        c[r] = oc;
      }
    }
  }
}

// Sort the warp's C keys, ascending or (desc) descending.
template <typename T, int R>
__device__ __forceinline__ void bitonic_sort(T (&v)[R], int (&c)[R],
                                             bool desc, int lane) {
#pragma unroll
  for (int s = 2; s <= 32 * R; s <<= 1) {
#pragma unroll
    for (int j = s >> 1; j > 0; j >>= 1) {
      bitonic_step<T, R>(v, c, s, j, desc, lane);
    }
  }
}

// Sort a bitonic sequence of the warp's C keys ascending.
template <typename T, int R>
__device__ __forceinline__ void bitonic_merge(T (&v)[R], int (&c)[R],
                                              int lane) {
#pragma unroll
  for (int j = 16 * R; j > 0; j >>= 1) {
    bitonic_step<T, R>(v, c, 64 * R, j, false, lane);
  }
}

// Key k−1 of the queue, on every lane.
template <typename T, int R>
__device__ __forceinline__ void kth_key(const T (&qv)[R], const int (&qc)[R],
                                        int k, T& tv, int& tc) {
  const int rk = (k - 1) >> 5;
  T v = qv[0];
  int c = qc[0];
#pragma unroll
  for (int r = 1; r < R; ++r) {
    if (r == rk) {
      v = qv[r];
      c = qc[r];
    }
  }
  tv = __shfl_sync(RAFT_FULL_MASK, v, (k - 1) & 31);
  tc = __shfl_sync(RAFT_FULL_MASK, c, (k - 1) & 31);
}

// Fold the buffer's first nb <= 32·RB keys (in shared memory) into the
// ascending queue (qv, qc) → the C smallest keys of both, ascending. The
// buffer is sorted descending in RB registers (RB <= R), as if it were
// the last 32·RB keys of a C-key buffer whose first keys are empty: only
// the queue's last RB registers meet it, the rest keep their keys, and the
// elementwise smaller keys still form a bitonic sequence of C keys. A
// small buffer beside a long queue thus costs a sort of its own width and
// one merge of C keys, not a sort of C keys.
template <typename T, int R, int RB = R>
__device__ __forceinline__ void fold_buffer(T (&qv)[R], int (&qc)[R],
                                            const T* buf_v, const int* buf_c,
                                            int nb, int lane) {
  static_assert(RB >= 1 && RB <= R, "the buffer's registers: 1 to R");
  T bv[RB];
  int bc[RB];
  __syncwarp();  // the buffer's last writes
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int e = r * 32 + lane;
    if (e < nb) {
      bv[r] = buf_v[e];
      bc[r] = buf_c[e];
    } else {
      set_empty(bv[r], bc[r]);
    }
  }
  __syncwarp();  // read before the buffer is written again
  bitonic_sort<T, RB>(bv, bc, true, lane);
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    const int rq = R - RB + r;
    if (key_less(bv[r], bc[r], qv[rq], qc[rq])) {
      qv[rq] = bv[r];
      qc[rq] = bc[r];
    }
  }
  bitonic_merge<T, R>(qv, qc, lane);
}

}  // namespace warpq
