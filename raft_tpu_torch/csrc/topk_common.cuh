// Shared device helpers of the port's top-k kernels.
//
// Every kernel here orders candidates by the key (value, id): the smaller
// value wins, and among equal values the smaller id. That is the order of
// the JAX package's selections (lax.top_k, the Pallas k-pass extraction),
// so a kernel's ids and their order are fixed by its inputs alone.
#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <climits>

#define RAFT_FULL_MASK 0xffffffffu

// (v, i) strictly before (w, j) in the (value, id) order.
__device__ __forceinline__ bool key_less(float v, int i, float w, int j) {
  return v < w || (v == w && i < j);
}

// Insert the candidate (cv, cid) into the sorted list (lv, li) of length k
// held in shared memory and owned by one warp. All 32 lanes call it with
// the same candidate. The list starts as (+inf, INT_MAX) slots, so any
// finite candidate enters it; a candidate at or past position k is
// dropped.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float cv, int cid, int lane) {
  int cnt = 0;
  for (int j = lane; j < k; j += 32) {
    cnt += key_less(lv[j], li[j], cv, cid) ? 1 : 0;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    cnt += __shfl_xor_sync(RAFT_FULL_MASK, cnt, off);
  }
  const int pos = cnt;
  if (pos >= k) return;
  // shift [pos, k-2] one slot up, 32 slots at a time from the top: each
  // chunk reads its sources before any lane of it writes
  for (int hi = k - 1; hi > pos; hi -= 32) {
    const int j = hi - lane;
    const bool act = j > pos;
    float v = 0.f;
    int id = 0;
    if (act) {
      v = lv[j - 1];
      id = li[j - 1];
    }
    __syncwarp();
    if (act) {
      lv[j] = v;
      li[j] = id;
    }
    __syncwarp();
  }
  if (lane == 0) {
    lv[pos] = cv;
    li[pos] = cid;
  }
  __syncwarp();
}

// Offer one candidate per lane to the warp's list: lanes whose candidate
// is finite and beats the current k-th entry are inserted one after the
// other (the k-th entry is re-read inside warp_insert, so a stale
// threshold only costs a wasted count).
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k,
                                           float v, int id, int lane) {
  const bool pass = v < CUDART_INF_F && key_less(v, id, lv[k - 1], li[k - 1]);
  unsigned mask = __ballot_sync(RAFT_FULL_MASK, pass);
  while (mask) {
    const int src = __ffs(mask) - 1;
    mask &= mask - 1;
    const float cv = __shfl_sync(RAFT_FULL_MASK, v, src);
    const int cid = __shfl_sync(RAFT_FULL_MASK, id, src);
    warp_insert(lv, li, k, cv, cid, lane);
  }
}
