// The ring's order and folds, shared by K7 and K8 (ring_topk.cu), as
// warp-level device functions: the counterparts of
// raft_tpu/ops/ring_topk.py::_vmem_fold, which takes k passes of (min
// value, then min position) over the concatenation of a running list and
// a candidate block, carrying each cell's global id and payloads.
//
// order_key and lex_before are the ring's order, shared by K7 and K8
// (ring_topk.cu): the total order (key, explicit position, index) of
// lax.sort(num_keys=2, is_stable=True) on (±distance, position). Keys are
// order_key() of the float, so the integer order is the sort's: -0.0
// equals 0.0 and NaN follows +inf.
//
// warp_sort_pairs and warp_merge_ranks are K8's (ring_topk.cu): the ring
// sorts each shard's own list once, by (key, index), and from then on
// merges two sorted lists a hop. In the ring's total order a cell's
// position is (its origin shard)·k + (its index in that shard's list).
// Among cells of one shard the sorted order already is the position
// order, so a cell may carry (its shard)·k + (its index in its shard's
// SORTED list) in place of its position: the order does not change. A
// running list (sorted in the total order, each cell's position kept
// beside it) and a block that arrives from one other shard (sorted, its
// cell j at position (shard)·k + j) therefore merge by ranks: a cell's
// rank is its index in its own list plus a binary-search count of the
// other list's cells before it. O(k log k) a row; the ranks are
// distinct, so each output slot is written once.
#pragma once

#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace lexfold {

// The float's place in the sort order as an int: -0.0 as 0.0, every NaN
// after +inf, otherwise the IEEE order.
__device__ __forceinline__ int order_key(float v) {
  if (isnan(v)) return INT_MAX;
  const int i = __float_as_int(v);
  if (i == INT_MIN) return 0;  // -0.0
  return i ^ ((i >> 31) & 0x7fffffff);
}

// (ka, pa, ia) strictly before (kb, pb, ib).
__device__ __forceinline__ bool lex_before(int ka, int pa, int ia, int kb,
                                           int pb, int ib) {
  return ka < kb || (ka == kb && (pa < pb || (pa == pb && ia < ib)));
}

// Sort the n2 cells (key[e], idx[e]) in shared memory by (key, idx)
// ascending, in place, with one warp: a bitonic network, n2 a power of
// two. The idx must be distinct. The caller syncs the warp before and
// after.
__device__ __forceinline__ void warp_sort_pairs(int* key, int* idx, int n2,
                                                int lane) {
  for (int s = 2; s <= n2; s <<= 1) {
    for (int j = s >> 1; j > 0; j >>= 1) {
      for (int t = lane; t < (n2 >> 1); t += 32) {
        const int i = ((t & ~(j - 1)) << 1) | (t & (j - 1));
        const int q = i + j;
        const int ka = key[i], ia = idx[i], kb = key[q], ib = idx[q];
        const bool b_first = kb < ka || (kb == ka && ib < ia);
        if (b_first == ((i & s) == 0)) {  // out of order for this block
          key[i] = kb;
          idx[i] = ib;
          key[q] = ka;
          idx[q] = ia;
        }
      }
      __syncwarp();
    }
  }
}

// The merge of two sorted lists by ranks (the ring's fold). List A has na
// cells sorted in the total order (key, position), cell i with key ka(i)
// and position pa[i]; list B has nb cells sorted the same way, cell j
// with key kb(j) and position pb0 + j, no position shared with A. For
// each cell whose rank in the merged list is below k, the lanes of one
// warp call emit(in_b, index, rank) together; each rank below
// min(k, na + nb) is emitted exactly once.
template <typename KeyA, typename KeyB, typename Emit>
__device__ __forceinline__ void warp_merge_ranks(KeyA ka, const int* pa,
                                                 int na, KeyB kb, int pb0,
                                                 int nb, int k, int lane,
                                                 Emit emit) {
  for (int i = lane; i < na && i < k; i += 32) {
    const int key = ka(i), pos = pa[i];
    int lo = 0, hi = nb < k - i ? nb : k - i;  // count B's cells before
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int km = kb(mid);
      if (km < key || (km == key && pb0 + mid < pos)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (i + lo < k) emit(false, i, i + lo);
  }
  for (int j = lane; j < nb && j < k; j += 32) {
    const int key = kb(j), pos = pb0 + j;
    int lo = 0, hi = na < k - j ? na : k - j;  // count A's cells before
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const int km = ka(mid);
      if (km < key || (km == key && pa[mid] < pos)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    if (j + lo < k) emit(true, j, j + lo);
  }
}

}  // namespace lexfold
