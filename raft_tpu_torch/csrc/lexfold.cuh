// The (value, concat position) fold of K7, as warp-level device
// functions: the counterparts of raft_tpu/ops/ring_topk.py::_vmem_fold.
//
// warp_fold is K6's (cagra_fused.cu): it folds a hop's candidates into the
// itopk buffer. _vmem_fold takes k passes of (min value, then min
// position) over the concatenation of a running list and a candidate
// block, carrying each cell's global id and payloads. Where the running
// list is sorted by (value, position) and every running entry precedes
// every candidate in concat position — true of CAGRA's buffer, whose
// candidates are appended after it, and not of the ring (there a
// shard's running positions start at r·k, and the block that arrives
// from shard r−1 at hop 0 sits at (r−1)·k, before them) — those k passes
// equal a stable merge of the two, running list first on equal values,
// truncated to k. warp_fold computes that merge by ranks:
//
//   running entry i:  rank = i + #{c : cv[c] < rv[i]}
//   candidate c:      rank = #{i : rv[i] <= cv[c]}
//                          + #{c' : (cv[c'], c') < (cv[c], c)}
//
// and writes each entry whose rank is below k to that slot. The
// candidates need not be sorted: their concat position is their index.
// Ranks are distinct, so the k output slots are written exactly once.
// A candidate that is not finite can never rank below k (the running
// list has k entries and precedes it), so it is skipped.
//
// warp_lex_select is K7's and K8's (ring_topk.cu): the k best cells of
// any w cells under the total order (key, explicit position, index), the
// order of lax.sort(num_keys=2, is_stable=True) on (±distance,
// position). It assumes nothing of either list: each cell's rank is the
// count of cells before it in that order, so the inputs need not be
// sorted, a cell that is not finite still ranks by its position, and the
// cell index breaks a tie of (key, position) as the stable sort does.
// Keys are order_key() of the float, so the integer order is the sort's:
// -0.0 equals 0.0 and NaN follows +inf.
#pragma once

#include <cuda_runtime.h>

#include "topk_common.cuh"

namespace lexfold {

// Fold (cv, cg) of length nc into the sorted running list (rv, rg, re) of
// length k, writing the k best to (ov, og, oe). re is the running list's
// int payload (CAGRA's explored flags); candidates carry payload 0. The
// output arrays must not alias the inputs; the caller syncs the warp
// before reading them.
__device__ __forceinline__ void warp_fold(const float* rv, const int* rg,
                                          const int* re, int k,
                                          const float* cv, const int* cg,
                                          int nc, float* ov, int* og,
                                          int* oe, int lane) {
  for (int i = lane; i < k; i += 32) {
    const float v = rv[i];
    int r = i;
    for (int c = 0; c < nc; ++c) r += cv[c] < v ? 1 : 0;
    if (r < k) {
      ov[r] = v;
      og[r] = rg[i];
      oe[r] = re[i];
    }
  }
  for (int c = lane; c < nc; c += 32) {
    const float v = cv[c];
    if (!isfinite(v)) continue;
    int r = 0;
    for (int i = 0; i < k; ++i) r += rv[i] <= v ? 1 : 0;
    if (r >= k) continue;
    for (int c2 = 0; c2 < nc; ++c2) r += key_less(cv[c2], c2, v, c) ? 1 : 0;
    if (r < k) {
      ov[r] = v;
      og[r] = cg[c];
      oe[r] = 0;
    }
  }
}

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

// For each of the w cells (key[c], pos[c]) in shared memory whose rank in
// the (key, position, index) order is below k, call emit(c, rank). The
// lanes of one warp call it together; each rank below min(k, w) is
// emitted exactly once.
template <typename Emit>
__device__ __forceinline__ void warp_lex_select(const int* key,
                                                const int* pos, int w, int k,
                                                int lane, Emit emit) {
  for (int c = lane; c < w; c += 32) {
    const int kc = key[c], pc = pos[c];
    int r = 0;
    for (int j = 0; j < w && r < k; ++j) {
      r += lex_before(key[j], pos[j], j, kc, pc, c) ? 1 : 0;
    }
    if (r < k) emit(c, r);
  }
}

}  // namespace lexfold
