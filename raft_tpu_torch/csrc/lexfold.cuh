// The (value, concat position) fold of K7, as a warp-level device
// function: the counterpart of raft_tpu/ops/ring_topk.py::_vmem_fold,
// used by K6 (cagra_fused.cu) to fold a hop's candidates into its itopk
// buffer.
//
// _vmem_fold takes k passes of (min value, then min position) over the
// concatenation of a running list and a candidate block, carrying each
// cell's global id and payloads. Where the running list is sorted by
// (value, position) and every running entry precedes every candidate in
// concat position (true of CAGRA's buffer and of K7's ring steps), those
// k passes equal a stable merge of the two, running list first on equal
// values, truncated to k. This function computes that merge by ranks:
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

}  // namespace lexfold
