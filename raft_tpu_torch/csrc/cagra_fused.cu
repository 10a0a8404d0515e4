// K6 — the whole CAGRA traversal in one launch.
//
// Replaces the TPU kernel raft_tpu/ops/cagra_fused.py::_fused_padded
// (kernel _kernel), dense mode: from the seeded itopk buffer of each
// query, max_iter hops of the edge engine's hop body — pick the `width`
// best unexplored entries as parents (lowest buffer position on ties),
// score their edge tiles as K5 does, keep each parent's k' best, drop
// candidates already in the buffer or earlier in (parent, rank) order,
// and fold the rest into the buffer by (value, concat position) with the
// explored flags carried.
//
// Design on Hopper, after the reference's persistent search_single_cta
// kernel: one warp per query, four queries to a block, and the query's
// whole state in shared memory for every hop — its vector, the itopk
// buffer (distances, ids, explored flags), the hop's candidates and the
// fold's output. Scoring and the per-parent top-k' are K5's device
// functions (edge_score.cuh), so both engines compute the same bits; the
// fold is K7's (value, position) fold as a stable rank merge
// (lexfold.cuh). The TPU's grid axis over hops becomes a loop inside the
// warp, and the grid's fixed hop count an early exit: a hop with no
// finite unexplored entry changes nothing (the JAX kernel's extra grid
// steps are exact no-ops), so the warp stops there. A parent that is not
// finite is not expanded: its candidates would all be +inf, and since
// picks come in ascending order it can only precede other such parents,
// so neither its tile nor its ids can change the result.
//
// Bound on this card: per hop each query reads `width` tiles (8 KB at
// 64 x 128 int8), aux and graph rows, so the bytes of the hops actually
// taken bound it. This version has one warp walk a query's hops in
// sequence, so each hop waits on its tiles' latency; the dedup and fold
// are O(k'·(itopk + k')) shared-memory compares per hop.
#include "edge_score.cuh"
#include "lexfold.cuh"

namespace {

constexpr int kWarps = 4;

// 4-byte words of shared memory one warp uses.
__host__ __device__ inline size_t warp_words(int itopk, int width, int kprime,
                                             int deg_p, int dim_p) {
  return (size_t)dim_p + deg_p + 6 * (size_t)itopk +
         2 * (size_t)width * kprime + width;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
cagra_fused_kernel(const float* __restrict__ q, const float* __restrict__ bd0,
                   const int* __restrict__ bi0, const T* __restrict__ vecs,
                   const float* __restrict__ aux, const int* __restrict__ gph,
                   const float* __restrict__ pen, int m, int n, int itopk,
                   int width, int max_iter, int kprime, int deg_p, int dim_p,
                   int degree, int metric, float* __restrict__ out_d,
                   int* __restrict__ out_i, int* __restrict__ out_hops,
                   int* __restrict__ out_parents) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= m) return;  // warps are independent: no block barrier
  float* qs = smem + (size_t)warp * warp_words(itopk, width, kprime, deg_p,
                                               dim_p);
  float* sc = qs + dim_p;
  float* bd = sc + deg_p;
  int* bi = reinterpret_cast<int*>(bd + itopk);
  int* be = bi + itopk;
  float* nd = reinterpret_cast<float*>(be + itopk);
  int* ni = reinterpret_cast<int*>(nd + itopk);
  int* ne = ni + itopk;
  float* cv = reinterpret_cast<float*>(ne + itopk);
  int* ci = reinterpret_cast<int*>(cv + width * kprime);
  int* par = ci + width * kprime;

  for (int d = lane; d < dim_p; d += 32) qs[d] = q[(size_t)qi * dim_p + d];
  for (int i = lane; i < itopk; i += 32) {
    bd[i] = bd0[(size_t)qi * itopk + i];
    bi[i] = bi0[(size_t)qi * itopk + i];
    be[i] = 0;
  }
  __syncwarp();
  const float qn = edge::warp_sqnorm(qs, dim_p, lane);

  int hops = 0, expanded = 0;
  for (int h = 0; h < max_iter; ++h) {
    // parents: successive masked arg-mins by (value, buffer position)
    int n_ok = 0;
    for (int w = 0; w < width; ++w) {
      float bv = CUDART_INF_F;
      int bp = INT_MAX;
      for (int i = lane; i < itopk; i += 32) {
        const float v = be[i] ? CUDART_INF_F : bd[i];
        if (key_less(v, i, bv, bp)) {
          bv = v;
          bp = i;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(RAFT_FULL_MASK, bv, off);
        const int op = __shfl_xor_sync(RAFT_FULL_MASK, bp, off);
        if (key_less(ov, op, bv, bp)) {
          bv = ov;
          bp = op;
        }
      }
      if (!isfinite(bv)) break;
      if (lane == 0) {
        be[bp] = 1;
        par[w] = bi[bp];
      }
      __syncwarp();
      ++n_ok;
    }
    if (n_ok == 0) break;  // frontier closed: every later hop is a no-op
    ++hops;
    expanded += n_ok;

    for (int w = 0; w < n_ok; ++w) {
      const size_t pid = (size_t)min(max(par[w], 0), n - 1);
      edge::score_tile(vecs + pid * deg_p * dim_p, aux + pid * 2 * deg_p,
                       pen != nullptr ? pen + pid * deg_p : nullptr, qs, qn,
                       deg_p, dim_p, degree, metric, sc, lane);
      __syncwarp();
      edge::tile_topk(sc, deg_p, kprime, gph + pid * deg_p, cv + w * kprime,
                      ci + w * kprime, lane);
      __syncwarp();
    }

    // dedup: against every buffer id and every earlier candidate id
    const int nc = n_ok * kprime;
    for (int c = lane; c < nc; c += 32) {
      if (!isfinite(cv[c])) {
        cv[c] = CUDART_INF_F;
        continue;
      }
      const int id = ci[c];
      bool dup = false;
      for (int i = 0; i < itopk && !dup; ++i) dup = bi[i] == id;
      for (int c2 = 0; c2 < c && !dup; ++c2) dup = ci[c2] == id;
      if (dup) cv[c] = CUDART_INF_F;
    }
    __syncwarp();
    lexfold::warp_fold(bd, bi, be, itopk, cv, ci, nc, nd, ni, ne, lane);
    __syncwarp();
    for (int i = lane; i < itopk; i += 32) {
      bd[i] = nd[i];
      bi[i] = ni[i];
      be[i] = ne[i];
    }
    __syncwarp();
  }

  for (int i = lane; i < itopk; i += 32) {
    out_d[(size_t)qi * itopk + i] = bd[i];
    out_i[(size_t)qi * itopk + i] = bi[i];
  }
  if (lane == 0) {
    out_hops[qi] = hops;
    out_parents[qi] = expanded;
  }
}

template <typename T>
int launch(const void* q, const void* bd0, const void* bi0, const void* vecs,
           const void* aux, const void* gph, const void* pen, int m, int n,
           int itopk, int width, int max_iter, int kprime, int deg_p,
           int dim_p, int degree, int metric, void* out_d, void* out_i,
           void* out_hops, void* out_parents, cudaStream_t stream) {
  const size_t smem = kWarps * sizeof(float) *
                      warp_words(itopk, width, kprime, deg_p, dim_p);
  cudaError_t err = cudaFuncSetAttribute(
      cagra_fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (m + kWarps - 1) / kWarps;
  if (blocks > 0) {
    cagra_fused_kernel<T><<<blocks, kWarps * 32, smem, stream>>>(
        (const float*)q, (const float*)bd0, (const int*)bi0, (const T*)vecs,
        (const float*)aux, (const int*)gph, (const float*)pen, m, n, itopk,
        width, max_iter, kprime, deg_p, dim_p, degree, metric, (float*)out_d,
        (int*)out_i, (int*)out_hops, (int*)out_parents);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Shared memory one launch asks for, in bytes (the wrapper refuses shapes
// above the card's per-block limit).
extern "C" size_t raft_cagra_fused_smem(int itopk, int width, int kprime,
                                        int deg_p, int dim_p) {
  return kWarps * sizeof(float) *
         warp_words(itopk, width, kprime, deg_p, dim_p);
}

// store_bf16: 0 for an int8 store, 1 for a bf16 store (its raw bits).
extern "C" int raft_cagra_fused(const void* q, const void* bd0,
                                const void* bi0, const void* vecs,
                                const void* aux, const void* gph,
                                const void* pen, int m, int n, int itopk,
                                int width, int max_iter, int kprime,
                                int deg_p, int dim_p, int degree, int metric,
                                int store_bf16, void* out_d, void* out_i,
                                void* out_hops, void* out_parents,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (store_bf16) {
    return launch<uint16_t>(q, bd0, bi0, vecs, aux, gph, pen, m, n, itopk,
                            width, max_iter, kprime, deg_p, dim_p, degree,
                            metric, out_d, out_i, out_hops, out_parents, s);
  }
  return launch<int8_t>(q, bd0, bi0, vecs, aux, gph, pen, m, n, itopk, width,
                        max_iter, kprime, deg_p, dim_p, degree, metric, out_d,
                        out_i, out_hops, out_parents, s);
}
