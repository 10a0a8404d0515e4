// K6 — the whole CAGRA traversal in one launch.
//
// Replaces the TPU kernel raft_tpu/ops/cagra_fused.py::_fused_padded
// (kernel _kernel) in its two store modes, one library each so that their
// builds run in parallel: cagra_fused.cu (dense: int8 rows with per-edge
// scales, or bf16) and cagra_fused_int4.cu (split-half nibbles; the TPU
// kernel has no pq mode, nor has this one). From the seeded itopk buffer of each
// query, max_iter hops of the edge engine's hop body — pick the `width`
// best unexplored entries as parents (lowest buffer position on ties),
// score their edge tiles as K5 does, keep each parent's k' best, drop
// candidates whose id is in the buffer or earlier in (parent, rank) order,
// and fold the rest into the buffer by (value, concat position) with the
// explored flags carried. The TPU's grid axis over hops becomes a loop
// inside the warp, and the grid's fixed hop count an early exit: a hop
// with no finite unexplored entry changes nothing (the JAX kernel's extra
// grid steps are exact no-ops), so the warp stops there. A parent that is
// not finite is not expanded: its candidates would all be +inf, and since
// picks come in ascending order it can only follow the finite ones, so
// neither its tile nor its ids can change the result.
//
// Bound on this card: per hop a query reads `width` tiles (8 KB at 64 x
// 128 int8, 4 KB int4), aux and graph rows, so the bytes of the hops taken bound it;
// but a hop is a chain — pick, load, score, select, dedup, fold — whose
// every step waits on the one before, so instructions and latency are
// what a design has to cut.
//
// Design on Hopper:
// - Persistent warps, four to a block (fewer when a wide tile leaves four
//   above the card's shared memory a block), as many blocks as the card
//   keeps resident. A warp takes its next query from a counter in device
//   memory (atomicAdd; the entry zeroes it by a memset on the stream), so
//   no block waits on its slowest query and no partial second wave runs
//   at low occupancy. A query's result does not depend on which warp
//   takes it.
// - The buffer lives in registers: L = 32·NL cells (NL = 1, 2, 4, 8; L >=
//   itopk and deg_p), cell n = 32g + lane in register g, each a 64-bit
//   key (edge::sort_key: value order bits, buffer slot, the explored
//   flag in bit 0) and an id. Cells past itopk are +inf pads. A query's
//   seeded buffer is sorted by (value, slot) when it is loaded: each cell
//   counts the keys below its own in shared memory and moves there with
//   its id (a sort network in registers cost more registers and time). So
//   the seed may come in any order: the plain hop's picks and fold, by
//   (value, buffer position), read it in just that order.
// - Scoring and the per-parent top-k' are edge_score.cuh's, so K5 and K6
//   compute the same bits: the tile staged in the warp's shared memory,
//   the rows' sums by a reduce-scatter, a bitonic sort in registers.
// - Picks: the buffer is sorted by (value, slot), so the `width` best
//   unexplored entries are the first unexplored finite cells: one ballot
//   a register.
// - Dedup, in rank order: a candidate is dropped when its id is in the
//   buffer as it stands this hop, at an earlier rank of its parent, or
//   among an earlier parent's k' (dup_mask's rule: a node that has left
//   the buffer may come back). Of the hop's last parent only the ranks
//   below the buffer's last value take part: no other can enter the
//   buffer, and it could drop only later ranks of its own, which cannot
//   enter either. That leaves a few ranks a hop on the path's data, each
//   broadcast to the warp and compared with the buffer's ids and the
//   earlier ranks' in registers (and the earlier parents' ids in shared
//   memory): no table to build. A hop whose last parent has no such rank
//   skips its sort, dedup and fold.
// - Fold: each parent's survivors (finite, not dropped) are compacted in
//   rank order, so they stay sorted; they carry slot L + concat position,
//   after every buffer slot. The buffer's L best of both lists is
//   min(A[n], B[L - 1 - n]), a bitonic sequence, sorted by a bitonic
//   merge of log2 L shuffle steps; then cells take slots n again (a
//   parent's merge keeps the total order of the next). O(log L) a cell.
#pragma once

#include "edge_score.cuh"

namespace k6 {

constexpr int kWarps = 4;

// Cells a lane holds: the next power of two of max(itopk, deg_p) / 32.
inline int cells_per_lane(int itopk, int deg_p) {
  const int need = itopk > deg_p ? itopk : deg_p;
  int nl = 1;
  while (nl * 32 < need) nl <<= 1;
  return nl;
}

// 4-byte words of shared memory one warp uses (a multiple of 4, so every
// part is 16-byte aligned): the tile stage (stage_w words), the query,
// the compaction scratch (L keys, L ids), the ids of the hop's earlier
// parents' candidates, the parent ids.
__host__ __device__ inline size_t warp_words(int cells, int width,
                                             int kprime, int dim_p,
                                             size_t stage_w) {
  const size_t seen = ((size_t)(width - 1) * kprime + 3) & ~(size_t)3;
  const size_t w = stage_w + dim_p + 3 * (size_t)cells + seen +
                   (size_t)width;
  return (w + 3) & ~(size_t)3;
}

template <typename T>
inline size_t warp_bytes(int itopk, int width, int kprime, int deg_p,
                         int dim_p) {
  return sizeof(float) * warp_words(32 * cells_per_lane(itopk, deg_p), width,
                                    kprime, dim_p,
                                    edge::stage_words_at<T>(dim_p));
}

// One step J of the bitonic merge of the warp's NL·32 cells: the lower
// cell of each pair (n, n ^ J) keeps the smaller key, with its id.
template <int NL, int J>
__device__ __forceinline__ void merge_step(uint64_t (&key)[NL],
                                           int (&id)[NL], int lane) {
  if constexpr (J >= 32) {
    constexpr int jr = J / 32;
#pragma unroll
    for (int g = 0; g < NL; ++g) {
      if ((g & jr) == 0 && key[g | jr] < key[g]) {
        const uint64_t tk = key[g];
        key[g] = key[g | jr];
        key[g | jr] = tk;
        const int ti = id[g];
        id[g] = id[g | jr];
        id[g | jr] = ti;
      }
    }
  } else {
    const bool lower = (lane & J) == 0;
#pragma unroll
    for (int g = 0; g < NL; ++g) {
      const uint64_t o = __shfl_xor_sync(RAFT_FULL_MASK, key[g], J);
      const int oi = __shfl_xor_sync(RAFT_FULL_MASK, id[g], J);
      if (lower ? (o < key[g]) : (key[g] < o)) {
        key[g] = o;
        id[g] = oi;
      }
    }
  }
  if constexpr (J > 1) merge_step<NL, J / 2>(key, id, lane);
}

// The L best cells of the sorted lists A (ak, ai) and B (bk, bi), sorted,
// into A.
template <int NL>
__device__ __forceinline__ void merge_lists(uint64_t (&ak)[NL],
                                            int (&ai)[NL],
                                            const uint64_t (&bk)[NL],
                                            const int (&bi)[NL], int lane) {
#pragma unroll
  for (int g = 0; g < NL; ++g) {  // B[L - 1 - n] is cell (NL-1-g, 31-lane)
    const uint64_t rk = __shfl_xor_sync(RAFT_FULL_MASK, bk[NL - 1 - g], 31);
    const int ri = __shfl_xor_sync(RAFT_FULL_MASK, bi[NL - 1 - g], 31);
    if (rk < ak[g]) {
      ak[g] = rk;
      ai[g] = ri;
    }
  }
  merge_step<NL, NL * 16>(ak, ai, lane);
}

template <typename T, int NL, bool kOneChunk>
__global__ void __launch_bounds__(kWarps * 32, NL <= 2 ? 4 : 2)
cagra_fused_kernel(const float* __restrict__ q, const float* __restrict__ bd0,
                   const int* __restrict__ bi0, const char* __restrict__ vecs,
                   const float* __restrict__ aux, const int* __restrict__ gph,
                   const float* __restrict__ pen, int m, int n, int itopk,
                   int width, int max_iter, int kprime, int deg_p, int dim_p,
                   int degree, int metric, int* counter,
                   float* __restrict__ out_d, int* __restrict__ out_i,
                   int* __restrict__ out_hops, int* __restrict__ out_parents) {
  constexpr int L = NL * 32;
  using Scorer = edge::TileScorer<T, NL, kOneChunk>;
  constexpr size_t kStage = edge::stage_words<T, kOneChunk>();
  extern __shared__ __align__(16) float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* base = smem + (size_t)warp * warp_words(L, width, kprime, dim_p,
                                                 kStage);
  Scorer sc;
  sc.stage = reinterpret_cast<uint32_t*>(base);
  float* qs = base + kStage;
  uint64_t* sk = reinterpret_cast<uint64_t*>(qs + dim_p);  // compaction
  int* sid = reinterpret_cast<int*>(sk + L);
  int* seen = sid + L;  // earlier parents' candidate ids, this hop
  int* par = seen + (((width - 1) * kprime + 3) & ~3);
  const unsigned below = (1u << lane) - 1u;
  const size_t tile = (size_t)deg_p * Scorer::stored_row_bytes(dim_p);
  // the buffer's last cell: its value bounds what a candidate can enter
  const int last_reg = (itopk - 1) >> 5, last_lane = (itopk - 1) & 31;

  for (;;) {
    int qi = 0;
    if (lane == 0) qi = atomicAdd(counter, 1);
    qi = __shfl_sync(RAFT_FULL_MASK, qi, 0);
    if (qi >= m) break;
    for (int d = lane; d < dim_p; d += 32) qs[d] = q[(size_t)qi * dim_p + d];
    uint64_t bk[NL];
    int bid[NL];
#pragma unroll
    for (int g = 0; g < NL; ++g) {
      const int c = g * 32 + lane;
      const bool real = c < itopk;
      // pads sort after every real cell, whatever its value
      bk[g] = real ? edge::sort_key(bd0[(size_t)qi * itopk + c], c)
                   : (0xffffffffull << 32) | ((uint64_t)c << 2);
      bid[g] = real ? bi0[(size_t)qi * itopk + c] : -1;
    }
    if (max_iter > 0) {  // no hop: the buffer stays as it came
      // each cell's rank among the L keys (distinct: a pad's key holds its
      // slot), then every cell is written to its rank, with its id
#pragma unroll
      for (int g = 0; g < NL; ++g) {
        sk[g * 32 + lane] = bk[g];
        sid[g * 32 + lane] = bid[g];
      }
      __syncwarp();
      int rk[NL];
#pragma unroll
      for (int g = 0; g < NL; ++g) rk[g] = 0;
      for (int t = 0; t < L; ++t) {
        const uint64_t o = sk[t];
#pragma unroll
        for (int g = 0; g < NL; ++g) rk[g] += o < bk[g] ? 1 : 0;
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < NL; ++g) {
        sk[rk[g]] = bk[g];
        sid[rk[g]] = bid[g];
      }
      __syncwarp();
#pragma unroll
      for (int g = 0; g < NL; ++g) {
        const int c = g * 32 + lane;
        if (c < itopk) {  // cells take slots n, as after a fold
          bk[g] = (sk[c] & ~0xfffffffcull) | ((uint64_t)c << 2);
          bid[g] = sid[c];
        } else {
          bk[g] = edge::sort_key(CUDART_INF_F, c);
          bid[g] = -1;
        }
      }
    }
    __syncwarp();
    float qn = edge::warp_sqnorm(qs, dim_p, lane);

    int hops = 0, expanded = 0;
    for (int h = 0; h < max_iter; ++h) {
      // parents: the first `width` unexplored finite cells
      int n_ok = 0;
#pragma unroll
      for (int g = 0; g < NL; ++g) {
        const bool open = g * 32 + lane < itopk && !(bk[g] & 1u) &&
                          edge::key_finite(bk[g]);
        unsigned mk = __ballot_sync(RAFT_FULL_MASK, open);
        while (mk != 0u && n_ok < width) {
          const int b = __ffs(mk) - 1;
          mk &= mk - 1u;
          if (lane == b) bk[g] |= 1u;
          const int pid = __shfl_sync(RAFT_FULL_MASK, bid[g], b);
          if (lane == 0) par[n_ok] = pid;
          ++n_ok;
        }
      }
      __syncwarp();
      if (n_ok == 0) break;  // frontier closed: every later hop is a no-op
      ++hops;
      expanded += n_ok;
      // the ids of the buffer as it stands this hop
      int hid[NL];
#pragma unroll
      for (int g = 0; g < NL; ++g) hid[g] = g * 32 + lane < itopk ? bid[g]
                                                                 : INT_MIN;

      for (int w = 0; w < n_ok; ++w) {
        const size_t pid = (size_t)min(max(par[w], 0), n - 1);
        int idr[NL];
#pragma unroll
        for (int g = 0; g < NL; ++g) {
          const int e = g * 32 + lane;
          idr[g] = e < deg_p ? __ldg(gph + pid * deg_p + e) : -1;
        }
        sc.issue(vecs + pid * tile, aux + pid * 2 * deg_p,
                 pen != nullptr ? pen + pid * deg_p : nullptr, deg_p, dim_p,
                 lane);
        float dist[NL];
        sc.finish(qs, qn, false, dim_p, degree, metric, pen != nullptr, lane,
                  dist);
        // the ranks that can drop or be dropped: all k' of a parent whose
        // ids can still drop a later parent's; of the last parent only
        // those below the buffer's last value — no other can enter the
        // buffer, and it can drop only later ranks, which cannot either
        const bool last = w == n_ok - 1;
        int lim = kprime;
        if (last) {
          uint32_t th = 0u;  // the buffer's last value's order bits
#pragma unroll
          for (int g = 0; g < NL; ++g) {
            const uint32_t t = __shfl_sync(RAFT_FULL_MASK,
                                           (uint32_t)(bk[g] >> 32), last_lane);
            if (g == last_reg) th = t;
          }
          int under = 0;
#pragma unroll
          for (int g = 0; g < NL; ++g) {
            under += __popc(__ballot_sync(
                RAFT_FULL_MASK,
                (uint32_t)(edge::sort_key(dist[g], 0) >> 32) < th));
          }
          if (under == 0) continue;  // nothing can enter the buffer
          lim = min(lim, under);
        }
        uint64_t ck[NL];
        edge::sort_tile<NL>(dist, lane, ck);
        int cid[NL];  // rank 32g + lane's id; -1 past the finite values
#pragma unroll
        for (int g = 0; g < NL; ++g) {
          const int e = edge::key_pos(ck[g]);
          int id = -1;
#pragma unroll
          for (int gg = 0; gg < NL; ++gg) {
            const int t = __shfl_sync(RAFT_FULL_MASK, idr[gg], e & 31);
            if (gg == (e >> 5)) id = t;
          }
          cid[g] = edge::key_finite(ck[g]) ? id : -1;
        }
        // dedup in rank order: rank j is dropped when its id is in the
        // buffer, at an earlier rank, or among an earlier parent's k'
        bool drop[NL];
#pragma unroll
        for (int g = 0; g < NL; ++g) drop[g] = false;
        for (int j = 0; j < lim; ++j) {
          int src = cid[0];
#pragma unroll
          for (int g = 1; g < NL; ++g) {
            if (g == (j >> 5)) src = cid[g];
          }
          const int x = __shfl_sync(RAFT_FULL_MASK, src, j & 31);
          bool hit = false;
#pragma unroll
          for (int g = 0; g < NL; ++g) {
            hit |= hid[g] == x || (cid[g] == x && g * 32 + lane < j);
          }
          for (int s = lane; s < w * kprime; s += 32) hit |= seen[s] == x;
          const bool any = __any_sync(RAFT_FULL_MASK, hit);
#pragma unroll
          for (int g = 0; g < NL; ++g) {
            drop[g] |= any && g == (j >> 5) && lane == (j & 31);
          }
        }
        if (!last) {
#pragma unroll
          for (int g = 0; g < NL; ++g) {
            const int r = g * 32 + lane;
            if (r < kprime) seen[w * kprime + r] = cid[g];
          }
        }
        // the survivors, compacted in rank order
        int cnt = 0;
#pragma unroll
        for (int g = 0; g < NL; ++g) {
          const int r = g * 32 + lane;
          const bool ok = r < lim && !drop[g] && edge::key_finite(ck[g]);
          const unsigned okm = __ballot_sync(RAFT_FULL_MASK, ok);
          if (ok) {
            const int dst = cnt + __popc(okm & below);
            sk[dst] = (ck[g] & ~0xfffffffcull) |
                      ((uint64_t)(L + w * kprime + r) << 2);
            sid[dst] = cid[g];
          }
          cnt += __popc(okm);
        }
        __syncwarp();
        if (cnt == 0) continue;  // nothing to fold
        uint64_t nk[NL];
        int ni[NL];
#pragma unroll
        for (int g = 0; g < NL; ++g) {
          const int c = g * 32 + lane;
          nk[g] = c < cnt ? sk[c]
                          : edge::sort_key(CUDART_INF_F, (width + 1) * L + c);
          ni[g] = c < cnt ? sid[c] : -1;
        }
        __syncwarp();
        merge_lists<NL>(bk, bid, nk, ni, lane);
        // cells take their slots again; past itopk they become pads
#pragma unroll
        for (int g = 0; g < NL; ++g) {
          const int c = g * 32 + lane;
          if (c < itopk) {
            bk[g] = (bk[g] & ~0xfffffffcull) | ((uint64_t)c << 2);
          } else {
            bk[g] = edge::sort_key(CUDART_INF_F, c);
            bid[g] = -1;
          }
        }
      }
    }

#pragma unroll
    for (int g = 0; g < NL; ++g) {
      const int c = g * 32 + lane;
      if (c < itopk) {
        out_d[(size_t)qi * itopk + c] = edge::key_value(bk[g]);
        out_i[(size_t)qi * itopk + c] = bid[g];
      }
    }
    if (lane == 0) {
      out_hops[qi] = hops;
      out_parents[qi] = expanded;
    }
    __syncwarp();  // every lane is done with the state before the next query
  }
}

// The instance for the shape (dim_p 128 takes the one-chunk instance,
// see edge::TileScorer), or null past itopk / deg_p 256.
template <typename T, int NL>
const void* kernel_of(int dim_p) {
  return dim_p == edge::kChunk
             ? (const void*)&cagra_fused_kernel<T, NL, true>
             : (const void*)&cagra_fused_kernel<T, NL, false>;
}

template <typename T>
const void* kernel_for(int itopk, int deg_p, int dim_p) {
  switch (cells_per_lane(itopk, deg_p)) {
    case 1:
      return kernel_of<T, 1>(dim_p);
    case 2:
      return kernel_of<T, 2>(dim_p);
    case 4:
      return kernel_of<T, 4>(dim_p);
    case 8:
      return kernel_of<T, 8>(dim_p);
    default:
      return nullptr;
  }
}

template <typename T>
int info(int itopk, int width, int kprime, int deg_p, int dim_p, int* out) {
  const void* kern = kernel_for<T>(itopk, deg_p, dim_p);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  return (int)edge::instance_info(
      kern, kWarps, warp_bytes<T>(itopk, width, kprime, deg_p, dim_p), out);
}

// counter: one int of device memory, zeroed here on the stream.
template <typename T>
int launch(const void* q, const void* bd0, const void* bi0, const void* vecs,
           const void* aux, const void* gph, const void* pen, int m, int n,
           int itopk, int width, int max_iter, int kprime, int deg_p,
           int dim_p, int degree, int metric, void* counter, void* out_d,
           void* out_i, void* out_hops, void* out_parents, void* stream) {
  const void* kern = kernel_for<T>(itopk, deg_p, dim_p);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(counter, 0, sizeof(int), s);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&q,      &bd0,    &bi0,    &vecs,     &aux,
                  &gph,    &pen,    &m,      &n,        &itopk,
                  &width,  &max_iter, &kprime, &deg_p,  &dim_p,
                  &degree, &metric, &counter, &out_d,
                  &out_i,  &out_hops, &out_parents};
  return (int)edge::launch_persistent(
      kern, kWarps, warp_bytes<T>(itopk, width, kprime, deg_p, dim_p), m,
      args, s);
}

}  // namespace k6
