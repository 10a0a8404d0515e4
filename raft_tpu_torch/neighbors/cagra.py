"""CAGRA graph-based ANN: counterpart of ``raft_tpu/neighbors/cagra.py``
(``BuildAlgo``, ``IndexParams``, ``SearchParams``, ``Index``, ``ENGINES``,
``build_knn_graph``, ``optimize``, ``build``, ``build_covering_seeds``,
``prepare_search``, ``prepare_traversal``, ``search``).

Build: the exact all-points kNN graph (``knn_graph_algo="brute"``:
brute-force search through K2 + the K1 merge, in query batches), the
detour-count prune plus reverse-edge merge of ``optimize`` (plain
PyTorch, bit-equal to the JAX package's), and the covering seed set
(nearest rows to fixed-iteration k-means centers). ``"auto"`` takes the
exact graph up to :data:`BRUTE_N` rows; NN-descent and the IVF-PQ graph
pass, and ``BuildAlgo.NN_DESCENT``, are not ported yet.

Search: seed the itopk buffer (per-query random rows drawn by
:func:`_draw_seeds`, plus the shared covering set), run the hop loop,
then re-score the returned k exactly in float32. Engines:

* ``"gather"`` — plain PyTorch hops that gather each parent's neighbor
  rows from the traversal copy of the dataset (``candidate_dtype``
  bf16, int8 or float32);
* ``"edge"`` — one K5 launch per hop over the edge store
  (``prepare_traversal``); the loop stops when no finite unexplored
  entry is left, which costs one host read per hop;
* ``"fused"`` — the whole traversal in one K6 launch, equal to the edge
  engine in ids and distances;
* ``"auto"`` — ``"edge"`` on CUDA when a store is attached, else
  ``"gather"`` (no autotune cache).

Every selection (the buffer, the parent pick, the merges, the final
re-rank) goes through ``select_k`` — K1 on CUDA. A filtered search
equals the JAX package's under ``filter_policy.suspended()``: the
adaptive widen/crossover is not ported. Not ported either: the guarded
fallback chains (a kernel failure raises), int4 and PQ edge stores,
``save``/``load``, ``health``, ``tune_search``, ``make_searcher`` and the
deadline/``query_chunk`` path. The TPU-only build paths
(``_parted_brute_graph``'s compile cap, the tail-wrapping batch loop)
have no counterpart. Every matrix product runs in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.bitset import Bitset
from ..core.errors import expects
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..ops.cagra_fused import (dup_mask, edge_hop, fused_traverse,
                               merge_candidates, pick_parents)
from ..ops.quant import quantize_rows
from ..utils import resolve_device, round_up_to
from . import brute_force
from .ivf_pq import _kmeans_fixed

__all__ = ["BuildAlgo", "IndexParams", "SearchParams", "Index", "EdgeStore",
           "ENGINES", "BRUTE_N", "build", "build_knn_graph", "optimize",
           "build_covering_seeds", "prepare_search", "prepare_traversal",
           "search"]

ENGINES = ("gather", "edge", "fused")
# knn_graph_algo="auto": the exact graph up to this many rows, NN-descent
# above (the JAX package's default crossover)
BRUTE_N = 200_000
_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.InnerProduct)
_INF = float("inf")


class BuildAlgo(enum.Enum):
    """cagra_types.hpp graph_build_algo."""

    IVF_PQ = 0
    NN_DESCENT = 1


@dataclasses.dataclass
class IndexParams:
    """Mirror of cagra::index_params (cagra_types.hpp:66). ``seed``: the
    covering seed set's subsample and k-means seed. ``seed_nodes``: size
    of that set; -1 → max(128, min(2048, n // 64)) when n is more than 4x
    that, 0 → none. NN-descent (and its ``nn_descent_niter``) is not
    ported."""

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    build_algo: BuildAlgo = BuildAlgo.IVF_PQ
    metric: DistanceType | str = DistanceType.L2Expanded
    seed: int = 0
    knn_graph_algo: str = "auto"
    seed_nodes: int = -1


@dataclasses.dataclass
class SearchParams:
    """Mirror of cagra::search_params (cagra_types.hpp:113).
    ``candidate_dtype``: the gather engine's traversal copy ("bfloat16",
    "int8" per-row scaled, or "float32"); the returned k are re-scored in
    float32 whatever it is. ``seed``: the random seed rows' generator
    seed. ``algo``: the reference's strategies, all one plan here."""

    itopk_size: int = 64
    search_width: int = 1
    max_iterations: int = 0        # 0 → itopk // width + 16
    min_iterations: int = 0
    num_random_samplings: int = 1
    candidate_dtype: str = "bfloat16"
    seed: int = 0x5EED
    algo: str = "auto"
    engine: str = "auto"


@dataclasses.dataclass
class EdgeStore:
    """The edge-resident candidate store of :func:`prepare_traversal`:
    ``vecs`` (n, deg_p, dim_p) int8 | bf16 — node i's neighbors' stored
    vectors, ``aux`` (n, 2, deg_p) float32 — [per-edge scales, dequantized
    norms], ``gp`` (n, deg_p) int32 — the graph rows, zero-padded."""

    mode: str            # "int8" | "bfloat16"
    degree: int
    deg_p: int
    dim_p: int
    vecs: torch.Tensor
    aux: torch.Tensor
    gp: torch.Tensor


@dataclasses.dataclass
class Index:
    """Dataset + fixed-degree neighbor graph (cagra_types.hpp:134).
    ``seed_nodes``: optional sorted unique (s,) int32 covering rows. The
    traversal copies (``score_bf16``, ``score_i8``), the edge store and
    ``build_stats`` are attached later."""

    dataset: torch.Tensor                  # (n, dim) float32
    graph: torch.Tensor                    # (n, degree) int32
    metric: DistanceType
    seed_nodes: Optional[torch.Tensor] = None
    score_bf16: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)
    score_i8: Optional[Tuple[torch.Tensor, torch.Tensor]] = \
        dataclasses.field(default=None, repr=False)
    edge_store: Optional[EdgeStore] = dataclasses.field(default=None,
                                                        repr=False)
    build_stats: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dataset.device


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ------------------------------------------------------------------ build


def _drop_self_pad(ref: torch.Tensor, rows: torch.Tensor, k: int, n: int
                   ) -> torch.Tensor:
    """Per row: the first k entries of ``ref`` that are valid and not the
    row itself, cycling the valid ones to fill a shortfall ((row+1) % n
    when there is none)."""
    w = ref.shape[1]
    valid = (ref >= 0) & (ref != rows[:, None])
    pos = torch.arange(w, device=ref.device)
    order = torch.argsort(torch.where(valid, pos, w + pos), dim=1)
    ref_s = torch.gather(ref, 1, order)
    n_ok = torch.gather(valid, 1, order).sum(dim=1, keepdim=True)
    idx = torch.where(n_ok > 0, pos[None, :k] % torch.clamp_min(n_ok, 1), 0)
    out = torch.gather(ref_s, 1, idx)
    return torch.where(n_ok > 0, out, (rows[:, None] + 1) % n).to(
        torch.int32)


def build_knn_graph(dataset, k: int, metric=DistanceType.L2Expanded,
                    batch: int = 32768, algo: str = "auto",
                    device=None) -> torch.Tensor:
    """All-points kNN graph (cagra_build.cuh:43) → (n, k) int32 neighbor
    ids on the device, self-edges removed. ``algo``: "brute" (exact:
    brute-force search, K2 + K1 on CUDA, ``batch`` query rows at a time)
    or "auto" (brute up to :data:`BRUTE_N` rows); the random builders,
    "nn_descent" and "ivf_pq", are not ported yet."""
    dev = resolve_device(device)
    x = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    n = x.shape[0]
    expects(algo in ("auto", "brute", "ivf_pq", "nn_descent"),
            "unknown knn_graph algo %r", algo)
    if algo == "auto":
        algo = "brute" if n <= BRUTE_N else "nn_descent"
    expects(algo == "brute", "knn_graph algo %r is not ported yet (n=%d)",
            algo, n)
    index = brute_force.build(x, canonical_metric(metric), device=dev)
    kq = min(n, k + 1)
    graph = torch.empty((n, k), dtype=torch.int32, device=dev)
    for b0 in range(0, n, batch):
        rows = torch.arange(b0, min(b0 + batch, n), device=dev)
        _, cand = brute_force.search(index, x[b0:b0 + batch], kq)
        graph[b0:b0 + batch] = _drop_self_pad(cand.long(), rows, k, n)
    return graph


def _detour_counts(graph: torch.Tensor, nodes: torch.Tensor) -> torch.Tensor:
    """(B, d0) detour counts (kern_prune): edge (i, N_i[t]) counts one
    detour for every closer neighbor N_i[a] (a < t) whose own row holds
    N_i[t]. Membership is a binary search of N_i[t] in each sorted row
    N(N_i[a]), so the peak is O(B·d0²) — not the (B, d0, d0, d0) compare
    XLA fuses into its reduction. The counts are integers, so they equal
    the JAX package's exactly."""
    nbrs = graph[nodes]                                   # (B, d0)
    b, d0 = nbrs.shape
    rows = torch.sort(graph[nbrs.long()], dim=2).values   # (B, a, c)
    probe = nbrs[:, None, :].expand(b, d0, d0).contiguous()   # (B, a, t)
    pos = torch.searchsorted(rows, probe, out_int32=True)
    hit = torch.gather(rows, 2, pos.clamp_max(d0 - 1).long()) == probe
    before = torch.triu(torch.ones((d0, d0), dtype=torch.bool,
                                   device=graph.device), diagonal=1)
    return (hit & before).sum(dim=1)                      # (B, t)


def _prune_batch(graph: torch.Tensor, nodes: torch.Tensor,
                 graph_degree: int) -> torch.Tensor:
    """Keep each node's ``graph_degree`` edges with the fewest detours,
    ties to the closer rank."""
    d0 = graph.shape[1]
    key = (_detour_counts(graph, nodes) * d0
           + torch.arange(d0, device=graph.device)[None, :])
    order = torch.argsort(key, dim=1, stable=True)[:, :graph_degree]
    return torch.gather(graph[nodes], 1, order)


def _rev_group(pruned: torch.Tensor, keep_fwd: int, rev_cap: int
               ) -> torch.Tensor:
    """Reverse-edge table (kern_make_rev_graph): the sources of each
    node's incoming forward edges, rank-0 edges first (a column-major
    flatten, stably sorted by target), at most ``rev_cap`` per node, -1
    padded."""
    n = pruned.shape[0]
    dev = pruned.device
    tgt = pruned[:, :keep_fwd].T.reshape(-1).long()
    src = torch.arange(n, device=dev).repeat(keep_fwd)
    tgt = torch.where((tgt >= 0) & (tgt < n), tgt, n)     # junk → row n
    ts, so = torch.sort(tgt, stable=True)
    cs = src[so]
    counts = torch.bincount(ts, minlength=n + 1)
    seg_start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(ts.shape[0], device=dev) - seg_start[ts]
    keep = (pos < rev_cap) & (ts < n)
    rev = torch.full((n, rev_cap), -1, dtype=torch.int32, device=dev)
    rev[ts[keep], pos[keep]] = cs[keep].to(torch.int32)
    return rev


def _merge_tail_batch(kept: torch.Tensor, cand: torch.Tensor,
                      rows: torch.Tensor, tail_w: int) -> torch.Tensor:
    """Per row: the first ``tail_w`` candidates (in order) that are valid,
    not the row, not in ``kept`` and not earlier in ``cand``; a shortfall
    takes the last kept edge."""
    w = cand.shape[1]
    dup_kept = (cand[:, :, None] == kept[:, None, :]).any(dim=2)
    dup_prior = torch.tril(cand[:, :, None] == cand[:, None, :],
                           diagonal=-1).any(dim=2)
    valid = ((cand >= 0) & (cand != rows[:, None]) & ~dup_kept
             & ~dup_prior)
    pos = torch.arange(w, device=cand.device)
    order = torch.argsort(torch.where(valid, pos, w + pos),
                          dim=1)[:, :tail_w]
    tail = torch.gather(cand, 1, order)
    ok = torch.gather(valid, 1, order)
    return torch.where(ok, tail, kept[:, -1:])


def optimize(knn_graph: torch.Tensor, graph_degree: int,
             batch: int = 2048) -> torch.Tensor:
    """Detour-count prune + reverse-edge merge (graph_core.cuh:128-191):
    keep the ``graph_degree`` edges with the fewest detours (ties to the
    closer rank), then refill the tail half with reverse edges and the
    remaining forward edges, interleaved 1:1. Node batches bound the
    (B, d0, d0) membership planes. Returns (n, graph_degree) int32 on
    the graph's device."""
    g = torch.as_tensor(knn_graph).to(torch.int32)
    n, d0 = g.shape
    expects(graph_degree <= d0, "graph_degree %d > intermediate %d",
            graph_degree, d0)
    batch = max(256, min(batch * 8, (1 << 30) // max(d0 * d0 * 16, 1)))
    batch = min(batch, n)
    keep_fwd = graph_degree - graph_degree // 2
    tail_w = graph_degree - keep_fwd
    dev = g.device
    pruned = torch.empty((n, graph_degree), dtype=torch.int32, device=dev)
    for b0 in range(0, n, batch):
        nodes = torch.arange(b0, min(b0 + batch, n), device=dev)
        pruned[b0:b0 + batch] = _prune_batch(g, nodes, graph_degree)
    rev = _rev_group(pruned, keep_fwd, graph_degree)
    fwd_tail = torch.full((n, graph_degree), -1, dtype=torch.int32,
                          device=dev)
    fwd_tail[:, :tail_w] = pruned[:, keep_fwd:]
    cand = torch.stack([rev, fwd_tail], dim=2).reshape(n, 2 * graph_degree)
    out = pruned.clone()
    for b0 in range(0, n, batch):
        rows = torch.arange(b0, min(b0 + batch, n), device=dev)
        out[b0:b0 + batch, keep_fwd:] = _merge_tail_batch(
            pruned[b0:b0 + batch, :keep_fwd], cand[b0:b0 + batch], rows,
            tail_w)
    return out


def build_covering_seeds(dataset: torch.Tensor, p: IndexParams
                         ) -> Optional[torch.Tensor]:
    """The seed-set policy applied to a corpus → (s,) sorted unique int32
    rows, or None (see ``IndexParams.seed_nodes``; an explicit request
    below 64 rows — search's threshold — builds none)."""
    n = dataset.shape[0]
    if p.seed_nodes < 0:
        s = max(128, min(2048, n // 64))
        s = s if n > 4 * s else 0
    else:
        s = min(p.seed_nodes, n // 4)
        s = 0 if s < 64 else s
    return _covering_seeds(dataset, s, p.seed) if s > 0 else None


def _covering_seeds(dataset: torch.Tensor, s: int, seed: int
                    ) -> torch.Tensor:
    """Rows nearest (squared L2, whatever the index metric: the set must
    cover the corpus's geometry) to ``s`` centers of a 10-iteration Lloyd
    on a subsample of max(8s, 20,000) rows."""
    n = dataset.shape[0]
    dev = dataset.device
    rng = np.random.default_rng(seed)
    t = min(n, max(8 * s, 20_000))
    rows = torch.from_numpy(rng.choice(n, size=t, replace=False)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    cent = _kmeans_fixed(dataset[rows][None], s, 10, gen)[0]
    index = brute_force.build(dataset, DistanceType.L2Expanded, device=dev)
    _, ids = brute_force.search(index, cent, 1)
    return torch.unique(ids[:, 0]).to(torch.int32)


def build(dataset, params: IndexParams | None = None, device=None) -> Index:
    """kNN graph → optimize → covering seeds → index (cagra_build.cuh:292),
    on ``device`` (the CUDA card by default). ``build_stats`` holds the
    stage seconds (``knn_graph_s``, ``optimize_s``, ``seeds_s``)."""
    p = params or IndexParams()
    dev = resolve_device(device)
    x = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    expects(x.dim() == 2, "dataset must be (n, d)")
    x = x.contiguous()
    n = x.shape[0]
    mt = canonical_metric(p.metric)
    expects(mt in _METRICS, "cagra supports L2/IP metrics, got %s", mt.name)
    expects(p.build_algo is BuildAlgo.IVF_PQ,
            "BuildAlgo.NN_DESCENT is not ported yet")
    d0 = min(p.intermediate_graph_degree, n - 1)
    degree = min(p.graph_degree, d0)
    _sync(dev)
    t0 = time.perf_counter()
    knn = build_knn_graph(x, d0, mt, algo=p.knn_graph_algo, device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    graph = optimize(knn, degree)
    _sync(dev)
    t2 = time.perf_counter()
    seeds = build_covering_seeds(x, p)
    _sync(dev)
    t3 = time.perf_counter()
    index = Index(x, graph, mt, seeds)
    index.build_stats = {"n": n, "knn_algo": "brute",
                         "knn_graph_s": t1 - t0, "optimize_s": t2 - t1,
                         "seeds_s": t3 - t2}
    return index


# ----------------------------------------------------------- traversal


def prepare_search(index: Index, candidate_dtype: str = "bfloat16") -> None:
    """Attach the gather engine's traversal copy of the dataset for
    ``candidate_dtype`` ("bfloat16" or "int8"; "float32" needs none)."""
    if candidate_dtype in ("bfloat16", "bf16"):
        if index.score_bf16 is None:
            index.score_bf16 = index.dataset.to(torch.bfloat16)
    elif candidate_dtype in ("int8", "i8"):
        if index.score_i8 is None:
            index.score_i8 = quantize_rows(index.dataset, torch.int8)


def prepare_traversal(index: Index, candidate_dtype: str = "int8") -> None:
    """Build the edge store (:class:`EdgeStore`) and attach it: for every
    node, its ``degree`` neighbors' stored vectors as one contiguous
    (deg_p, dim_p) tile, deg_p = degree rounded up to 32 and dim_p = dim
    rounded up to 128, zero-padded. "int8" (the default: per-row scales,
    the int8 traversal copy's codes) or "bfloat16"; "int4" and "pq" are
    not ported yet. A second call with the same geometry does nothing."""
    expects(candidate_dtype in ("int8", "i8", "bfloat16", "bf16", "int4",
                                "i4", "pq"),
            "edge store dtype must be int8/bfloat16/int4/pq, got %r",
            candidate_dtype)
    expects(candidate_dtype not in ("int4", "i4", "pq"),
            "edge store dtype %r is not ported yet", candidate_dtype)
    int8 = candidate_dtype in ("int8", "i8")
    mode = "int8" if int8 else "bfloat16"
    n, dim = index.size, index.dim
    degree = index.graph_degree
    deg_p, dim_p = round_up_to(degree, 32), round_up_to(dim, 128)
    cur = index.edge_store
    if cur is not None and (cur.mode, cur.degree, cur.deg_p, cur.dim_p) == (
            mode, degree, deg_p, dim_p):
        return
    prepare_search(index, mode)
    g = index.graph.long()
    if int8:
        stored, scales = index.score_i8
        norms = (scales * scales) * stored.to(torch.float32).square().sum(1)
        es = scales[g]
    else:
        stored = index.score_bf16
        norms = stored.to(torch.float32).square().sum(1)
        es = torch.ones(g.shape, dtype=torch.float32, device=index.device)
    if (deg_p, dim_p) == (degree, dim):
        vecs = stored[g]
    else:
        # fill in row chunks: stored[g] whole and then a padded copy would
        # hold the store twice
        vecs = torch.zeros((n, deg_p, dim_p), dtype=stored.dtype,
                           device=index.device)
        step = max(1, (256 << 20) // max(degree * dim * stored.itemsize, 1))
        for r0 in range(0, n, step):
            vecs[r0:r0 + step, :degree, :dim] = stored[g[r0:r0 + step]]
    aux = torch.zeros((n, 2, deg_p), dtype=torch.float32,
                      device=index.device)
    aux[:, 0, :degree] = es
    aux[:, 1, :degree] = norms[g]
    gp = torch.zeros((n, deg_p), dtype=torch.int32, device=index.device)
    gp[:, :degree] = index.graph
    index.edge_store = EdgeStore(mode, degree, deg_p, dim_p,
                                 vecs.contiguous(), aux, gp)


def _plan_dims(p: SearchParams, k: int) -> Tuple[int, int, int]:
    """(itopk, width, max_iter) of the traversal plan."""
    itopk = max(p.itopk_size, k)
    width = max(1, p.search_width)
    max_iter = p.max_iterations or (itopk // width + 16)
    return itopk, width, max(int(max_iter), int(p.min_iterations))


def _query_dists(qc: torch.Tensor, vecs: torch.Tensor, mt: DistanceType
                 ) -> torch.Tensor:
    """(m, c, d) candidate vectors → (m, c) distances to qc (m, d). bf16
    candidates meet the query rounded to bf16 with float32 products and
    sums (exact products: both operands are widened first)."""
    qv = qc.to(torch.bfloat16).to(torch.float32) \
        if vecs.dtype == torch.bfloat16 else qc
    v = vecs.to(torch.float32)
    ip = torch.einsum("mcd,md->mc", v, qv)
    if mt is DistanceType.InnerProduct:
        return -ip
    q2 = (qc * qc).sum(dim=1, keepdim=True)
    return torch.clamp_min(q2 + (v * v).sum(dim=2) - 2.0 * ip, 0.0)


def _gather_score(score: torch.Tensor, scales: Optional[torch.Tensor],
                  cand: torch.Tensor, qc: torch.Tensor, mt: DistanceType
                  ) -> torch.Tensor:
    """Gather the candidates' rows of the traversal copy (int8 rows times
    their scales) and score them against the queries."""
    cand = cand.long()
    vecs = score[cand]
    if scales is not None:
        vecs = vecs.to(torch.float32) * scales[cand][..., None]
    return _query_dists(qc, vecs, mt)


def _seed_dists(qc: torch.Tensor, vecs: torch.Tensor, mt: DistanceType
                ) -> torch.Tensor:
    """(s, d) shared seed rows → (m, s) distances: one matrix product."""
    qv = qc.to(torch.bfloat16).to(torch.float32) \
        if vecs.dtype == torch.bfloat16 else qc
    v = vecs.to(torch.float32)
    ip = qv @ v.T
    if mt is DistanceType.InnerProduct:
        return -ip
    q2 = (qc * qc).sum(dim=1, keepdim=True)
    return torch.clamp_min(q2 + (v * v).sum(dim=1)[None, :] - 2.0 * ip,
                           0.0)


def _draw_seeds(m: int, n_seeds: int, high: int, seed: int,
                device: torch.device) -> torch.Tensor:
    """(m, n_seeds) uniform integers in [0, high): the random seed rows
    (or, under a filter, ranks among the surviving rows). The one place
    the search draws random numbers."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, high, (m, n_seeds), generator=gen,
                         device=device)


def _seed_buffer(index, score, scales, q, mask, n_seeds, itopk, seed):
    """The seeded itopk buffer (buf_d, buf_i): random rows (survivors
    only under a filter) with duplicates dropped, plus the shared
    covering set, the itopk best of them."""
    m = q.shape[0]
    n = index.size
    dev = index.device
    mt = index.metric
    if mask is not None:
        csum = torch.cumsum(mask.to(torch.int64), 0)
        r = _draw_seeds(m, n_seeds, max(int(csum[-1]), 1), seed, dev)
        seeds = torch.clamp_max(
            torch.searchsorted(csum, r.to(device=dev, dtype=torch.int64)
                               + 1), n - 1)
        seed_d = _gather_score(score, scales, seeds, q, mt)
        seed_d = torch.where(mask[seeds], seed_d, _INF)
    else:
        seeds = _draw_seeds(m, n_seeds, n, seed, dev).to(device=dev,
                                                          dtype=torch.int64)
        seed_d = _gather_score(score, scales, seeds, q, mt)
    seed_d = torch.where(dup_mask(seeds), _INF, seed_d)
    srows = index.seed_nodes
    if srows is not None:
        sl = srows.long()
        svecs = score[sl]
        if scales is not None:
            svecs = svecs.to(torch.float32) * scales[sl][:, None]
        sd = _seed_dists(q, svecs, mt)
        if mask is not None:
            sd = torch.where(mask[sl][None, :], sd, _INF)
        # a random seed equal to a shared one is a duplicate (the shared
        # set is sorted, so membership is a binary search)
        pos = torch.searchsorted(sl, seeds).clamp_max(sl.shape[0] - 1)
        seed_d = torch.where(sl[pos] == seeds, _INF, seed_d)
        seeds = torch.cat([sl[None, :].expand(m, -1), seeds], dim=1)
        seed_d = torch.cat([sd, seed_d], dim=1)
    total = seed_d.shape[1]
    if total < itopk:
        seed_d = torch.nn.functional.pad(seed_d, (0, itopk - total),
                                         value=_INF)
        seeds = torch.nn.functional.pad(seeds, (0, itopk - total), value=-1)
    buf_d, srt = select_k(seed_d.contiguous(), itopk)
    return buf_d, torch.gather(seeds, 1, srt.long()).to(torch.int32)


def _gather_hop(index, score, scales, q, mask, buf_d, buf_i, explored,
                width):
    """One hop of the gather engine: every neighbor of each parent,
    scored from the traversal copy."""
    m = q.shape[0]
    degree = index.graph_degree
    psafe, parent_ok, explored = pick_parents(buf_d, buf_i, explored, width,
                                              select_k)
    cand = index.graph[psafe].reshape(m, width * degree)
    cand_ok = parent_ok.repeat_interleave(degree, dim=1)
    cd = _gather_score(score, scales, cand, q, index.metric)
    if mask is not None:
        cand_ok = cand_ok & mask[cand.long()]
    return merge_candidates(buf_d, buf_i, explored, cand, cd, cand_ok,
                            select_k)


def search(index: Index, queries, k: int,
           params: SearchParams | None = None,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           engine: Optional[str] = None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-frontier graph traversal (search_single_cta) → (distances
    (m, k), int32 ids (m, k)) on the index's device; -1 ids (+inf, or
    -inf for inner product) where fewer than k were found.

    ``filter``: optional sample bitset, cleared bits excluded. ``engine``
    overrides ``SearchParams.engine``: "gather", "edge" (K5 per hop),
    "fused" (K6) or "auto"; "edge" and "fused" build the int8 edge store
    first when none is attached."""
    p = params or SearchParams()
    dev = index.device
    q = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "bad query shape %s", tuple(q.shape))
    q = q.contiguous()
    itopk, width, max_iter = _plan_dims(p, k)
    if (index.seed_nodes is not None and filter is None
            and index.seed_nodes.shape[0] >= 64):
        # the covering set seeds; random rows stay as insurance
        n_seeds = min(itopk, 16 * p.num_random_samplings)
    else:
        n_seeds = min(itopk, max(width * index.graph_degree // 2,
                                 16 * p.num_random_samplings))
    mask = filter.to(dev).to_mask() if filter is not None else None
    expects(p.candidate_dtype in ("bfloat16", "bf16", "int8", "i8",
                                  "float32", "f32"),
            "unknown candidate_dtype %r", p.candidate_dtype)
    expects(p.algo in ("auto", "single_cta", "multi_cta", "multi_kernel"),
            "unknown cagra search algo %r", p.algo)
    eng = engine or p.engine
    expects(eng in ("auto",) + ENGINES, "unknown cagra traversal engine %r",
            eng)
    if eng == "auto":
        eng = ("edge" if index.edge_store is not None and dev.type == "cuda"
               else "gather")
    prepare_search(index, p.candidate_dtype)
    if p.candidate_dtype in ("int8", "i8"):
        score, scales = index.score_i8
    elif p.candidate_dtype in ("bfloat16", "bf16"):
        score, scales = index.score_bf16, None
    else:
        score, scales = index.dataset, None
    if eng in ("edge", "fused") and index.edge_store is None:
        prepare_traversal(index)
    st = index.edge_store
    mt = index.metric
    metric_s = "ip" if mt is DistanceType.InnerProduct else "l2"
    degree = index.graph_degree
    kprime = min(degree, itopk)

    buf_d, buf_i = _seed_buffer(index, score, scales, q, mask, n_seeds,
                                itopk, p.seed)
    pen = None
    if eng in ("edge", "fused") and mask is not None:
        # the filter as an edge-major penalty: +inf on filtered edges
        pen = torch.zeros((index.size, st.deg_p), dtype=torch.float32,
                          device=dev)
        pen[:, :degree] = torch.where(mask, 0.0, _INF)[index.graph.long()]
    if eng == "fused":
        buf_d, buf_i = fused_traverse(
            q, buf_d, buf_i, st.vecs, st.aux, st.gp, pen, itopk=itopk,
            width=width, max_iter=max_iter, kprime=kprime, degree=degree,
            metric=metric_s)
    else:
        explored = torch.zeros(buf_d.shape, dtype=torch.bool, device=dev)
        for it in range(max_iter):
            # one host read per hop: stop once no finite entry is left
            # unexplored (min_iterations hops at least)
            if it >= p.min_iterations and not bool(
                    (~explored & torch.isfinite(buf_d)).any()):
                break
            if eng == "edge":
                buf_d, buf_i, explored = edge_hop(
                    q, buf_d, buf_i, explored, st.vecs, st.aux, st.gp, pen,
                    width=width, kprime=kprime, degree=degree,
                    metric=metric_s)
            else:
                buf_d, buf_i, explored = _gather_hop(
                    index, score, scales, q, mask, buf_d, buf_i, explored,
                    width)

    # exact float32 re-score and re-rank of the returned k
    out_i = buf_i[:, :k]
    exact = _query_dists(q, index.dataset[out_i.clamp_min(0).long()], mt)
    exact = torch.where(torch.isfinite(buf_d[:, :k]), exact, _INF)
    out_d, order = select_k(exact.contiguous(), k)
    out_i = torch.gather(out_i, 1, order.long())
    if mt is DistanceType.L2SqrtExpanded:
        out_d = torch.sqrt(torch.clamp_min(out_d, 0.0))
    elif mt is DistanceType.InnerProduct:
        out_d = torch.where(torch.isfinite(out_d), -out_d, -_INF)
    found = (out_d > -_INF if mt is DistanceType.InnerProduct
             else torch.isfinite(out_d))
    return out_d, torch.where(found, out_i, -1)
