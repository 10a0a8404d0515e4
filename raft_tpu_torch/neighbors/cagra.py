"""CAGRA graph-based ANN: counterpart of ``raft_tpu/neighbors/cagra.py``
(``BuildAlgo``, ``IndexParams``, ``SearchParams``, ``Index``, ``ENGINES``,
``build_knn_graph``, ``optimize``, ``build``, ``build_covering_seeds``,
``prepare_search``, ``prepare_traversal``, ``search``, ``health``,
``make_searcher``, ``save``, ``load``).

Build: the all-points kNN graph (:func:`build_knn_graph`: the exact
graph by brute-force search through K2 + the K1 merge, batched
NN-descent, or the reference's IVF-PQ candidate pass + refine), the
detour-count prune plus reverse-edge merge of ``optimize`` (plain
PyTorch, bit-equal to the JAX package's), and the covering seed set
(nearest rows to fixed-iteration k-means centers). ``"auto"`` follows a
recorded verdict (``bench.runner.race_graph_build`` races the builders
at a shape and records one), else takes the exact graph up to
:data:`BRUTE_N` rows and NN-descent above. ``BuildAlgo.NN_DESCENT``
runs NN-descent whatever ``knn_graph_algo`` says. A builder's failure
raises: there is no guarded fallback to another builder.

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
* ``"auto"`` — the verdict :func:`tune_search` recorded for the
  shape; without one, ``"edge"`` on CUDA when a store is attached, else
  ``"gather"`` (the JAX package's store rule).

Every selection (the buffer, the parent pick, the merges, the final
re-rank) goes through ``select_k`` — K1 on CUDA. A filtered search
follows ``ops/filter_policy``: ``itopk`` widened by the filter's
selectivity (x2 below 0.5, x4 below 0.1, x8 below 0.01), or, where few
rows survive, the survivors searched exactly by brute force (the
crossover); a widened plan past K6's ``itopk`` runs the edge engine
where the fused one was asked for or chosen. Inside
``filter_policy.suspended()`` the filter is only the survivor-aware
seeding and the edge penalty. The edge store comes at int8,
bf16, int4 (split-half nibbles) or pq (PQ codes and their codebook): the
edge engine serves all four, the fused engine all but pq (K6 has no pq
form, nor has the JAX kernel; an explicit fused search on a pq store
raises, where JAX rewrites it to its edge engine). ``query_chunk`` and a
deadline (``res``) traverse the queries in chunks, each with its own
random seed rows; :func:`health` reports connectivity and quantization
error; :func:`make_searcher` freezes a search's options. Not ported: the
guarded fallback chains (a kernel failure raises) and
``make_searcher``'s ``donate=True``. ``save`` / ``load``
read and write the JAX package's files (dataset, graph, seed set); the
traversal copies, the edge store and ``build_stats`` are derived and
rebuilt on first use. The TPU-only build
paths (``_parted_brute_graph``'s compile cap, the tail-wrapping batch
loop) have no counterpart. Every matrix product runs in full float32
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
from ..core.errors import RaftError, expects
from ..core.serialize import device_tensor, load_arrays, save_arrays
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..ops import autotune, filter_policy
from ..ops import nn_descent as nnd
from ..ops.cagra_fused import (dup_mask, edge_hop, fused_capable,
                               fused_traverse, merge_candidates,
                               pick_parents)
from ..ops import quant
from ..ops.quant import quantize_rows
from ..utils import (query_chunks, resolve_device, round_up_to,
                     run_query_chunks)
from . import brute_force, ivf_pq, refine
from .ivf_pq import _kmeans_fixed

__all__ = ["BuildAlgo", "IndexParams", "SearchParams", "Index", "EdgeStore",
           "ENGINES", "BRUTE_N", "PASS_BUDGET", "DEADLINE_CHUNK",
           "pass_batch", "build", "build_knn_graph", "optimize",
           "build_covering_seeds", "prepare_search", "prepare_traversal",
           "search", "tune_search", "resolve_engine", "health",
           "make_searcher", "save", "load"]

ENGINES = ("gather", "edge", "fused")
# knn_graph_algo="auto": the exact graph up to this many rows, NN-descent
# above (the JAX package's default crossover)
BRUTE_N = 200_000
# the IVF-PQ graph pass's per-pair candidates (batch x probes x (2k + 1)
# values and rows, 8 bytes a key) stay within this many bytes: its batch
# shrinks as k grows (32,768 rows at the defaults' k = 2·128 + 1)
PASS_BUDGET = 9 << 29
# a search under a deadline with no query_chunk traverses this many
# queries a chunk (the JAX package's)
DEADLINE_CHUNK = 1024
_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.InnerProduct)
# the file version save writes with a seed set (1 without); load reads both
_SERIAL_VERSION = 2
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
    that, 0 → none. ``nn_descent_niter``: NN-descent's round cap (the
    update-rate stop usually comes first). ``knn_graph_algo``: the graph
    builder of :func:`build_knn_graph` under ``BuildAlgo.IVF_PQ``."""

    intermediate_graph_degree: int = 128
    graph_degree: int = 64
    build_algo: BuildAlgo = BuildAlgo.IVF_PQ
    metric: DistanceType | str = DistanceType.L2Expanded
    nn_descent_niter: int = 20
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
    ``vecs`` (n, deg_p, W) — node i's neighbors' coded vectors (int8 or
    bf16 rows, W = dim_p; int4 split-half nibbles, W = dim_p / 2; pq
    uint8 codes, W = pq_dim), ``aux`` (n, 2, deg_p) float32 — [per-edge
    scales, dequantized norms], ``gp`` (n, deg_p) int32 — the graph rows,
    zero-padded; for pq ``cb`` the compact codebook (pq_dim, book,
    pq_len), int8 with ``cb_scale`` (pq_dim,) float32 or float32 (no
    scales). ``dim_p`` is the scored width, dim rounded up to 128."""

    mode: str            # "int8" | "bfloat16" | "int4" | "pq"
    degree: int
    deg_p: int
    dim_p: int
    vecs: torch.Tensor
    aux: torch.Tensor
    gp: torch.Tensor
    cb: Optional[torch.Tensor] = None
    cb_scale: Optional[torch.Tensor] = None

    @property
    def kernel_mode(self) -> str:
        """The kernels' store mode: "dense" (int8, bf16), "int4", "pq"."""
        return self.mode if self.mode in ("int4", "pq") else "dense"

    @property
    def nbytes(self) -> int:
        """Device bytes of the store: codes, aux, graph rows, codebook."""
        return sum(t.numel() * t.element_size() for t in
                   (self.vecs, self.aux, self.gp, self.cb, self.cb_scale)
                   if t is not None)


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
    # health()'s connectivity report, kept with the (graph, seed_nodes)
    # identities it was computed for
    health_conn: Optional[tuple] = dataclasses.field(default=None,
                                                     repr=False)

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


def _graph_algo_key(n: int, dim: int, k: int, mt: DistanceType,
                    device) -> str:
    """Verdict key of the graph-builder race for this shape class; the
    metric is a tag, so a verdict for one metric never steers another."""
    return autotune.shape_bucket("cagra_knn_graph", device, m=mt.name, n=n,
                                 d=dim, k=k)


def _resolve_graph_algo(n: int, dim: int, k: int, algo: str,
                        mt: DistanceType, device) -> str:
    """The builder ``algo="auto"`` stands for: a recorded verdict for the
    shape class, else the exact graph up to :data:`BRUTE_N` rows, then
    NN-descent where it serves the metric, else the IVF-PQ pass."""
    if algo != "auto":
        return algo
    hit = autotune.lookup(_graph_algo_key(n, dim, k, mt, device))
    if hit in ("brute", "ivf_pq", "nn_descent") and (
            hit != "nn_descent" or nnd.supports(mt)):
        return hit
    if n <= BRUTE_N:
        return "brute"
    return "nn_descent" if nnd.supports(mt) else "ivf_pq"


def pass_batch(batch: int, n_probes: int, gpu_k: int) -> int:
    """The IVF-PQ graph pass's rows a batch: ``batch``, or fewer (a
    multiple of 1,024, at least 1,024) so that the scan's per-pair
    candidates, ``batch x n_probes x gpu_k`` values and rows of 8 bytes,
    stay within :data:`PASS_BUDGET`. Batching does not change the
    graph."""
    fit = PASS_BUDGET // (8 * n_probes * gpu_k)
    return min(batch, max(1024, fit // 1024 * 1024))


def build_knn_graph(dataset, k: int, metric=DistanceType.L2Expanded,
                    seed: int = 0, batch: int = 32768, algo: str = "auto",
                    nnd_rounds: int = nnd.ROUNDS, init_graph=None,
                    info: Optional[dict] = None, device=None
                    ) -> torch.Tensor:
    """All-points kNN graph (cagra_build.cuh:43) → (n, k) int32 neighbor
    ids on the device, self-edges removed. ``algo``:

    * ``"brute"`` — exact: brute-force search (K2 + K1 on CUDA),
      ``batch`` query rows at a time;
    * ``"nn_descent"`` — batched NN-descent (``ops.nn_descent``), at most
      ``nnd_rounds`` rounds, from ``init_graph`` when given, each joined
      node offering a fresh sample of its list and its reverse sample
      (the descent's default ``exposure="sampled"``; the JAX package's
      route offers its closest neighbors, which on 128-dim Gaussian
      clusters at 1M rows stalls at ~0.5 edge recall); approximate by
      design;
    * ``"ivf_pq"`` — the reference's pass: an IVF-PQ index (4-bit codes,
      pq_dim = min(dim, 4 x the default), 2·√n lists in [16, 1024])
      searched for 2k + 1 candidates a row (int8 LUT), refined exactly
      to k + 1 on a bf16 copy of the rows; ``batch`` shrinks (by 1,024
      rows) so that the scan's per-pair candidates stay within
      :data:`PASS_BUDGET`;
    * ``"auto"`` — see :func:`_resolve_graph_algo`.

    ``info``: a dict to which the builder that ran is written
    (``info["algo"]``; NN-descent adds its rounds and last update
    rate)."""
    dev = resolve_device(device)
    x = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    n, dim = x.shape
    mt = canonical_metric(metric)
    expects(algo in ("auto", "brute", "ivf_pq", "nn_descent"),
            "unknown knn_graph algo %r", algo)
    algo = _resolve_graph_algo(n, dim, k, algo, mt, dev)
    info = {} if info is None else info
    info["algo"] = algo
    if algo == "nn_descent":
        def progress(r, _rounds, rate, _s):
            info.update(nnd_rounds=r, nnd_update_rate=rate)

        return nnd.build_graph(x, k, mt, rounds=nnd_rounds, seed=seed,
                               init_graph=init_graph, progress=progress,
                               device=dev)
    graph = torch.empty((n, k), dtype=torch.int32, device=dev)
    if algo == "brute":
        index = brute_force.build(x, mt, device=dev)
        kq = min(n, k + 1)

        def step(rows):
            return brute_force.search(index, x[rows], kq)[1]
    else:
        n_lists = max(16, min(1024, int(np.sqrt(n) * 2)))
        pq_dim = min(dim, 4 * ivf_pq._default_pq_dim(dim))
        pq_index = ivf_pq.build(x, ivf_pq.IndexParams(
            n_lists=n_lists, pq_dim=pq_dim, pq_bits=4, metric=mt,
            seed=seed), device=dev)
        # candidate recall, not search recall, is the bar here: refine
        # and optimize()'s pruning absorb imperfect candidates
        sp = ivf_pq.SearchParams(max(16, min(64, n_lists // 8)),
                                 lut_dtype="int8")
        gpu_k = min(n, 2 * k + 1)   # refine rate 2, room for the self match
        x_bf16 = x.to(torch.bfloat16)
        batch = pass_batch(batch, sp.n_probes, gpu_k)

        def step(rows):
            qb = x[rows]
            _, cand = ivf_pq.search(pq_index, qb, gpu_k, sp)
            return refine.refine(x_bf16, qb, cand, k + 1, mt, device=dev)[1]
    for b0 in range(0, n, batch):
        rows = torch.arange(b0, min(b0 + batch, n), device=dev)
        graph[b0:b0 + batch] = _drop_self_pad(step(rows).long(), rows, k, n)
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
    graph builder that ran (``knn_algo``), the stage seconds
    (``knn_graph_s``, ``optimize_s``, ``seeds_s``) and, after
    NN-descent, its rounds and last update rate (``nnd_rounds``,
    ``nnd_update_rate``)."""
    p = params or IndexParams()
    dev = resolve_device(device)
    x = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    expects(x.dim() == 2, "dataset must be (n, d)")
    x = x.contiguous()
    n = x.shape[0]
    mt = canonical_metric(p.metric)
    expects(mt in _METRICS, "cagra supports L2/IP metrics, got %s", mt.name)
    d0 = min(p.intermediate_graph_degree, n - 1)
    degree = min(p.graph_degree, d0)
    algo = ("nn_descent" if p.build_algo is BuildAlgo.NN_DESCENT
            else p.knn_graph_algo)
    ginfo = {}
    _sync(dev)
    t0 = time.perf_counter()
    knn = build_knn_graph(x, d0, mt, p.seed, algo=algo,
                          nnd_rounds=p.nn_descent_niter, info=ginfo,
                          device=dev)
    _sync(dev)
    t1 = time.perf_counter()
    graph = optimize(knn, degree)
    _sync(dev)
    t2 = time.perf_counter()
    seeds = build_covering_seeds(x, p)
    _sync(dev)
    t3 = time.perf_counter()
    index = Index(x, graph, mt, seeds)
    index.build_stats = {"n": n, "knn_algo": ginfo["algo"],
                         "knn_graph_s": t1 - t0, "optimize_s": t2 - t1,
                         "seeds_s": t3 - t2,
                         **{k: v for k, v in ginfo.items()
                            if k.startswith("nnd_")}}
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


_STORE_NAMES = {"int8": "int8", "i8": "int8", "bfloat16": "bfloat16",
                "bf16": "bfloat16", "int4": "int4", "i4": "int4",
                "pq": "pq"}


def prepare_traversal(index: Index, candidate_dtype: str = "int8",
                      pq_dim: int = 0, pq_lut: str = "int8") -> None:
    """Build the edge store (:class:`EdgeStore`) and attach it: for every
    node, its ``degree`` neighbors' coded vectors as one contiguous
    (deg_p, W) tile, deg_p = degree rounded up to 32 (zero-padded). The
    stores (W at d = 128):

    * ``"int8"`` (the default) — the int8 traversal copy's codes, per-row
      scales; W = dim_p = dim rounded up to 128 (zero-padded);
    * ``"bfloat16"`` — the bf16 rows, W = dim_p;
    * ``"int4"`` — split-half nibbles (``ops.quant.quantize_int4``, per-row
      scales amax/7), W = half_p = dim_p / 2;
    * ``"pq"`` — uint8 PQ codes of whole rows, W = ``pq_dim`` (default
      ``ops.quant.default_pq_dim``: 16 at d = 128), with the compact
      codebook in ``pq_lut`` precision: "int8" (per-subspace absmax/127,
      JAX's int8 decode table) or "f32". The norms are the float32
      codebook's decoded norms in either case, as JAX's are.

    A second call with the same store and geometry (and, for pq, the same
    pq_dim and LUT) does nothing."""
    expects(candidate_dtype in _STORE_NAMES,
            "edge store dtype must be int8/bfloat16/int4/pq, got %r",
            candidate_dtype)
    expects(pq_lut in ("int8", "f32"),
            "pq_lut must be 'int8' or 'f32', got %r", pq_lut)
    mode = _STORE_NAMES[candidate_dtype]
    n, dim = index.size, index.dim
    degree = index.graph_degree
    deg_p, dim_p = round_up_to(degree, 32), round_up_to(dim, 128)
    pqd = (pq_dim or quant.default_pq_dim(dim)) if mode == "pq" else 0
    lut_i8 = pq_lut == "int8"
    cur = index.edge_store
    if cur is not None and (cur.mode, cur.degree, cur.deg_p, cur.dim_p) == (
            mode, degree, deg_p, dim_p) and (mode != "pq" or (
                cur.vecs.shape[2] == pqd
                and (cur.cb.dtype == torch.int8) == lut_i8)):
        return
    index.edge_store = cur = None   # a store is never held beside another
    g = index.graph.long()
    cb = cb_scale = None
    if mode == "int8":
        prepare_search(index, mode)
        stored, scales = index.score_i8
        norms = (scales * scales) * stored.to(torch.float32).square().sum(1)
        es = scales[g]
    elif mode == "bfloat16":
        prepare_search(index, mode)
        stored = index.score_bf16
        norms = stored.to(torch.float32).square().sum(1)
        es = torch.ones(g.shape, dtype=torch.float32, device=index.device)
    elif mode == "int4":
        stored, scales = quant.quantize_int4(index.dataset)
        low, high = quant.int4_nibbles(stored)
        norms = (scales * scales) * (low * low + high * high).sum(1)
        del low, high
        es = scales[g]
    else:
        expects(dim_p % pqd == 0, "pq_dim %d must divide the padded dim %d",
                pqd, dim_p)
        books = quant.train_pq_rows(index.dataset, pqd)
        stored = quant.encode_pq_rows(index.dataset, books)   # (n, pqd) u8
        norms = quant.pq_decoded_norms(stored, books)
        es = torch.ones(g.shape, dtype=torch.float32, device=index.device)
        if lut_i8:
            cb, cb_scale = quant.pq_int8_books(books)
        else:
            cb = books.contiguous()
    w = dim_p if mode in ("int8", "bfloat16") else stored.shape[1]
    if (deg_p, w) == (degree, stored.shape[1]):
        vecs = stored[g]
    else:
        # fill in row chunks: stored[g] whole and then a padded copy would
        # hold the store twice
        vecs = torch.zeros((n, deg_p, w), dtype=stored.dtype,
                           device=index.device)
        width = stored.shape[1]
        step = max(1, (256 << 20) // max(degree * width * stored.itemsize,
                                         1))
        for r0 in range(0, n, step):
            vecs[r0:r0 + step, :degree, :width] = stored[g[r0:r0 + step]]
    aux = torch.zeros((n, 2, deg_p), dtype=torch.float32,
                      device=index.device)
    aux[:, 0, :degree] = es
    aux[:, 1, :degree] = norms[g]
    gp = torch.zeros((n, deg_p), dtype=torch.int32, device=index.device)
    gp[:, :degree] = index.graph
    index.edge_store = EdgeStore(mode, degree, deg_p, dim_p,
                                 vecs.contiguous(), aux, gp, cb, cb_scale)


def _plan_dims(p: SearchParams, k: int) -> Tuple[int, int, int]:
    """(itopk, width, max_iter) of the traversal plan."""
    itopk = max(p.itopk_size, k)
    width = max(1, p.search_width)
    max_iter = p.max_iterations or (itopk // width + 16)
    return itopk, width, max(int(max_iter), int(p.min_iterations))


def _tune_key(index: Index, m: int, k: int, p: SearchParams,
              store: Optional[EdgeStore]) -> str:
    """Verdict key of the engine race: the shape class and the storage the
    engines read (the edge store's mode, else the gather engine's
    candidate dtype), since the crossovers move with the element
    width."""
    sd = store.mode if store is not None else str(p.candidate_dtype)
    return autotune.shape_bucket(
        "cagra_search", index.device, n=index.size, m=m, d=index.dim, k=k,
        deg=index.graph_degree, itopk=max(p.itopk_size, k),
        w=max(1, p.search_width), store=sd)


def resolve_engine(index: Index, m: int, k: int,
                   params: SearchParams | None = None) -> str:
    """The engine ``engine="auto"`` runs for ``m`` queries at ``k``: the
    verdict :func:`tune_search` recorded for the shape (a store-backed
    one only while the store is attached); without one, the JAX
    package's store rule — ``"edge"`` on CUDA when an edge store is
    attached, else ``"gather"``. A ``"fused"`` verdict whose plan K6
    cannot serve gives ``"edge"``."""
    p = params or SearchParams()
    store = index.edge_store
    hit = autotune.lookup(_tune_key(index, m, k, p, store))
    if hit == "fused" and store is not None and not _fused_serves(
            index, p, k, store):
        return "edge"
    if hit == "gather" or (hit in ("edge", "fused") and store is not None):
        return hit
    return ("edge" if store is not None and index.device.type == "cuda"
            else "gather")


def _fused_serves(index: Index, p: SearchParams, k: int,
                  store: EdgeStore) -> bool:
    """Whether K6 serves the plan of ``p`` at ``k`` on ``store``
    (``ops.cagra_fused.fused_capable``)."""
    itopk, width, max_iter = _plan_dims(p, k)
    return fused_capable(itopk, width, min(index.graph_degree, itopk),
                         store.deg_p, store.dim_p, store.mode, max_iter,
                         index.device)


def tune_search(index: Index, queries, k: int,
                params: SearchParams | None = None, reps: int = 3,
                store_dtype: str = "int8", engines=None):
    """Race the traversal engines (every member of :data:`ENGINES`, or
    ``engines``) on ``queries`` and record the fastest for the shape
    class, which ``engine="auto"`` then runs (:func:`resolve_engine`).
    The edge store (``store_dtype``) is attached for the race and dropped
    again when ``"gather"`` wins, the verdict then also recorded under
    the storeless key. The fused engine sits the race out where
    ``ops.cagra_fused.fused_capable`` says K6 cannot serve the shape or
    the store (a pq store: K6 has no pq form, and JAX's race leaves it
    out too); a candidate that raises fails the race. Returns (winner,
    {engine: median seconds})."""
    p = params or SearchParams()
    q = torch.as_tensor(queries).to(device=index.device,
                                    dtype=torch.float32).contiguous()
    prepare_traversal(index, store_dtype)
    prepare_search(index, p.candidate_dtype)
    st = index.edge_store
    key = _tune_key(index, q.shape[0], k, p, st)
    cands = {e: (lambda qq, e=e: search(index, qq, k, p, engine=e))
             for e in (engines or ENGINES)
             if e != "fused" or _fused_serves(index, p, k, st)}
    winner, timings = autotune.tune_best(key, cands, q, reps=reps,
                                         force=True)
    if winner not in ("edge", "fused"):
        index.edge_store = None
        autotune.record(_tune_key(index, q.shape[0], k, p, None), winner)
    return winner, timings


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


def _chunk_seed(seed: int, s0: int) -> int:
    """The random seed rows' generator seed of the query chunk that starts
    at row ``s0``: each chunk draws its own rows (the JAX package folds
    the chunk's start into its key), so chunks do not share seeds."""
    return int(np.random.SeedSequence([seed, s0]).generate_state(1)[0])


def search(index: Index, queries, k: int,
           params: SearchParams | None = None,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           engine: Optional[str] = None, res=None, query_chunk: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched-frontier graph traversal (search_single_cta) → (distances
    (m, k), int32 ids (m, k)) on the index's device; -1 ids (+inf, or
    -inf for inner product) where fewer than k were found.

    ``filter``: optional sample bitset, cleared bits excluded; outside
    ``filter_policy.suspended()`` it widens ``itopk`` or crosses over to
    an exact search of the survivors (module docstring). ``engine``
    overrides ``SearchParams.engine``: "gather", "edge" (K5 per hop),
    "fused" (K6) or "auto"; "edge" and "fused" build the int8 edge store
    first when none is attached. "fused" on a pq store raises: K6 has no
    pq form, and ``engine="edge"`` serves the store. ``query_chunk``:
    traverse the queries in chunks of this many rows; ``res``: a
    ``core.deadline.Deadline`` (or an object carrying one): chunks of
    ``query_chunk``, else :data:`DEADLINE_CHUNK` rows, with a checkpoint
    before each, which raises ``DeadlineExceeded`` with the finished
    chunks' results once the budget is spent. The engine is resolved
    once, for the whole batch. Each chunk draws its own random seed rows
    (:func:`_chunk_seed`), so a chunked search equals the unchunked one
    only when it runs unchunked (a chunk of the whole batch and no
    deadline)."""
    p = params or SearchParams()
    dev = index.device
    q = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "bad query shape %s", tuple(q.shape))
    q = q.contiguous()
    itopk, width, max_iter = _plan_dims(p, k)
    widened = False
    if filter is not None and not filter_policy.adaptive_off():
        fd = filter_policy.decide_graph(filter, index.size, index.dim, k,
                                        "cagra", dev)
        if fd.use_brute:
            filter_policy.note_crossover(fd, "cagra")
            return filter_policy.survivor_brute_dense(
                index.dataset, index.metric, q, k, filter,
                query_chunk=query_chunk, res=res)
        if fd.level > 1:
            p = dataclasses.replace(p, itopk_size=min(
                max(p.itopk_size, k) * fd.level, max(index.size, k)))
            itopk, width, max_iter = _plan_dims(p, k)
            widened = True
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
        eng = resolve_engine(index, q.shape[0], k, p)
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
    if eng == "fused" and widened and not _fused_serves(index, p, k, st):
        eng = "edge"      # the widened itopk is past K6's
    expects(eng != "fused" or st.mode != "pq",
            "the fused engine (K6) has no pq form, as the JAX kernel has "
            "none; search a pq edge store with engine='edge'")
    mt = index.metric
    metric_s = "ip" if mt is DistanceType.InnerProduct else "l2"
    degree = index.graph_degree
    kprime = min(degree, itopk)
    pen = None
    if eng in ("edge", "fused") and mask is not None:
        # the filter as an edge-major penalty: +inf on filtered edges
        pen = torch.zeros((index.size, st.deg_p), dtype=torch.float32,
                          device=dev)
        pen[:, :degree] = torch.where(mask, 0.0, _INF)[index.graph.long()]

    def run(qc: torch.Tensor, seed: int):
        buf_d, buf_i = _seed_buffer(index, score, scales, qc, mask, n_seeds,
                                    itopk, seed)
        if eng == "fused":
            buf_d, buf_i = fused_traverse(
                qc, buf_d, buf_i, st.vecs, st.aux, st.gp, pen, itopk=itopk,
                width=width, max_iter=max_iter, kprime=kprime,
                degree=degree, metric=metric_s, mode=st.kernel_mode)
        else:
            explored = torch.zeros(buf_d.shape, dtype=torch.bool,
                                   device=dev)
            for it in range(max_iter):
                # one host read per hop: stop once no finite entry is left
                # unexplored (min_iterations hops at least)
                if it >= p.min_iterations and not bool(
                        (~explored & torch.isfinite(buf_d)).any()):
                    break
                if eng == "edge":
                    buf_d, buf_i, explored = edge_hop(
                        qc, buf_d, buf_i, explored, st.vecs, st.aux, st.gp,
                        pen, width=width, kprime=kprime, degree=degree,
                        metric=metric_s, mode=st.kernel_mode, cb=st.cb,
                        cb_scale=st.cb_scale)
                else:
                    buf_d, buf_i, explored = _gather_hop(
                        index, score, scales, qc, mask, buf_d, buf_i,
                        explored, width)

        # exact float32 re-score and re-rank of the returned k
        out_i = buf_i[:, :k]
        exact = _query_dists(qc, index.dataset[out_i.clamp_min(0).long()],
                             mt)
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

    chunk = query_chunks(q.shape[0], query_chunk, res, DEADLINE_CHUNK)
    if chunk:
        return run_query_chunks(
            lambda qc, s0: run(qc, _chunk_seed(p.seed, s0)), q, chunk, res)
    return run(q, p.seed)


def health(index: Index, sample: int = 256) -> dict:
    """Index health report, as the JAX package's: the graph's
    connectivity and the measured quantization error of each traversal
    copy the index holds.

    Connectivity: the in-degree statistics (min, mean, p99, max), the
    nodes no edge points at (``unreachable_nodes``: only seeding can
    reach them) and those of them outside the covering seed set
    (``unseeded_unreachable``: only random seeding can), computed once
    and kept on the index for its graph and seed set. Quantization: the
    sampled error (``brute_force.quantization_error``) of the int8 and
    bf16 copies, and the edge store's mode, shape and bytes of codes. An
    empty index reports zeros."""
    key = (id(index.graph), id(index.seed_nodes))
    cached = index.health_conn
    if cached is not None and cached[0] == key:
        conn = cached[1]
    elif index.size == 0:
        conn = {"graph_degree": int(index.graph.shape[1]),
                "in_degree": {"min": 0, "mean": 0.0, "p99": 0, "max": 0},
                "unreachable_nodes": 0, "unreachable_frac": 0.0,
                "unseeded_unreachable": 0, "seed_nodes": 0}
    else:
        n = index.size
        flat = index.graph.reshape(-1).long()
        indeg_t = torch.bincount(flat[(flat >= 0) & (flat < n)],
                                 minlength=n)
        unreachable_t = indeg_t == 0
        unseeded_t = unreachable_t.clone()
        seeds = index.seed_nodes
        if seeds is not None and seeds.numel():
            sl = seeds.long()
            unseeded_t[sl[(sl >= 0) & (sl < n)]] = False
        indeg = indeg_t.cpu().numpy()
        unreachable = int(unreachable_t.sum())
        conn = {
            "graph_degree": int(index.graph_degree),
            "in_degree": {
                "min": int(indeg.min()),
                "mean": round(float(indeg.mean()), 2),
                "p99": int(np.percentile(indeg, 99)),
                "max": int(indeg.max())},
            "unreachable_nodes": unreachable,
            "unreachable_frac": round(unreachable / n, 5),
            "unseeded_unreachable": int(unseeded_t.sum()),
            "seed_nodes": 0 if seeds is None else int(seeds.shape[0]),
        }
    index.health_conn = (key, conn)
    report = {"family": "cagra", "n": int(index.size),
              "dim": int(index.dim), "metric": index.metric.name, **conn}
    rows = torch.as_tensor(brute_force.health_sample_rows(index.size,
                                                          sample),
                           device=index.device)
    quant_err = {}
    if rows.numel():
        orig = index.dataset[rows]
        if index.score_i8 is not None:
            q8, sc = index.score_i8
            quant_err["int8"] = brute_force.quantization_error(
                orig, q8[rows].to(torch.float32) * sc[rows][:, None])
        if index.score_bf16 is not None:
            quant_err["bfloat16"] = brute_force.quantization_error(
                orig, index.score_bf16[rows])
    st = index.edge_store
    if st is not None:
        quant_err["edge_store"] = {
            "dtype": st.mode, "shape": tuple(int(d) for d in st.vecs.shape),
            "bytes": st.vecs.numel() * st.vecs.element_size()}
    if quant_err:
        report["quant"] = quant_err
    return report


def make_searcher(index: Index, params: SearchParams | None = None, *,
                  degrade=None, donate=False, **opts):
    """``fn(queries, k, res=None) -> (distances, indices)`` with the
    search parameters and ``opts`` (``filter``, ``query_chunk``,
    ``engine``) frozen: the serving signature the four families share.
    Pinning ``engine="edge"`` or ``"fused"`` (in ``opts`` or
    ``params.engine``) builds the int8 edge store now, not on the first
    request. ``degrade``: a
    :class:`~raft_tpu_torch.serve.degrade.BrownoutController` whose
    current level overrides ``itopk_size`` / ``search_width`` on every
    call (``degrade.params(base)``). ``donate=True`` raises: it is JAX's
    buffer donation to ``jax.jit``, which an eager search has nothing to
    match (``False`` and ``"auto"``, which donates only on a TPU, donate
    nothing)."""
    if donate not in (False, "auto"):
        raise RaftError("make_searcher(donate=True) is not ported: it is "
                        "jax.jit buffer donation, which an eager search "
                        "has no counterpart of")
    base = params or SearchParams()
    if (opts.get("engine") or base.engine) in ("edge", "fused"):
        prepare_traversal(index)

    def _fn(queries, k, res=None):
        p = base if degrade is None else degrade.params(base)
        return search(index, queries, k, p, res=res, **opts)

    return _fn


def save(index: Index, path) -> None:
    """Write the index in the JAX package's file format (kind "cagra"):
    meta ``metric``; arrays ``dataset``, ``graph`` and, where the index
    has a covering seed set, ``seed_nodes`` — version 2 with seeds, 1
    without. The traversal copies, edge store and build stats are not
    written. Byte-equal to the JAX package's file of the same index."""
    arrays = {"dataset": index.dataset, "graph": index.graph}
    version = 1
    if index.seed_nodes is not None:
        arrays["seed_nodes"] = index.seed_nodes
        version = _SERIAL_VERSION
    save_arrays(path, "cagra", version, {"metric": index.metric.value},
                arrays)


def load(path, device=None) -> Index:
    """Read a CAGRA file of either package (version 1 or 2) onto
    ``device`` (the CUDA card by default); the seed set comes back sorted
    and unique, as int32."""
    _, version, meta, arrs = load_arrays(path, "cagra")
    expects(version in (1, _SERIAL_VERSION), "unsupported version %d",
            version)
    mt = DistanceType(meta["metric"])
    expects(mt in _METRICS, "cagra with metric %s is not ported yet",
            mt.name)
    dev = resolve_device(device)
    seeds = arrs.get("seed_nodes")
    if seeds is not None:
        seeds = device_tensor(np.unique(seeds).astype(np.int32), dev)
    return Index(device_tensor(arrs["dataset"], dev),
                 device_tensor(np.asarray(arrs["graph"], np.int32), dev),
                 mt, seeds)
