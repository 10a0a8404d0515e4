"""Parameter-sweep benchmark runner emitting Google-Benchmark JSON:
counterpart of ``raft_tpu/bench/runner.py``
(cpp/bench/ann/src/common/benchmark.hpp:320-371: per-case Recall,
Latency, QPS as ``items_per_second``, end_to_end; sweeps from the
raft-ann-bench configs).

The schema is the JAX package's, so the reference's export and plot
tooling applies. ``dtype`` stores brute force and IVF-Flat in a
low-precision rung (bfloat16, int8, uint8; int4 for brute force only) and
tags their results' names with it; uint8 on a float corpus maps base and
queries onto the byte grid first (:func:`byte_grid`), as the JAX harness
does. A CAGRA case first races the kNN-graph builders on the corpus
(:func:`race_graph_build`, untimed, as the engine race is) and builds
with ``knn_graph_algo="auto"``, which follows the race's verdict; then it
races the traversal engines (``cagra.tune_search``) on the benchmark's
queries at each itopk point before it is timed, so ``engine="auto"``
runs the measured winner. The case's entry adds the builder
(``graph_algo``), each builder's seconds and edge recall
(``race_<builder>_s``, ``edge_recall_<builder>``), the engine that ran
(``engine``) and the engine race's median times (``race_<engine>_ms``).
"""
from __future__ import annotations

import dataclasses
import json
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.errors import expects
from ..utils import resolve_device

__all__ = ["BenchResult", "DTYPES", "default_configs", "byte_grid",
           "race_graph_build", "graph_race_winner", "run_benchmarks",
           "to_gbench_json"]

# the stores --dtype takes; int4 for brute force only (IVF-Flat has none)
DTYPES = ("float32", "bfloat16", "int8", "uint8", "int4")
_DTYPE_ALGOS = ("raft_brute_force", "raft_ivf_flat")
# the graph race's untimed first run of each builder, on this many rows
RACE_WARM_ROWS = 2048


@dataclasses.dataclass
class BenchResult:
    name: str                      # e.g. "raft_ivf_flat.nlist1024.n_probes20"
    algo: str
    build_time: float
    search_params: Dict[str, Any]
    qps: float
    latency_s: float
    recall: float
    k: int
    batch_size: int
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_gbench(self) -> Dict[str, Any]:
        """One Google-Benchmark ``benchmarks[]`` entry (benchmark.hpp:337),
        then the case's extra keys."""
        return {
            "name": f"{self.name}/search",
            "run_type": "iteration",
            "real_time": self.latency_s,
            "time_unit": "s",
            "items_per_second": self.qps,
            "Recall": self.recall,
            "Latency": self.latency_s,
            "end_to_end": self.latency_s,
            "k": self.k,
            "n_queries": self.batch_size,
            "GPU": 0.0,
            "build_time": self.build_time,
            **self.extra,
        }


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bf_case(base, metric, dev, dtype="float32"):
    from ..neighbors import brute_force

    def build():
        return brute_force.build(base, metric, dtype=dtype, device=dev)

    def make_search(index, q, k):
        return (lambda qq: brute_force.search(index, qq, k)), {}

    return build, make_search, [{}], None


def _ivf_flat_case(base, metric, n_lists, probe_sweep, dev,
                   dtype="float32"):
    from ..neighbors import ivf_flat

    def build():
        return ivf_flat.build(base, ivf_flat.IndexParams(
            n_lists=n_lists, metric=metric, dtype=dtype), device=dev)

    def make_search(index, q, k, n_probes=20):
        sp = ivf_flat.SearchParams(n_probes=n_probes)
        return (lambda qq: ivf_flat.search(index, qq, k, sp)), {}

    return build, make_search, [{"n_probes": p} for p in probe_sweep], None


def _ivf_pq_case(base, metric, n_lists, pq_dim, probe_sweep, dev):
    from ..neighbors import ivf_pq

    def build():
        return ivf_pq.build(base, ivf_pq.IndexParams(
            n_lists=n_lists, pq_dim=pq_dim, metric=metric), device=dev)

    def make_search(index, q, k, n_probes=20):
        sp = ivf_pq.SearchParams(n_probes=n_probes)
        return (lambda qq: ivf_pq.search(index, qq, k, sp)), {}

    return build, make_search, [{"n_probes": p} for p in probe_sweep], None


def graph_race_winner(seconds: Dict[str, float],
                      recalls: Dict[str, float],
                      min_edge_recall: float = 0.9) -> str:
    """The graph-builder race's verdict: the fastest builder whose edge
    recall is at least ``min_edge_recall``; the exact graph
    (``"brute"``) always qualifies. Below the bar ``optimize`` and the
    exact re-rank no longer absorb a builder's missed edges (the JAX
    bench's graph lane's rule, ``bench.py:2072-2081``)."""
    ok = {b: t for b, t in seconds.items()
          if b == "brute" or recalls[b] >= min_edge_recall}
    expects(len(ok) > 0, "graph race: no builder qualifies (%s)", recalls)
    return min(ok, key=ok.get)


def _edge_recall(graph: torch.Tensor, exact: torch.Tensor,
                 rows: int = 1 << 16) -> float:
    """Share of the exact graph's edges that ``graph`` holds, over all
    rows (in chunks of ``rows``: the comparison is rows x k x k)."""
    hits = 0
    for r0 in range(0, exact.shape[0], rows):
        g, e = graph[r0:r0 + rows], exact[r0:r0 + rows]
        hits += int((g[:, :, None] == e[:, None, :]).any(dim=2).sum())
    return hits / exact.numel()


def race_graph_build(base, k: int, metric="sqeuclidean", device=None,
                     min_edge_recall: float = 0.9):
    """Race CAGRA's kNN-graph builders on ``base`` at degree ``k`` and
    record the verdict that ``knn_graph_algo="auto"`` follows for this
    shape class (``cagra._graph_algo_key`` of the build's own n, dim, k
    and metric). Each builder that serves the metric (``"brute"``,
    ``"ivf_pq"``, and ``"nn_descent"`` where ``ops.nn_descent.supports``
    it) builds the whole graph once through ``cagra.build_knn_graph``,
    the card synchronised around it; each approximate graph's edge
    recall is taken against the race's own exact graph over all rows.
    The winner is :func:`graph_race_winner`'s. First every builder runs
    once, untimed, on the first :data:`RACE_WARM_ROWS` rows, so that no
    timed build pays the kernels' lazy compile. → (winner, {builder: seconds},
    {builder: edge recall})."""
    from ..distance.distance_types import canonical_metric
    from ..neighbors import cagra
    from ..ops import autotune
    from ..ops import nn_descent as nnd

    dev = resolve_device(device)
    x = torch.as_tensor(base).to(device=dev, dtype=torch.float32)
    x = x.contiguous()
    n, dim = x.shape
    mt = canonical_metric(metric)
    expects(0 < k < n, "graph race: k=%d needs 0 < k < n=%d", k, n)
    builders = ["brute", "ivf_pq"] + (["nn_descent"] if nnd.supports(mt)
                                      else [])
    warm = x[:min(n, RACE_WARM_ROWS)]
    for b in builders:
        cagra.build_knn_graph(warm, min(k, warm.shape[0] - 1), mt, algo=b,
                              device=dev)
    seconds, graphs = {}, {}
    for b in builders:
        _sync(dev)
        t0 = time.perf_counter()
        graphs[b] = cagra.build_knn_graph(x, k, mt, algo=b, device=dev)
        _sync(dev)
        seconds[b] = time.perf_counter() - t0
    exact = graphs.pop("brute")
    recalls = {"brute": 1.0, **{b: _edge_recall(g, exact)
                                for b, g in graphs.items()}}
    winner = graph_race_winner(seconds, recalls, min_edge_recall)
    autotune.record(cagra._graph_algo_key(n, dim, k, mt, dev), winner)
    return winner, seconds, recalls


def _cagra_case(base, metric, graph_degree, itopk_sweep, dev):
    from ..neighbors import cagra

    d0 = min(graph_degree * 2, len(base) - 1)
    race = {}

    def prepare():
        from ..ops import autotune

        winner, secs, recalls = race_graph_build(base, d0, metric, dev)
        race.update(graph_algo=winner,
                    **{f"race_{b}_s": t for b, t in secs.items()},
                    **{f"edge_recall_{b}": r for b, r in recalls.items()})
        readings = ", ".join(f"{b} {t:.2f} s (edge recall {recalls[b]:.4f})"
                             for b, t in secs.items())
        return (f"graph race: {readings} -> {winner} (verdict recorded in "
                f"{autotune.cache_path() or 'this process only'})")

    def build():
        index = cagra.build(base, cagra.IndexParams(
            graph_degree=graph_degree,
            intermediate_graph_degree=graph_degree * 2, metric=metric),
            device=dev)
        expects(index.build_stats["knn_algo"] == race["graph_algo"],
                "cagra: the build ran %s, the graph race chose %s",
                index.build_stats["knn_algo"], race["graph_algo"])
        return index

    def make_search(index, q, k, itopk=64):
        sp = cagra.SearchParams(itopk_size=itopk)
        winner, times = cagra.tune_search(index, q, k, sp)
        engine = cagra.resolve_engine(index, q.shape[0], k, sp)
        expects(engine == winner, "cagra: auto resolves to %s, the race "
                "chose %s", engine, winner)
        extra = {**race, "engine": engine,
                 **{f"race_{e}_ms": t * 1e3 for e, t in times.items()}}
        return (lambda qq: cagra.search(index, qq, k, sp)), extra

    return (build, make_search, [{"itopk": t} for t in itopk_sweep],
            prepare)


def default_configs(base, metric, algos: Sequence[str],
                    n_lists: Optional[int] = None,
                    pq_dim: Optional[int] = None,
                    probe_sweep: Optional[Sequence[int]] = None,
                    cagra_degree: int = 32,
                    itopk_sweep: Optional[Sequence[int]] = None,
                    dtype: str = "float32", device=None):
    """The raft-ann-bench default tuning envelopes
    (docs/ann_benchmarks_param_tuning.md:10-96) scaled to the dataset:
    n_lists = 2·√n in [64, 4096], pq_dim = d / 2 rounded down to a
    multiple of 8, probes 1-100, CAGRA graph degree 32 (intermediate 64)
    and itopk 32-256; each one overridable. ``dtype``: the store of brute
    force and IVF-Flat (the other families ignore it), in their results'
    tags. → {algo: ((build, make_search, sweep, prepare), tag)};
    ``prepare`` (None, or CAGRA's graph race) runs before the timed
    build and returns a line for the log."""
    dev = resolve_device(device)
    expects(dtype in DTYPES, "bench dtype must be one of %s, got %r",
            DTYPES, dtype)
    expects(dtype != "int4" or "raft_ivf_flat" not in algos,
            "IVF-Flat has no int4 store (int4 is a brute-force store)")
    n = len(base)
    if n_lists is None:
        n_lists = max(64, min(4096, int(np.sqrt(n) * 2)))
    if pq_dim is None:
        pq_dim = max(8, (base.shape[1] // 2 // 8) * 8 or 8)
    if probe_sweep is None:
        probe_sweep = [1, 2, 5, 10, 20, 50, 100]
    if itopk_sweep is None:
        itopk_sweep = [32, 64, 128, 256]
    dtag = "" if dtype == "float32" else f".{dtype}"
    cases = {}
    for a in algos:
        if a == "raft_brute_force":
            cases[a] = (_bf_case(base, metric, dev, dtype), dtag.lstrip("."))
        elif a == "raft_ivf_flat":
            cases[a] = (_ivf_flat_case(base, metric, n_lists,
                                       list(probe_sweep), dev, dtype),
                        f"nlist{n_lists}{dtag}")
        elif a == "raft_ivf_pq":
            cases[a] = (_ivf_pq_case(base, metric, n_lists, pq_dim,
                                     list(probe_sweep), dev),
                        f"nlist{n_lists}.pq{pq_dim}")
        elif a == "raft_cagra":
            cases[a] = (_cagra_case(base, metric, cagra_degree,
                                    list(itopk_sweep), dev),
                        f"degree{cagra_degree}")
        else:
            expects(False, "unknown algo %r", a)
    return cases


def byte_grid(base: torch.Tensor, queries: torch.Tensor, metric,
              algos: Sequence[str]):
    """(base, queries) for a uint8 store: as they are when the corpus is
    already bytes (integral in [0, 255]); else both moved onto the byte
    grid by one affine map, ``round((x - min) · 255 / (max - min))`` for
    the base and the same map unrounded for the queries, the JAX harness's
    remap. The shared shift keeps only L2 order, and only brute force and
    IVF-Flat take the store, so a float corpus needs an L2 metric and
    those two algorithms alone (others would run on remapped data against
    the original ground truth)."""
    from ..distance.distance_types import DistanceType, canonical_metric

    mn, mx = float(base.min()), float(base.max())
    sample = base[:: max(1, len(base) // 4096)]
    maybe_bytes = (mn >= 0 and mx <= 255
                   and torch.equal(sample, torch.round(sample)))
    if maybe_bytes and all(torch.equal(c, torch.round(c))
                           for c in torch.split(base, 1 << 16)):
        return base, queries
    expects(canonical_metric(metric) in (DistanceType.L2Expanded,
                                         DistanceType.L2SqrtExpanded),
            "uint8 on a float corpus requires an L2 metric (the byte-grid "
            "shift reorders cosine/IP neighbors); got %r", metric)
    expects(set(algos) <= set(_DTYPE_ALGOS),
            "uint8 on a float corpus: restrict --algorithms to "
            "raft_brute_force/raft_ivf_flat (other algos ignore dtype and "
            "would run on remapped data vs original gt)")
    scale = 255.0 / max(mx - mn, 1e-30)
    return (torch.round((base - mn) * scale), (queries - mn) * scale)


def run_benchmarks(
    base,
    queries,
    gt_indices,
    k: int = 10,
    metric: str = "sqeuclidean",
    algos: Sequence[str] = ("raft_brute_force", "raft_ivf_flat",
                            "raft_ivf_pq", "raft_cagra"),
    batch_size: Optional[int] = None,
    reps: int = 5,
    verbose: bool = True,
    dtype: str = "float32",
    device=None,
) -> List[BenchResult]:
    """Build each algo and sweep its search parameters on ``device`` (the
    CUDA card by default); QPS from the median of ``reps`` calls, the
    card synchronised after each (``autotune.measure``), and recall@k
    against ``gt_indices``."""
    from ..ops import autotune
    from ..stats.metrics import neighborhood_recall

    dev = resolve_device(device)
    expects(dtype in DTYPES, "bench dtype must be one of %s, got %r",
            DTYPES, dtype)
    base = torch.as_tensor(base).to(device=dev, dtype=torch.float32)
    queries = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    if dtype == "uint8":
        base, queries = byte_grid(base, queries, metric, algos)
    gt = torch.as_tensor(gt_indices)[:, :k].to(dev)
    if batch_size:
        queries, gt = queries[:batch_size], gt[:batch_size]
    queries = queries.contiguous()
    expects(len(gt) == len(queries), "gt/queries length mismatch")

    results: List[BenchResult] = []
    for algo, ((build, make_search, sweep, prepare), tag) in \
            default_configs(base, metric, algos, dtype=dtype,
                            device=dev).items():
        if prepare is not None:
            note = prepare()
            if verbose:
                print(f"# {algo}: {note}", flush=True)
        _sync(dev)
        t0 = time.perf_counter()
        index = build()
        _sync(dev)
        build_time = time.perf_counter() - t0
        if verbose:
            print(f"# {algo}: built in {build_time:.2f}s", flush=True)
        for params in sweep:
            fn, extra = make_search(index, queries, k, **params)
            out = fn(queries)                       # warm-up
            _sync(dev)
            dt = autotune.measure(fn, queries, reps=reps, out0=out)
            recall = neighborhood_recall(out[1][:, :k], gt)
            ptag = ".".join(f"{kk}{vv}" for kk, vv in params.items())
            name = ".".join(x for x in (algo, tag, ptag) if x)
            results.append(BenchResult(
                name=name, algo=algo, build_time=build_time,
                search_params=dict(params), qps=len(queries) / dt,
                latency_s=dt, recall=recall, k=k, batch_size=len(queries),
                extra=extra))
            if verbose:
                r = results[-1]
                print(f"#   {name}: qps={r.qps:,.0f} "
                      f"recall@{k}={r.recall:.4f}", flush=True)
        del index
    return results


def to_gbench_json(results: List[BenchResult], context: Dict[str, Any]
                   ) -> str:
    """The whole Google-Benchmark JSON document (context + benchmarks[])."""
    return json.dumps({
        "context": context,
        "benchmarks": [r.to_gbench() for r in results],
    }, indent=2)
