"""CAGRA's kNN-graph builder race in the PyTorch port
(``raft_tpu_torch.bench.race_graph_build``), the counterpart of the JAX
bench's graph lane (``bench.py:2040-2088``), extended to the three
builders ``cagra._resolve_graph_algo`` accepts and recorded at the
build's own shape class.

The winner rule is a pure function (:func:`graph_race_winner`), checked
on made-up readings. The race itself runs on 3,000 x 16 rows on the CPU:
its verdict lands under the build's own key, and ``cagra.build`` with
``knn_graph_algo="auto"`` then runs it. Edge recall is exact arithmetic
(a share of shared ids), checked against a numpy count.
"""
import time

import numpy as np
import pytest
import torch

from raft_tpu_torch import bench
from raft_tpu_torch.bench import runner
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.distance.distance_types import canonical_metric
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import autotune

torch.set_num_threads(1)

N, D, K = 3000, 16, 16


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No autotune verdict file: this module's verdicts stay in memory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None


@pytest.mark.parametrize("seconds,recalls,want", [
    # NN-descent fastest, but below the bar: the next fastest that clears it
    ({"brute": 9.0, "ivf_pq": 5.5, "nn_descent": 2.0},
     {"brute": 1.0, "ivf_pq": 0.94, "nn_descent": 0.85}, "ivf_pq"),
    ({"brute": 9.0, "ivf_pq": 5.5, "nn_descent": 27.0},
     {"brute": 1.0, "ivf_pq": 0.94, "nn_descent": 0.81}, "ivf_pq"),
    ({"brute": 9.0, "ivf_pq": 5.5, "nn_descent": 2.0},
     {"brute": 1.0, "ivf_pq": 0.94, "nn_descent": 0.95}, "nn_descent"),
    # the exact graph qualifies whatever its time
    ({"brute": 90.0, "ivf_pq": 5.5, "nn_descent": 2.0},
     {"brute": 1.0, "ivf_pq": 0.89, "nn_descent": 0.5}, "brute"),
    ({"brute": 1.0, "ivf_pq": 5.5, "nn_descent": 2.0},
     {"brute": 1.0, "ivf_pq": 0.99, "nn_descent": 0.99}, "brute"),
    # exactly at the bar qualifies; no NN-descent lane (a metric it lacks)
    ({"brute": 9.0, "ivf_pq": 5.5},
     {"brute": 1.0, "ivf_pq": 0.9}, "ivf_pq")])
def test_winner_rule(seconds, recalls, want):
    assert bench.graph_race_winner(seconds, recalls) == want


def test_winner_rule_bar_and_refusal():
    secs = {"brute": 9.0, "ivf_pq": 5.5}
    recs = {"brute": 1.0, "ivf_pq": 0.93}
    assert bench.graph_race_winner(secs, recs, min_edge_recall=0.95) == \
        "brute"
    with pytest.raises(RaftError, match="no builder qualifies"):
        bench.graph_race_winner({"ivf_pq": 1.0}, {"ivf_pq": 0.5})


def test_edge_recall_counts_shared_edges():
    rng = np.random.default_rng(3)
    exact = np.stack([rng.permutation(500)[:8] for _ in range(300)])
    graph = exact.copy()
    graph[rng.random(graph.shape) < 0.3] = -1
    want = np.mean([len(set(g) & set(e)) / 8 for g, e in zip(graph, exact)])
    got = runner._edge_recall(torch.from_numpy(graph),
                              torch.from_numpy(exact), rows=64)
    assert got == pytest.approx(want, abs=1e-12)


@pytest.fixture(scope="module")
def blobs():
    base, _, _, _ = bench.load_dataset(f"blobs-{N}x{D}", n_queries=10,
                                       device="cpu")
    return base


def test_race_records_the_verdict_at_the_build_shape(blobs):
    """Every builder runs, the exact graph's recall is 1, the verdict is
    the rule's on the race's own readings, recorded under the build's own
    key (not another n's), and an ``auto`` build runs it."""
    mt = canonical_metric("sqeuclidean")
    winner, secs, recs = bench.race_graph_build(blobs, K, "sqeuclidean",
                                                "cpu")
    assert set(secs) == set(recs) == {"brute", "ivf_pq", "nn_descent"}
    assert recs["brute"] == 1.0 and all(t > 0 for t in secs.values())
    assert all(0.9 <= r <= 1.0 for r in recs.values()), recs
    assert winner == bench.graph_race_winner(secs, recs)
    assert autotune.lookup(cagra._graph_algo_key(N, D, K, mt, "cpu")) == \
        winner
    assert autotune.lookup(cagra._graph_algo_key(100_000, D, K, mt,
                                                 "cpu")) is None
    idx = cagra.build(blobs, cagra.IndexParams(
        intermediate_graph_degree=K, graph_degree=8), device="cpu")
    assert idx.build_stats["knn_algo"] == winner


def test_auto_build_follows_a_slower_exact_graph(blobs, monkeypatch):
    """With the exact builder slowed down, an approximate builder wins the
    race, and ``knn_graph_algo="auto"`` then builds with it (below
    ``BRUTE_N`` rows, where the exact graph is the default)."""
    build = cagra.build_knn_graph

    def slow_exact(x, k, *a, algo="auto", **kw):
        if algo == "brute" and x.shape[0] == N:
            time.sleep(4.0)
        return build(x, k, *a, algo=algo, **kw)

    monkeypatch.setattr(cagra, "build_knn_graph", slow_exact)
    winner, secs, recs = bench.race_graph_build(blobs, K, "sqeuclidean",
                                                "cpu")
    monkeypatch.setattr(cagra, "build_knn_graph", build)
    assert winner != "brute" and secs["brute"] >= 4.0
    assert winner == bench.graph_race_winner(secs, recs)
    idx = cagra.build(blobs, cagra.IndexParams(
        intermediate_graph_degree=K, graph_degree=8), device="cpu")
    assert idx.build_stats["knn_algo"] == winner


def test_race_refuses_a_degree_past_the_rows(blobs):
    with pytest.raises(RaftError, match="needs 0 < k < n"):
        bench.race_graph_build(blobs[:10], 10, device="cpu")
