"""CAGRA's graph routes and measured engine choice in the PyTorch port:
``build_knn_graph``'s ``auto`` resolution (against the JAX package's
table, and a recorded verdict winning), the IVF-PQ candidate pass against
JAX's on one JAX-built IVF-PQ index carried over with
``raft_tpu_torch.convert``, the NN-descent route's edge recall against
JAX's route on the same rows, ``build`` with ``BuildAlgo.NN_DESCENT``,
``tune_search``'s store policy, and ``autotune.tune_best``, which lets no
candidate's exception pass.

The IVF-PQ pass is compared at ``lut_dtype=float32`` on both sides (the
route's int8 LUT scores differently in the two packages: ROADMAP queue
C), with both packages' ``ivf_pq.build`` and ``SearchParams`` swapped for
the carried index and a float32 LUT; each side's swapped ``build`` and
``SearchParams`` record the parameters the route asked for, which must be
JAX's. Tolerance: on Gaussian data the port scores the PQ candidates in
the expanded form and JAX in the residual form (``test_torch_ivf_pq.py``:
ids equal on >= 98% of rows at rtol 1e-4), and refine sums the bf16
products in another order, so a graph row may differ where two
candidates nearly tie: at least 99% of the rows are equal and 99.9% of
the edges shared.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_utils import calc_recall, naive_knn
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import convert
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.distance.distance_types import (DistanceType,
                                                    canonical_metric)
from raft_tpu_torch.neighbors import cagra, ivf_pq
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops.cagra_fused import fused_capable
from raft_tpu_torch.stats.metrics import neighborhood_recall
from test_graph_build import clustered, exact_graph_oracle

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def fresh_verdicts(monkeypatch):
    """Each test starts with no recorded verdict."""
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product",
                                    "cosine"])
@pytest.mark.parametrize("n", [1000, cagra.BRUTE_N, cagra.BRUTE_N + 1,
                               1_000_000])
def test_auto_resolution_matches_jax(n, metric):
    from raft_tpu.distance.distance_types import canonical_metric as jcm

    want = jcagra._resolve_graph_algo(n, 128, 64, "auto", jcm(metric))
    got = cagra._resolve_graph_algo(n, 128, 64, "auto",
                                    canonical_metric(metric), "cpu")
    assert got == want
    assert cagra._resolve_graph_algo(n, 128, 64, "ivf_pq",
                                     canonical_metric(metric),
                                     "cpu") == "ivf_pq"


def test_auto_resolution_recorded_verdict_wins():
    l2, cos = DistanceType.L2Expanded, DistanceType.CosineExpanded
    autotune.record(cagra._graph_algo_key(500_000, 128, 64, l2, "cpu"),
                    "ivf_pq")
    assert cagra._resolve_graph_algo(500_000, 128, 64, "auto", l2,
                                     "cpu") == "ivf_pq"
    # the same log2 bucket of n: the same verdict
    assert cagra._resolve_graph_algo(400_000, 128, 64, "auto", l2,
                                     "cpu") == "ivf_pq"
    # another metric keys apart; a verdict the metric cannot serve is
    # passed over
    assert cagra._resolve_graph_algo(500_000, 128, 64, "auto", cos,
                                     "cpu") == "ivf_pq"
    autotune.record(cagra._graph_algo_key(500_000, 128, 64, cos, "cpu"),
                    "nn_descent")
    assert cagra._resolve_graph_algo(500_000, 128, 64, "auto", cos,
                                     "cpu") == "ivf_pq"
    autotune.record(cagra._graph_algo_key(1000, 128, 64, l2, "cpu"),
                    "nn_descent")
    assert cagra._resolve_graph_algo(1000, 128, 64, "auto", l2,
                                     "cpu") == "nn_descent"


def _capture(monkeypatch, mod, index, sp_cls, lut, log):
    """Swap ``mod.build`` for one returning ``index`` and
    ``mod.SearchParams`` for one with ``lut``; record what the route
    asked for in ``log``."""
    def build(x, params, **kw):
        log["build"] = (params.n_lists, params.pq_dim, params.pq_bits,
                        getattr(params.metric, "value", params.metric),
                        params.seed)
        return index

    def search_params(n_probes, lut_dtype):
        log["search"] = (n_probes, lut_dtype)
        return sp_cls(n_probes, lut_dtype=lut)

    monkeypatch.setattr(mod, "build", build)
    monkeypatch.setattr(mod, "SearchParams", search_params)


@pytest.mark.parametrize("k", [12, 128])
def test_ivf_pq_pass_matches_jax(monkeypatch, k):
    """The route against JAX's on one carried index, at k = 12 and at the
    path's intermediate degree 128, where the pass asks the scan for
    2·128 + 1 = 257 candidates a row."""
    x = clustered(2000, 32, seed=7)
    n_lists = max(16, min(1024, int(np.sqrt(len(x)) * 2)))
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=n_lists, pq_dim=32, pq_bits=4, seed=5))
    tidx = convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(jidx.codes),
         "source_ids": np.asarray(jidx.source_ids),
         "centers_rot": np.asarray(jidx.centers_rot),
         "codebooks": np.asarray(jidx.codebooks),
         "rotation": np.asarray(jidx.rotation),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr,
         "metric": jidx.metric.value, "pq_bits": jidx.pq_bits,
         "codebook_kind": jidx.codebook_kind}, device="cpu")
    jlog, tlog = {}, {}
    _capture(monkeypatch, jcagra.ivf_pq_mod, jidx, jpq.SearchParams,
             jnp.float32, jlog)
    _capture(monkeypatch, ivf_pq, tidx, ivf_pq.SearchParams, torch.float32,
             tlog)
    want = jcagra.build_knn_graph(x, k, seed=5, batch=700, algo="ivf_pq")
    info = {}
    got = cagra.build_knn_graph(x, k, seed=5, batch=700, algo="ivf_pq",
                                info=info, device="cpu")
    assert info == {"algo": "ivf_pq"}
    assert tlog["build"] == jlog["build"] == (89, 32, 4, "l2_expanded", 5)
    assert tlog["search"] == jlog["search"] == (16, "int8")
    got = got.numpy()
    assert got.dtype == np.int32 and got.shape == want.shape
    assert (got != np.arange(len(x))[:, None]).all()
    rows_equal = (got == want).all(axis=1).mean()
    shared = np.mean([len(set(a) & set(b)) / k for a, b in zip(got, want)])
    assert rows_equal >= 0.99 and shared >= 0.999, (rows_equal, shared)


def test_ivf_pq_pass_edge_recall():
    """The route unswapped (int8 LUT, the port's own IVF-PQ build): its
    edges against the exact graph."""
    x = clustered(3000, 32, seed=8)
    g = cagra.build_knn_graph(x, 16, algo="ivf_pq", device="cpu").numpy()
    assert calc_recall(g, exact_graph_oracle(x, 16)) >= 0.9


@pytest.mark.parametrize("fixture", ["jax_floor", "path_shaped"])
def test_nn_descent_route_recall_against_jax(monkeypatch, fixture):
    """CAGRA's NN-descent route against the JAX package's on the same
    rows, each at its default round cap (15) and seed 0: the port's
    exposure (sampled neighbors, a difference by design) finds at least
    JAX's edge recall. ``jax_floor``: JAX's own fixture
    (``tests/test_graph_build.py``, k = 16). ``path_shaped``:
    ``chip_smoke.py``'s corpus cut to 2,000 rows in 2 clusters (1,000
    rows a cluster and 128 dims, as at 1M rows), k = 32: JAX's closest
    exposure stops on its update rate before the cap, and the port's
    recall is above it by more than 0.01. Both builders read the state
    before each sweep, so the node batch (512 here, to bound the
    gathered candidates' memory) does not change the graphs."""
    import functools

    from raft_tpu_torch.ops import nn_descent as tnnd
    from raft_tpu_torch.tools.nnd_sweep import path_data

    if fixture == "jax_floor":
        x, k = clustered(1000, 32, seed=5), 16
    else:
        x, k = path_data(2000, 128, 2, seed=0), 32
    monkeypatch.setenv("RAFT_TPU_NND_BATCH", "512")
    monkeypatch.setattr(tnnd, "build_graph",
                        functools.partial(tnnd.build_graph, batch=512))
    exact = exact_graph_oracle(x, k)
    jax_rounds = []
    want = jcagra.build_knn_graph(x, k, algo="nn_descent",
                                  progress=lambda r, total, s:
                                  jax_rounds.append(r))
    info = {}
    got = cagra.build_knn_graph(x, k, algo="nn_descent", info=info,
                                device="cpu").numpy()
    assert info["algo"] == "nn_descent" and info["nnd_rounds"] <= 15
    assert (got != np.arange(len(x))[:, None]).all()
    r_jax, r_port = calc_recall(want, exact), calc_recall(got, exact)
    assert r_port >= r_jax, (r_port, r_jax)
    if fixture == "path_shaped":
        assert len(jax_rounds) < 15, jax_rounds
        assert r_port > r_jax + 0.01, (r_port, r_jax)


@pytest.mark.parametrize("algo", ["brute", "nn_descent", "ivf_pq"])
def test_build_records_the_builder(algo):
    x = clustered(1500, 24, seed=9)
    q = clustered(64, 24, seed=10)
    p = cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                          knn_graph_algo=algo, nn_descent_niter=6, seed=1)
    idx = cagra.build(x, p, device="cpu")
    assert idx.build_stats["knn_algo"] == algo
    assert ("nnd_rounds" in idx.build_stats) == (algo == "nn_descent")
    _, want = naive_knn(x, q, 10)
    _, got = cagra.search(idx, q, 10, cagra.SearchParams(itopk_size=32),
                          engine="gather")
    assert neighborhood_recall(got, torch.from_numpy(want)) >= 0.9


def test_build_nn_descent_algo():
    """``BuildAlgo.NN_DESCENT`` takes NN-descent whatever
    ``knn_graph_algo`` says, at most ``nn_descent_niter`` rounds."""
    x = clustered(1200, 24, seed=11)
    p = cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16,
                          build_algo=cagra.BuildAlgo.NN_DESCENT,
                          knn_graph_algo="brute", nn_descent_niter=3)
    idx = cagra.build(x, p, device="cpu")
    st = idx.build_stats
    assert st["knn_algo"] == "nn_descent" and 1 <= st["nnd_rounds"] <= 3
    g = idx.graph.numpy()
    assert g.shape == (1200, 16) and g.min() >= 0 and g.max() < 1200
    assert (g != np.arange(1200)[:, None]).all()


@pytest.fixture(scope="module")
def small_index():
    x = clustered(1200, 24, seed=12)
    q = torch.from_numpy(clustered(40, 24, seed=13))
    p = cagra.IndexParams(intermediate_graph_degree=32, graph_degree=16)
    return cagra.build(x, p, device="cpu"), q


def test_tune_search_gather_win_drops_the_store(small_index):
    idx, q = small_index
    sp = cagra.SearchParams(itopk_size=32, max_iterations=6)
    idx.edge_store = None
    winner, times = cagra.tune_search(idx, q, 5, sp, reps=1,
                                      engines=("gather",))
    assert winner == "gather" and set(times) == {"gather"}
    assert idx.edge_store is None
    # both keys hold the verdict: with a store and without
    assert autotune.lookup(cagra._tune_key(idx, 40, 5, sp, None)) == "gather"
    assert cagra.resolve_engine(idx, 40, 5, sp) == "gather"


def test_tune_search_store_win_keeps_the_store(small_index):
    idx, q = small_index
    sp = cagra.SearchParams(itopk_size=32, max_iterations=6)
    winner, times = cagra.tune_search(idx, q, 5, sp, reps=1,
                                      engines=("edge", "fused"))
    assert winner in ("edge", "fused") and set(times) == {"edge", "fused"}
    assert winner == min(times, key=times.get)
    assert idx.edge_store is not None
    assert cagra.resolve_engine(idx, 40, 5, sp) == winner
    # without the store the store-backed verdict does not apply: the store
    # rule off CUDA is the gather engine
    store, idx.edge_store = idx.edge_store, None
    assert cagra.resolve_engine(idx, 40, 5, sp) == "gather"
    idx.edge_store = store
    # another itopk is another key: the store rule until it is raced
    other = cagra.SearchParams(itopk_size=64, max_iterations=6)
    assert autotune.lookup(cagra._tune_key(idx, 40, 5, other,
                                           idx.edge_store)) is None


def test_tune_search_races_every_engine(small_index):
    idx, q = small_index
    sp = cagra.SearchParams(itopk_size=32, max_iterations=6)
    winner, times = cagra.tune_search(idx, q, 5, sp, reps=1)
    assert set(times) == set(cagra.ENGINES)
    assert winner == min(times, key=times.get)
    d, i = cagra.search(idx, q, 5, sp)            # auto: the verdict
    assert i.shape == (40, 5)


def test_fused_capable_limits():
    assert fused_capable(64, 1, 64, 64, 128, "int8", 80, "cpu")
    assert not fused_capable(64, 1, 64, 64, 128, "int8", 0, "cpu")
    assert not fused_capable(320, 1, 64, 64, 128, "int8", 80, "cpu")
    assert not fused_capable(64, 1, 64, 288, 128, "int8", 80, "cpu")


def test_tune_best_does_not_swallow_a_failure():
    def bad(q):
        raise RuntimeError("kernel failed")

    cands = {"good": lambda q: q + 1, "bad": bad}
    with pytest.raises(RuntimeError, match="kernel failed"):
        autotune.tune_best("k", cands, torch.zeros(4), reps=1)
    assert autotune.lookup("k") is None
    winner, times = autotune.tune_best("k", {"good": cands["good"]},
                                       torch.zeros(4), reps=2)
    assert winner == "good" and times["good"] >= 0.0
    # a recorded verdict returns at once unless forced
    assert autotune.tune_best("k", cands, torch.zeros(4)) == ("good", {})
    with pytest.raises(RuntimeError, match="kernel failed"):
        autotune.tune_best("k", cands, torch.zeros(4), force=True)
    with pytest.raises(RaftError, match="no candidate"):
        autotune.tune_best("j", {}, torch.zeros(4))


def test_shape_bucket_names_the_device():
    a = autotune.shape_bucket("fam", "cpu", n=1000, store="int8")
    assert a == "cpu:cpu:fam:n10:storeint8"
    assert autotune.shape_bucket("fam", "cpu", n=1024, store="int8") == a
    assert autotune.shape_bucket("fam", "cpu", n=1025, store="int8") != a
