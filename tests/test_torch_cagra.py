"""CAGRA in the PyTorch port against ``raft_tpu.neighbors.cagra``: the
exact kNN graph, ``optimize``, the edge store and the covering seed set
of the build; and search on a JAX-built index carried over with
``raft_tpu_torch.convert.cagra_index_from_numpy``, engine by engine
(gather with bf16 and float32 candidates, edge, fused), with the JAX
package's random seed rows injected into the port's one draw
(``cagra._draw_seeds``) so both traverse from the same buffer. The JAX
side runs its Pallas kernels in interpret mode. A filtered search runs on
both sides under each package's ``filter_policy.suspended()`` (the 60%
filter: survivor-aware seeding and the edge penalty), and with the
adaptive policy on both sides: ``"crossover"`` (the 60% filter at the
default survivor threshold: the survivors searched by brute force) and
``"widened"`` (a 30% filter with ``RAFT_TPU_FILTER_BRUTE_MAX=0``: itopk
16 widened to 32).

Tolerances. The kNN graph (small-integer data: exact distances, ties to
the lower row in both) and ``optimize`` (integer detour counts) are equal;
so are the int8 and int4 edge stores, their aux and graph rows, and the
bf16 rows (the bf16 norms are float32 sums in another order: rtol 1e-6). Search on
integer-valued data and queries: ids and distances equal. On Gaussian
data: ``assert_knn_close`` (distances to rtol 1e-5, ids on >= 99% of
rows). The covering seed set draws its k-means from ``torch.Generator``,
so it is checked by its contract (sorted, unique, in range, the JAX size
rule) and the port's own build by recall: at least JAX's minus 0.02.
``health`` on a carried JAX index: the connectivity fields equal, the
int8 and bf16 copies' errors within 1e-6 (the codecs are bit-equal). A
search in chunks draws its own seed rows a chunk (``_chunk_seed``, as
JAX folds the chunk's start into its key), so it is held to searches of
each chunk alone, and by recall (within 0.05) to one batch's.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_utils import naive_knn
from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops import filter_policy
from raft_tpu_torch import convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops import filter_policy as tfp
from raft_tpu_torch.stats.metrics import neighborhood_recall
from test_torch_kernels import (ENGINE_TEST_BUILD, ENGINE_TEST_FLOOR,
                                ENGINE_TEST_SEARCH, assert_knn_close,
                                engine_test_data)

torch.set_num_threads(1)


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No autotune verdict file: this module's verdicts stay in memory, and
    none is read from the user's cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None

N, D, M, K, D0, DEG = 1000, 16, 48, 5, 24, 16
# one plan for every search, so each JAX engine compiles once per index
JSP = dict(itopk_size=16, search_width=1, max_iterations=4)
ENGINES = [("gather", "bfloat16"), ("gather", "float32"), ("edge", "int8"),
           ("fused", "int8")]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((M, D)).astype(np.float32)
    xi = rng.integers(-4, 5, (N, D)).astype(np.float32)
    qi = rng.integers(-4, 5, (M, D)).astype(np.float32)
    keep = rng.random(N) < 0.6
    return x, q, xi, qi, keep


@pytest.fixture(scope="module")
def jax_index(data):
    """A JAX build on Gaussian data, with its covering seed set."""
    return jcagra.build(data[0], jcagra.IndexParams(
        intermediate_graph_degree=D0, graph_degree=DEG, seed=0))


@pytest.fixture(scope="module")
def jax_index_int(data):
    """A JAX build on integer-valued data, without a covering set."""
    return jcagra.build(data[2], jcagra.IndexParams(
        intermediate_graph_degree=D0, graph_degree=DEG, seed=0,
        seed_nodes=0))


def _carry(jidx):
    return convert.cagra_index_from_numpy(
        {"dataset": np.asarray(jidx.dataset), "graph": np.asarray(jidx.graph),
         "metric": jidx.metric.value,
         "seed_nodes": (None if jidx.seed_nodes is None
                        else np.asarray(jidx.seed_nodes))}, device="cpu")


@pytest.fixture
def jax_seeds(monkeypatch):
    """Make the port draw the JAX package's random seed rows."""
    def draw(m, n_seeds, high, seed, device):
        r = jax.random.randint(jax.random.key(seed), (m, n_seeds), 0, high)
        return torch.from_numpy(np.array(r)).to(device)

    monkeypatch.setattr(cagra, "_draw_seeds", draw)


def _search_both(jidx, tidx, q, engine, cdtype, keep=None, k=K,
                 adaptive=False):
    """Both packages' searches; a filtered one under both packages'
    ``suspended()`` unless ``adaptive``."""
    jf = tf = None
    if keep is not None:
        jf = JaxBitset.from_mask(jnp.asarray(keep))
        tf = Bitset.from_mask(torch.from_numpy(keep))
    with contextlib.ExitStack() as stack:
        if not adaptive:
            stack.enter_context(filter_policy.suspended())
            stack.enter_context(tfp.suspended())
        jd, ji = jcagra.search(jidx, jnp.asarray(q), k, jcagra.SearchParams(
            candidate_dtype=cdtype, **JSP), filter=jf, engine=engine)
        td, ti = cagra.search(tidx, torch.from_numpy(q), k,
                              cagra.SearchParams(candidate_dtype=cdtype,
                                                 **JSP),
                              filter=tf, engine=engine)
    assert td.shape == (M, k) and ti.dtype == torch.int32
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


def test_knn_graph_brute_matches_jax(data):
    xi = data[2]
    jg = jcagra.build_knn_graph(xi, D0, algo="brute", engine="matmul")
    for algo in ("brute", "auto"):
        tg = cagra.build_knn_graph(xi, D0, algo=algo, batch=384,
                                   device="cpu")
        assert tg.dtype == torch.int32
        np.testing.assert_array_equal(tg.numpy(), jg)
    with pytest.raises(RaftError, match="unknown knn_graph algo"):
        cagra.build_knn_graph(xi, D0, algo="exact", device="cpu")


@pytest.mark.parametrize("graph_degree", [DEG, 11])
def test_optimize_matches_jax(data, graph_degree):
    jg = jcagra.build_knn_graph(data[0], D0, algo="brute", engine="matmul")
    jo = jcagra.optimize(jg, graph_degree)
    to = cagra.optimize(torch.from_numpy(jg), graph_degree, batch=40)
    np.testing.assert_array_equal(to.numpy(), jo)


@pytest.mark.parametrize("store", ["int8", "bfloat16", "int4"])
def test_prepare_traversal_matches_jax(jax_index, store):
    jidx = jcagra.Index(jax_index.dataset, jax_index.graph, jax_index.metric,
                        jax_index.seed_nodes)
    jcagra.prepare_traversal(jidx, store)
    _, jv, ja, jg, _ = jidx._edge_store
    tidx = _carry(jax_index)
    cagra.prepare_traversal(tidx, store)
    cagra.prepare_traversal(tidx, store)          # a no-op the second time
    st = tidx.edge_store
    assert (st.mode, st.degree, st.deg_p, st.dim_p) == (store, DEG, 32, 128)
    np.testing.assert_array_equal(st.vecs.to(torch.float32).numpy(),
                                  np.asarray(jv.astype(jnp.float32)))
    np.testing.assert_array_equal(st.gp.numpy(), np.asarray(jg))
    ja = np.asarray(ja)
    np.testing.assert_array_equal(st.aux[:, 0].numpy(), ja[:, 0])
    if store == "bfloat16":
        np.testing.assert_allclose(st.aux[:, 1].numpy(), ja[:, 1],
                                   rtol=1e-6)
    else:       # int8 and int4 norms: exact integer sums, then the scale
        np.testing.assert_array_equal(st.aux[:, 1].numpy(), ja[:, 1])
    with pytest.raises(RaftError, match="edge store dtype"):
        cagra.prepare_traversal(tidx, "int2")


def test_covering_seeds_contract(data, jax_index):
    x = torch.from_numpy(data[0])
    seeds = cagra.build_covering_seeds(x, cagra.IndexParams())
    s = seeds.numpy()
    # JAX's size rule at n = 1000: max(128, min(2048, n // 64)) = 128
    # centers, one row each, duplicates removed
    assert seeds.dtype == torch.int32 and 64 <= len(s) <= 128
    assert (np.diff(s) > 0).all() and s.min() >= 0 and s.max() < N
    assert abs(len(s) - len(np.asarray(jax_index.seed_nodes))) <= 32
    for asked, size in ((0, None), (40, None), (100, 100)):
        got = cagra.build_covering_seeds(
            x, cagra.IndexParams(seed_nodes=asked))
        assert (got is None) if size is None else len(got) <= size
    assert cagra.build_covering_seeds(x[:400], cagra.IndexParams()) is None


def test_port_build_recall(data, jax_index):
    x, q = data[0], data[1]
    tidx = cagra.build(x, cagra.IndexParams(intermediate_graph_degree=D0,
                                            graph_degree=DEG), device="cpu")
    assert tidx.graph.shape == (N, DEG) and tidx.seed_nodes is not None
    assert set(tidx.build_stats) >= {"knn_graph_s", "optimize_s",
                                     "seeds_s"}
    _, ref = naive_knn(x, q, K)
    ref = torch.from_numpy(ref)
    sp = dict(itopk_size=32, max_iterations=8)
    _, ti = cagra.search(tidx, q, K, cagra.SearchParams(**sp))
    _, ji = jcagra.search(jax_index, jnp.asarray(q), K,
                          jcagra.SearchParams(**sp), engine="gather")
    jrec = neighborhood_recall(torch.from_numpy(np.array(ji)), ref)
    assert neighborhood_recall(ti, ref) >= jrec - 0.02


@pytest.mark.parametrize("engine,cdtype", ENGINES)
def test_search_matches_jax(data, jax_index, jax_seeds, engine, cdtype):
    """Gaussian data, the covering set in use."""
    jd, ji, td, ti = _search_both(jax_index, _carry(jax_index), data[1],
                                  engine, cdtype)
    assert_knn_close(jd, ji, td, ti)


@pytest.mark.parametrize("engine,cdtype,k", [e + (K,) for e in ENGINES]
                         + [("fused", "int8", 1)])
def test_search_matches_jax_integer(data, jax_index_int, jax_seeds, engine,
                                    cdtype, k):
    """Integer-valued data, random seeding only: equal ids and
    distances (also at k = 1 for the fused engine)."""
    jd, ji, td, ti = _search_both(jax_index_int, _carry(jax_index_int),
                                  data[3], engine, cdtype, k=k)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("engine,cdtype,policy", [
    pytest.param("gather", "bfloat16", "suspended", id="gather-bfloat16"),
    pytest.param("edge", "int8", "suspended", id="edge-int8"),
    pytest.param("fused", "int8", "suspended", id="fused-int8"),
    ("gather", "bfloat16", "crossover"), ("fused", "int8", "crossover"),
    ("gather", "bfloat16", "widened"), ("edge", "int8", "widened"),
    ("fused", "int8", "widened")])
def test_search_matches_jax_filtered(data, jax_index, jax_seeds, engine,
                                     cdtype, policy, monkeypatch):
    """A 60% filter under both packages' ``suspended()`` (survivor-aware
    seeding and the edge penalty) and at the crossover; a 30% filter at a
    widened level (itopk x2)."""
    keep = data[4]
    if policy == "widened":
        monkeypatch.setenv("RAFT_TPU_FILTER_BRUTE_MAX", "0")
        keep = np.random.default_rng(32).random(N) < 0.3
    jd, ji, td, ti = _search_both(jax_index, _carry(jax_index), data[1],
                                  engine, cdtype, keep,
                                  adaptive=policy != "suspended")
    assert_knn_close(jd, ji, td, ti)
    assert keep[ti[ti >= 0]].all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_engine_test_data_recall(metric):
    """The data and plans of ``test_torch_kernels.py::
    test_cagra_engines_on_card``, built and searched here: the port's
    edge engine (the plain K5, which the card's K5 and K6 equal) and the
    JAX package's gather engine clear that test's floor by >= 0.02, and
    the port stays within 0.02 of JAX."""
    x, q = engine_test_data()
    _, ref = naive_knn(x, q, 10, metric)
    ref = torch.from_numpy(ref)
    tidx = cagra.build(x, cagra.IndexParams(metric=metric,
                                            **ENGINE_TEST_BUILD),
                       device="cpu")
    _, ti = cagra.search(tidx, q, 10, cagra.SearchParams(
        **ENGINE_TEST_SEARCH), engine="edge")
    jidx = jcagra.build(x, jcagra.IndexParams(metric=metric, seed=0,
                                              **ENGINE_TEST_BUILD))
    _, ji = jcagra.search(jidx, jnp.asarray(q), 10, jcagra.SearchParams(
        **ENGINE_TEST_SEARCH), engine="gather")
    trec = neighborhood_recall(ti, ref)
    jrec = neighborhood_recall(torch.from_numpy(np.array(ji)), ref)
    print(f"engine test data, {metric}: port edge recall@10 {trec:.4f}, "
          f"JAX gather {jrec:.4f}")
    assert jrec >= ENGINE_TEST_FLOOR + 0.02
    assert trec >= max(ENGINE_TEST_FLOOR + 0.02, jrec - 0.02)


# ------------------------------------------------ health, chunks, searchers


def _jax_copy(jidx):
    """A fresh JAX index on the same arrays (no caches attached)."""
    return jcagra.Index(jidx.dataset, jidx.graph, jidx.metric,
                        jidx.seed_nodes)


@pytest.mark.parametrize("copies", [(), ("int8",), ("int8", "bfloat16"),
                                    ("int8", "bfloat16", "edge")])
def test_health_matches_jax(jax_index, copies):
    """On a carried JAX index: the connectivity fields equal, the int8 and
    bf16 copies' sampled errors within 1e-6 (the codecs are bit-equal),
    the edge store's dtype, shape and bytes equal."""
    jidx, tidx = _jax_copy(jax_index), _carry(jax_index)
    for c in copies:
        if c == "edge":
            jcagra.prepare_traversal(jidx)
            cagra.prepare_traversal(tidx)
        else:
            jcagra.prepare_search(jidx, c)
            cagra.prepare_search(tidx, c)
    want, got = jcagra.health(jidx), cagra.health(tidx)
    wq, gq = want.pop("quant", {}), got.pop("quant", {})
    assert got == want
    assert set(gq) == set(wq)
    for name in ("int8", "bfloat16"):
        if name in wq:
            for field in ("rel_rmse", "max_abs_err"):
                assert abs(gq[name][field] - wq[name][field]) <= 1e-6
    if "edge_store" in wq:
        assert gq["edge_store"]["dtype"] == wq["edge_store"]["dtype"]
        assert gq["edge_store"]["shape"] == wq["edge_store"]["shape"]
        assert gq["edge_store"]["bytes"] == wq["edge_store"]["bytes"]


def test_health_connectivity_and_cache():
    """The JAX package's own case: node 63 has no incoming edge; the report
    is kept on the index and made anew for a new seed set; an empty index
    reports zeros, as JAX's does."""
    n, deg = 64, 4
    data = np.random.default_rng(0).standard_normal((n, 8)).astype(
        np.float32)
    g = ((np.arange(n)[:, None] + np.arange(1, deg + 1)[None, :])
         % (n - 1)).astype(np.int32)
    arrays = {"dataset": data, "graph": g, "metric": "l2_expanded"}
    tidx = convert.cagra_index_from_numpy(arrays, device="cpu")
    h = cagra.health(tidx)
    assert (h["unreachable_nodes"], h["unseeded_unreachable"]) == (1, 1)
    assert h["in_degree"]["min"] == 0 and tidx.health_conn is not None
    jidx = jcagra.Index(jnp.asarray(data), jnp.asarray(g),
                        jcagra.DistanceType.L2Expanded)
    assert h == jcagra.health(jidx)
    tidx.seed_nodes = torch.tensor([63], dtype=torch.int32)
    jidx.seed_nodes = jnp.asarray([63], jnp.int32)
    h2 = cagra.health(tidx)
    assert (h2["unreachable_nodes"], h2["unseeded_unreachable"]) == (1, 0)
    assert h2 == jcagra.health(jidx)
    empty = convert.cagra_index_from_numpy(
        {"dataset": data[:0], "graph": g[:0], "metric": "l2_expanded"},
        device="cpu")
    jempty = jcagra.Index(jnp.asarray(data[:0]), jnp.asarray(g[:0]),
                          jcagra.DistanceType.L2Expanded)
    assert cagra.health(empty) == jcagra.health(jempty)


@pytest.mark.parametrize("engine", ["gather", "fused"])
def test_chunked_search(data, jax_index, engine):
    """A chunk of the whole batch (no deadline) is the unchunked search;
    each smaller chunk is a search of its own queries with the chunk's
    seed (``_chunk_seed``); recall stays within 0.05 of one batch's."""
    tidx = _carry(jax_index)
    q = torch.from_numpy(data[1])
    sp = cagra.SearchParams(**JSP)
    wd, wi = cagra.search(tidx, q, K, sp, engine=engine)
    d, i = cagra.search(tidx, q, K, sp, engine=engine, query_chunk=M)
    assert torch.equal(d, wd) and torch.equal(i, wi)
    d, i = cagra.search(tidx, q, K, sp, engine=engine, query_chunk=20)
    for s0 in range(0, M, 20):
        own = dataclasses.replace(sp, seed=cagra._chunk_seed(sp.seed, s0))
        cd, ci = cagra.search(tidx, q[s0:s0 + 20], K, own, engine=engine)
        assert torch.equal(d[s0:s0 + 20], cd)
        assert torch.equal(i[s0:s0 + 20], ci)
    _, ref = naive_knn(data[0], data[1], K)
    ref = torch.from_numpy(ref)
    assert abs(neighborhood_recall(i, ref)
               - neighborhood_recall(wi, ref)) <= 0.05
    seeds = {cagra._chunk_seed(sp.seed, s0) for s0 in range(0, 1 << 14, 20)}
    assert len(seeds) == len(range(0, 1 << 14, 20))


def test_deadline_search(data, jax_index, monkeypatch):
    """A deadline that expires before the third chunk: the partial results
    are the chunked search's first two chunks; an expired one raises
    before any seeding, with no partial; one chunk under a deadline runs
    its checkpoint first."""
    from raft_tpu_torch.core.deadline import Deadline, DeadlineExceeded

    tidx = _carry(jax_index)
    q = torch.from_numpy(data[1])
    sp = cagra.SearchParams(**JSP)
    cd, ci = cagra.search(tidx, q, K, sp, query_chunk=16)
    ticks = iter([0.0, 0.0, 0.0, 5.0, 5.0])
    dl = Deadline(1.0, clock=lambda: next(ticks))
    with pytest.raises(DeadlineExceeded) as ei:
        cagra.search(tidx, q, K, sp, query_chunk=16, res=dl)
    pd, pi = ei.value.partial
    assert torch.equal(pd, cd[:32]) and torch.equal(pi, ci[:32])
    d, i = cagra.search(tidx, q, K, sp, res=Deadline(1e9))
    assert d.shape == (M, K) and cagra.DEADLINE_CHUNK >= M

    def no_seeding(*a, **kw):
        raise AssertionError("seeded under an expired deadline")

    monkeypatch.setattr(cagra, "_seed_buffer", no_seeding)
    for chunk in (0, 16):
        with pytest.raises(DeadlineExceeded) as ei:
            cagra.search(tidx, q, K, sp, query_chunk=chunk,
                         res=Deadline(0.0))
        assert ei.value.partial is None


@pytest.mark.parametrize("engine", ["gather", "edge", "fused"])
def test_make_searcher(data, jax_index, engine):
    """``fn`` is ``search`` with the options frozen; pinning the edge or
    fused engine builds the store when the closure is made; a ``degrade``
    controller's level overrides the parameters on every call;
    ``donate=True`` raises."""
    tidx = _carry(jax_index)
    q = torch.from_numpy(data[1])
    sp = cagra.SearchParams(**JSP)
    fn = cagra.make_searcher(tidx, sp, engine=engine, query_chunk=20)
    assert (tidx.edge_store is not None) == (engine != "gather")
    wd, wi = cagra.search(tidx, q, K, sp, engine=engine, query_chunk=20)
    d, i = fn(q, K)
    assert torch.equal(d, wd) and torch.equal(i, wi)
    assert cagra.make_searcher(tidx, donate="auto") is not None
    lvl = types.SimpleNamespace(
        params=lambda base: dataclasses.replace(base, itopk_size=32))
    fn = cagra.make_searcher(tidx, sp, degrade=lvl, engine=engine,
                             query_chunk=20)
    wd, wi = cagra.search(tidx, q, K, dataclasses.replace(sp, itopk_size=32),
                          engine=engine, query_chunk=20)
    d, i = fn(q, K)
    assert torch.equal(d, wd) and torch.equal(i, wi)
    with pytest.raises(RaftError, match="donate"):
        cagra.make_searcher(tidx, sp, donate=True)
