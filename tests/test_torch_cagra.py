"""CAGRA in the PyTorch port against ``raft_tpu.neighbors.cagra``: the
exact kNN graph, ``optimize``, the edge store and the covering seed set
of the build; and search on a JAX-built index carried over with
``raft_tpu_torch.convert.cagra_index_from_numpy``, engine by engine
(gather with bf16 and float32 candidates, edge, fused), with the JAX
package's random seed rows injected into the port's one draw
(``cagra._draw_seeds``) so both traverse from the same buffer. The JAX
side runs its Pallas kernels in interpret mode; a filtered JAX search runs
under ``filter_policy.suspended()`` (the port has no adaptive policy).

Tolerances. The kNN graph (small-integer data: exact distances, ties to
the lower row in both) and ``optimize`` (integer detour counts) are equal;
so are the int8 and int4 edge stores, their aux and graph rows, and the
bf16 rows (the bf16 norms are float32 sums in another order: rtol 1e-6). Search on
integer-valued data and queries: ids and distances equal. On Gaussian
data: ``assert_knn_close`` (distances to rtol 1e-5, ids on >= 99% of
rows). The covering seed set draws its k-means from ``torch.Generator``,
so it is checked by its contract (sorted, unique, in range, the JAX size
rule) and the port's own build by recall: at least JAX's minus 0.02.
"""
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
from raft_tpu_torch.stats.metrics import neighborhood_recall
from test_torch_kernels import (ENGINE_TEST_BUILD, ENGINE_TEST_FLOOR,
                                ENGINE_TEST_SEARCH, assert_knn_close,
                                engine_test_data)

torch.set_num_threads(1)

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


def _search_both(jidx, tidx, q, engine, cdtype, keep=None, k=K):
    jf = tf = None
    if keep is not None:
        jf = JaxBitset.from_mask(jnp.asarray(keep))
        tf = Bitset.from_mask(torch.from_numpy(keep))
    with filter_policy.suspended():
        jd, ji = jcagra.search(jidx, jnp.asarray(q), k, jcagra.SearchParams(
            candidate_dtype=cdtype, **JSP), filter=jf, engine=engine)
    td, ti = cagra.search(tidx, torch.from_numpy(q), k, cagra.SearchParams(
        candidate_dtype=cdtype, **JSP), filter=tf, engine=engine)
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


@pytest.mark.parametrize("engine,cdtype", [("gather", "bfloat16"),
                                           ("edge", "int8"),
                                           ("fused", "int8")])
def test_search_matches_jax_filtered(data, jax_index, jax_seeds, engine,
                                     cdtype):
    """A 60% filter: survivor-aware seeding and the edge penalty."""
    keep = data[4]
    jd, ji, td, ti = _search_both(jax_index, _carry(jax_index), data[1],
                                  engine, cdtype, keep)
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
