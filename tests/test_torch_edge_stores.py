"""CAGRA's int4 and pq edge stores in the PyTorch port against
``raft_tpu.neighbors.cagra``: search over JAX's own stores, carried into
the port with ``convert.cagra_index_from_numpy(edge_store=...)``, with
JAX's random seed rows injected into the port's one draw
(``cagra._draw_seeds``), against JAX's ``search(engine="edge")`` (its
Pallas kernels in interpret mode, computed once a module: a pq edge
search costs seconds there); and the port's own stores by JAX's recall
contract (``tests/test_quant_ladder.py::TestRungRecall``).

The fixture is JAX's ``rung_setup``: 1,600 x 64 rows in 12 Gaussian
clusters, degree 24 from 36, 32 queries, k = 8.

Tolerances. Integer-valued data and queries over an int4 store, and a
pq store whose codebooks are integers with per-subspace absmax 127 (the
int8 table's scale 1): every score is exact, so ids and distances are
equal. Gaussian data: ``assert_knn_close`` (distances to rtol 1e-5, ids
on >= 99% of rows): the kernels' lanes sum a row in another order than
JAX's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_utils import naive_knn
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops import quant as jquant
from raft_tpu_torch import convert
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import cagra, refine
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops import cagra_fused as tcf
from raft_tpu_torch.ops import graph_expand as tge
from raft_tpu_torch.stats.metrics import neighborhood_recall
from test_torch_kernels import assert_knn_close

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

K = 8
# one plan for the parity searches, so each JAX store compiles once
JSP = dict(itopk_size=16, search_width=1, max_iterations=5)


@pytest.fixture(scope="module")
def rung_setup():
    rng = np.random.default_rng(7)
    cent = rng.normal(size=(12, 64)).astype(np.float32) * 3
    x = (cent[rng.integers(0, 12, 1600)]
         + rng.normal(size=(1600, 64))).astype(np.float32)
    q = (cent[rng.integers(0, 12, 32)]
         + rng.normal(size=(32, 64))).astype(np.float32)
    _, gt = naive_knn(x, q, K)
    ix = jcagra.build(x, jcagra.IndexParams(graph_degree=24,
                                            intermediate_graph_degree=36))
    return ix, x, q, gt


@pytest.fixture(scope="module")
def int_setup():
    """Integer-valued rows and queries with a JAX build (no covering
    set), its int4 store, and a pq store over integer codebooks."""
    rng = np.random.default_rng(9)
    x = rng.integers(-4, 5, (900, 64)).astype(np.float32)
    q = rng.integers(-4, 5, (24, 64)).astype(np.float32)
    ix = jcagra.build(x, jcagra.IndexParams(
        graph_degree=24, intermediate_graph_degree=36, seed_nodes=0))
    return ix, x, q, rng


def _jax_store(ix, store: str, rng=None, pq_dim: int = 16) -> dict:
    """JAX's edge store of ``store`` attached to ``ix``, as the numpy
    mapping ``convert`` takes. With ``rng`` a pq store gets integer
    codebooks with per-subspace absmax 127 and random codes."""
    ix.__dict__.pop("_edge_store", None)
    jcagra.prepare_traversal(ix, store, pq_dim=pq_dim)
    if store == "pq" and rng is not None:
        meta, ev, aux, gp, _ = ix._edge_store
        n, deg_p, _ = ev.shape
        degree = meta[1]
        books = rng.integers(-40, 41, (pq_dim, 256, 128 // pq_dim)).astype(
            np.float32)
        books[:, 0, 0] = 127.0
        codes = rng.integers(0, 256, (n, pq_dim)).astype(np.uint8)
        graph = np.asarray(ix.graph)
        vecs = np.zeros((n, deg_p, pq_dim), np.uint8)
        vecs[:, :degree] = codes[graph]
        norms = np.asarray(jquant.pq_decoded_norms(codes, books))
        aux = np.array(aux)
        aux[:, 1, :degree] = norms[graph]
        cbm, cbs = jquant.pq_int8_cb(jquant.pq_decode_table(books), pq_dim,
                                     256)
        assert (np.asarray(cbs) == 1.0).all()
        ix._edge_store = (meta, jnp.asarray(vecs), jnp.asarray(aux), gp,
                          (cbm, cbs))
    (tag, degree, _, _), ev, aux, gp, cbs = ix._edge_store
    out = dict(mode=tag, degree=degree, vecs=np.asarray(ev),
               aux=np.asarray(aux), gp=np.asarray(gp))
    if cbs is not None:
        out.update(cb_mat=np.asarray(cbs[0]), cb_scale=np.asarray(cbs[1]))
    return out


def _carry(ix, store=None):
    return convert.cagra_index_from_numpy(
        {"dataset": np.asarray(ix.dataset), "graph": np.asarray(ix.graph),
         "metric": ix.metric.value,
         "seed_nodes": (None if ix.seed_nodes is None
                        else np.asarray(ix.seed_nodes))},
        device="cpu", edge_store=store)


def _jax_draw(m, n_seeds, high, seed, device):
    r = jax.random.randint(jax.random.key(seed), (m, n_seeds), 0, high)
    return torch.from_numpy(np.array(r)).to(device)


def _jax_search(ix, q, store: str, rng=None) -> dict:
    """JAX's store (numpy) and JAX's edge search on it."""
    es = _jax_store(ix, store, rng)
    d, i = jcagra.search(ix, jnp.asarray(q), K, jcagra.SearchParams(**JSP),
                         engine="edge")
    return dict(store=es, d=np.asarray(d), i=np.asarray(i))


@pytest.fixture(scope="module")
def jax_refs(rung_setup):
    ix, _, q, _ = rung_setup
    return {s: _jax_search(ix, q, s) for s in ("int4", "pq")}


@pytest.fixture(scope="module")
def jax_int_refs(int_setup):
    ix, _, q, rng = int_setup
    return {s: _jax_search(ix, q, s, rng) for s in ("int4", "pq")}


def _port_search(ix, q, ref, engine, monkeypatch):
    monkeypatch.setattr(cagra, "_draw_seeds", _jax_draw)
    tix = _carry(ix, ref["store"])
    st = tix.edge_store
    assert st.mode == ref["store"]["mode"] and st.dim_p == 128
    td, ti = cagra.search(tix, torch.from_numpy(q), K,
                          cagra.SearchParams(**JSP), engine=engine)
    assert td.shape == (q.shape[0], K) and ti.dtype == torch.int32
    return td.numpy(), ti.numpy()


@pytest.mark.parametrize("store,engine", [("int4", "edge"),
                                          ("int4", "fused"),
                                          ("pq", "edge")])
def test_search_on_jax_store_matches_jax(rung_setup, jax_refs, store,
                                         engine, monkeypatch):
    ix, _, q, _ = rung_setup
    ref = jax_refs[store]
    td, ti = _port_search(ix, q, ref, engine, monkeypatch)
    assert_knn_close(ref["d"], ref["i"], td, ti)


@pytest.mark.parametrize("store,engine", [("int4", "edge"),
                                          ("int4", "fused"),
                                          ("pq", "edge")])
def test_search_on_jax_store_matches_jax_integer(int_setup, jax_int_refs,
                                                 store, engine, monkeypatch):
    ix, _, q, _ = int_setup
    ref = jax_int_refs[store]
    td, ti = _port_search(ix, q, ref, engine, monkeypatch)
    np.testing.assert_array_equal(ti, ref["i"])
    np.testing.assert_array_equal(td, ref["d"])


def test_carried_pq_codebook_is_the_table(jax_refs):
    """The compact codebook ``convert`` makes from JAX's decode table
    widens every code to the table's row, times its rescale."""
    es = jax_refs["pq"]["store"]
    st = convert._edge_store(es, "cpu")
    pq_dim, book, pq_len = st.cb.shape
    assert (pq_dim, st.cb.dtype) == (16, torch.int8) and book * pq_dim == \
        es["cb_mat"].shape[0]
    codes = torch.arange(book, dtype=torch.uint8)[:, None].repeat(1, pq_dim)
    dec = tge.widen_tile(codes, "pq", st.cb, st.cb_scale).numpy()
    tbl = es["cb_mat"].astype(np.float32) * es["cb_scale"]
    for s in range(pq_dim):
        np.testing.assert_array_equal(
            dec[:, s * pq_len:(s + 1) * pq_len],
            tbl[s * book:(s + 1) * book, s * pq_len:(s + 1) * pq_len])


def _refined_recall(tix, x, q, gt, engine="edge") -> float:
    """JAX's serving recipe: traverse at the store's precision with itopk
    96, width 2, 10 hops, return all 96, refine them exactly to k."""
    sp = cagra.SearchParams(itopk_size=96, search_width=2, max_iterations=10)
    _, cand = cagra.search(tix, torch.from_numpy(q), 96, sp, engine=engine)
    _, ids = refine.refine(torch.from_numpy(x), torch.from_numpy(q), cand, K,
                           device="cpu")
    return neighborhood_recall(ids, torch.from_numpy(gt))


def test_port_stores_track_int8(rung_setup):
    """JAX's ``test_low_rungs_track_int8`` on the port's own stores: the
    refined recall of int4 and pq at least 0.95 of int8's, int8's at
    least 0.9; and the store bytes shrink as JAX's do (pq codes at most
    a quarter of int8's rows)."""
    ix, x, q, gt = rung_setup
    tix = _carry(ix)
    recalls, nbytes = {}, {}
    for store in ("int8", "int4", "pq"):
        cagra.prepare_traversal(tix, store)
        st = tix.edge_store
        assert st.mode == store
        nbytes[store] = st.vecs.numel() * st.vecs.element_size()
        recalls[store] = _refined_recall(tix, x, q, gt)
    assert recalls["int8"] >= 0.9, recalls
    assert recalls["int4"] >= 0.95 * recalls["int8"], recalls
    assert recalls["pq"] >= 0.95 * recalls["int8"], recalls
    assert nbytes["int4"] <= nbytes["int8"]
    assert nbytes["pq"] * 4 <= nbytes["int8"], nbytes
    # int4's fused engine serves the same recipe with the same ids
    cagra.prepare_traversal(tix, "int4")
    assert _refined_recall(tix, x, q, gt, "fused") == recalls["int4"]


def test_pq_store_options(rung_setup):
    """pq_dim and the LUT type reach the store (a second call with other
    ones rebuilds it); pq_dim 64 at d = 64 is pq_len 2; an f32 LUT keeps
    the codebook and no scales; a pq_dim that does not divide dim_p is
    refused."""
    ix, x, q, gt = rung_setup
    tix = _carry(ix)
    cagra.prepare_traversal(tix, "pq")
    st = tix.edge_store
    assert st.vecs.shape == (1600, 32, 16) and st.vecs.dtype == torch.uint8
    assert st.cb.shape == (16, 256, 8) and st.cb_scale.shape == (16,)
    cagra.prepare_traversal(tix, "pq")
    assert tix.edge_store is st                     # the same geometry
    cagra.prepare_traversal(tix, "pq", pq_dim=64, pq_lut="f32")
    st = tix.edge_store
    assert st.vecs.shape[2] == 64 and st.cb.dtype == torch.float32
    assert st.cb_scale is None and st.cb.shape == (64, 256, 2)
    assert _refined_recall(tix, x, q, gt) >= 0.85
    with pytest.raises(RaftError, match="must divide"):
        cagra.prepare_traversal(tix, "pq", pq_dim=48)


def test_fused_engine_on_pq_store_raises(rung_setup):
    """K6 has no pq form: an explicit fused search on a pq store raises
    (JAX rewrites it to its edge engine), and so does the wrapper."""
    ix, _, q, _ = rung_setup
    tix = _carry(ix)
    cagra.prepare_traversal(tix, "pq")
    with pytest.raises(RaftError, match="no pq form"):
        cagra.search(tix, torch.from_numpy(q), K, engine="fused")
    st = tix.edge_store
    buf = torch.zeros((4, 16))
    with pytest.raises(RaftError, match="no pq form"):
        tcf.fused_traverse(torch.from_numpy(q[:4]), buf, buf.int(), st.vecs,
                           st.aux, st.gp, itopk=16, width=1, max_iter=1,
                           kprime=16, degree=24, mode="pq")


def test_tune_search_leaves_fused_out_for_pq(rung_setup, monkeypatch):
    """``tune_search(store_dtype="pq")`` races gather and edge only, as
    JAX's does; at int4 the fused engine runs in the race."""
    monkeypatch.setattr(autotune, "_MEM_CACHE", {})
    ix, _, q, _ = rung_setup
    tix = _carry(ix)
    sp = cagra.SearchParams(itopk_size=16, max_iterations=4)
    qq = torch.from_numpy(q[:8])
    _, times = cagra.tune_search(tix, qq, K, sp, reps=1, store_dtype="pq")
    assert set(times) == {"gather", "edge"}
    _, times = cagra.tune_search(tix, qq, K, sp, reps=1, store_dtype="int4")
    assert set(times) == {"gather", "edge", "fused"}


def test_pq_store_tracks_jax_codebooks_on_overlapping_clusters():
    """``chip_smoke.py``'s kind of data at a small scale (128-dim rows in
    50 overlapping Gaussian clusters, unit-normal centers, spread
    1.0-1.6), where a pq store's recall falls far below int8's: on the
    same graph, the port's own pq store (its codebooks from
    ``torch.Generator``'s init) reaches JAX's recipe recall with JAX's
    own codebooks carried over, within 0.03 — the shortfall is the
    store's, not the port's training."""
    rng = np.random.default_rng(12)
    centers = rng.standard_normal((50, 128)).astype(np.float32)
    spread = rng.uniform(1.0, 1.6, 50).astype(np.float32)

    def rows(k):
        lab = rng.integers(0, 50, k)
        return (rng.standard_normal((k, 128)).astype(np.float32)
                * spread[lab, None] + centers[lab])

    x, q = rows(6000), rows(120)
    _, gt = naive_knn(x, q, K)
    tix = cagra.build(x, cagra.IndexParams(intermediate_graph_degree=96,
                                           graph_degree=48,
                                           knn_graph_algo="brute"),
                      device="cpu")
    jix = jcagra.Index(jnp.asarray(x), jnp.asarray(tix.graph.numpy()),
                       jcagra.DistanceType.L2Expanded)
    jstore = _jax_store(jix, "pq")
    cagra.prepare_traversal(tix, "pq")
    port = _refined_recall(tix, x, q, gt)
    tix.edge_store = convert._edge_store(jstore, "cpu")
    jax_books = _refined_recall(tix, x, q, gt)
    assert port >= jax_books - 0.03, (port, jax_books)
