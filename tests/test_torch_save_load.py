"""``save`` / ``load`` of the four families in the PyTorch port against the
JAX package's, store by store: brute force (float32, bfloat16, int8,
uint8, int4), IVF-Flat (float32, bfloat16, int8, uint8; the JAX and port
builds both leave slack between lists), IVF-PQ (pq_bits 4, 5 and 8, L2
and inner product) and CAGRA (with and without a seed set: files of
versions 2 and 1). For each:

- a JAX index carried over by ``convert`` and saved by the port gives a
  file byte-equal to the JAX package's ``save``;
- a JAX file loaded by the port searches like the JAX index;
- a port file loaded by the JAX package searches like the port index;
- a port file loaded back by the port on the CPU searches bit-equal.

Also ``pack_codes`` / ``unpack_codes`` against JAX's; files of the
metrics and ``metric_arg`` only the scan engine serves and of
PER_CLUSTER codebooks, loaded by the port; the refusals: a metric no
engine computes (at search, as JAX's), an unknown version, a wrong
kind.

Tolerances. Brute force, IVF-Flat and CAGRA run on integer-valued rows
and queries (``test_torch_kernels.store_case``; every store holds them
exactly), so every distance is exact in float32 on both sides: values
and ids equal (JAX: brute force ``algo="matmul"``, IVF-Flat
``algo="xla"``, CAGRA's gather engine at float32 candidates with JAX's
random seed rows injected). IVF-PQ decodes through its codebooks:
``assert_knn_close`` at ``tests/test_torch_ivf_pq.py``'s tolerance
(distances to rtol 1e-4, ids on >= 98% of the rows; JAX ``algo="xla"``
against the port, both with float32 LUTs). A round trip in the port is
bit-equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import convert
from raft_tpu_torch.core import serialize as ser
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.ops import quant as tq
from test_torch_kernels import assert_knn_close, store_case

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


N, D, M, K = 800, 32, 40, 5
N_LISTS, N_PROBES = 8, 3
BF_STORES = ("float32", "bfloat16", "int8", "uint8", "int4")
IVF_STORES = ("float32", "bfloat16", "int8", "uint8")


def _rows(store: str, seed: int = 2, n: int = N, d: int = D):
    """Integer-valued f32 rows the store holds exactly, and integer
    queries, as numpy (float32: bfloat16's, integers in [-8, 8])."""
    x, sc, dim4, q = store_case("bfloat16" if store == "float32" else store,
                                True, n, d, M, seed)
    return tq.dequantize_store(x, sc, dim4).numpy(), q.numpy()


def _bytes(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _equal(jv, ji, tv, ti) -> None:
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def _bits(a, b) -> None:
    """Two searches' (values, ids) equal bit for bit."""
    assert torch.equal(a[0].view(torch.int32), b[0].view(torch.int32))
    assert torch.equal(a[1], b[1])


# ------------------------------------------------------------ brute force

def _carry_bf(jidx) -> brute_force.Index:
    arrays = {"dataset": np.asarray(jidx.dataset), "metric": jidx.metric,
              "logical_dim": jidx.logical_dim}
    for f in ("norms", "scales"):
        if getattr(jidx, f) is not None:
            arrays[f] = np.asarray(getattr(jidx, f))
    return convert.brute_force_index_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("store", BF_STORES)
def test_brute_force(tmp_path, store, metric):
    x, q = _rows(store)
    jidx = jbf.build(jnp.asarray(x), metric, dtype=store)
    jbf.save(jidx, tmp_path / "jax.idx")
    brute_force.save(_carry_bf(jidx), tmp_path / "carried.idx")
    assert _bytes(tmp_path / "jax.idx") == _bytes(tmp_path / "carried.idx")

    loaded = brute_force.load(tmp_path / "jax.idx", device="cpu")
    assert loaded.store_name == store and loaded.dim == D
    jv, ji = jbf.search(jidx, q, K, algo="matmul")
    _equal(jv, ji, *brute_force.search(loaded, q, K))

    tidx = brute_force.build(x, metric, dtype=store, device="cpu")
    brute_force.save(tidx, tmp_path / "port.idx")
    want = brute_force.search(tidx, q, K)
    jl = jbf.load(tmp_path / "port.idx")
    assert jl.store_name == store
    _equal(*jbf.search(jl, q, K, algo="matmul"), *want)
    _bits(brute_force.search(brute_force.load(tmp_path / "port.idx",
                                              device="cpu"), q, K), want)


@pytest.mark.parametrize("metric,arg,match", [
    ("l1", 2.0, None), ("minkowski", 3.0, None),
    ("jaccard", 2.0, "unsupported by brute force")])
def test_brute_force_refuses_unported_metrics(tmp_path, metric, arg, match):
    """A file of any metric loads with its metric and ``metric_arg``
    unchanged: the scan engine's metrics search as JAX's scan does; a
    metric no engine computes (Jaccard, a set metric) raises at search,
    as in JAX: the metric is never changed silently."""
    x, q = _rows("float32", n=64)
    jidx = jbf.build(jnp.asarray(x), metric, metric_arg=arg)
    jbf.save(jidx, tmp_path / "j.idx")
    loaded = brute_force.load(tmp_path / "j.idx", device="cpu")
    assert loaded.metric.value == jidx.metric.value
    assert loaded.metric_arg == arg
    if match is None:
        # integer rows: the sums are exact; Minkowski's root may differ by
        # an ulp between XLA's pow and torch's
        jv, ji = jbf.search(jidx, q, K, algo="scan")
        tv, ti = brute_force.search(loaded, q, K)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        return
    with pytest.raises(RaftError, match=match):
        brute_force.search(loaded, q, K)
    with pytest.raises(Exception, match=match):
        jbf.search(jidx, q, K)


# ---------------------------------------------------------------- IVF-Flat

def _carry_ivf(jidx) -> ivf_flat.Index:
    arrays = {f: np.asarray(getattr(jidx, f)) for f in (
        "data", "data_norms", "source_ids", "centers", "center_norms",
        "list_offsets", "list_sizes_arr")}
    if jidx.scales is not None:
        arrays["scales"] = np.asarray(jidx.scales)
    arrays["metric"] = jidx.metric
    return convert.ivf_flat_index_from_numpy(arrays, device="cpu")


def _slack(offsets, sizes) -> int:
    return int(offsets[-1] - np.sum(sizes))


@pytest.mark.parametrize("store", IVF_STORES)
def test_ivf_flat(tmp_path, store):
    x, q = _rows(store, seed=3)
    sp = N_PROBES
    jidx = jivf.build(jnp.asarray(x), jivf.IndexParams(n_lists=N_LISTS,
                                                       seed=0, dtype=store))
    assert _slack(jidx.list_offsets, jidx.list_sizes) > 0
    jivf.save(jidx, tmp_path / "jax.idx")
    ivf_flat.save(_carry_ivf(jidx), tmp_path / "carried.idx")
    assert _bytes(tmp_path / "jax.idx") == _bytes(tmp_path / "carried.idx")

    loaded = ivf_flat.load(tmp_path / "jax.idx", device="cpu")
    assert loaded.store_name == store
    assert _slack(loaded.list_offsets, loaded.list_sizes) == 0
    jv, ji = jivf.search(jidx, q, K, jivf.SearchParams(n_probes=sp),
                         algo="xla")
    _equal(jv, ji, *ivf_flat.search(loaded, q, K,
                                    ivf_flat.SearchParams(n_probes=sp)))

    tidx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=N_LISTS,
                                                  dtype=store), device="cpu")
    assert _slack(tidx.list_offsets, tidx.list_sizes) > 0
    ivf_flat.save(tidx, tmp_path / "port.idx")
    want = ivf_flat.search(tidx, q, K, ivf_flat.SearchParams(n_probes=sp))
    jl = jivf.load(tmp_path / "port.idx")
    _equal(*jivf.search(jl, q, K, jivf.SearchParams(n_probes=sp),
                        algo="xla"), *want)
    back = ivf_flat.load(tmp_path / "port.idx", device="cpu")
    _bits(ivf_flat.search(back, q, K, ivf_flat.SearchParams(n_probes=sp)),
          want)
    # the file holds no slack: saved again, the same bytes
    ivf_flat.save(back, tmp_path / "again.idx")
    assert _bytes(tmp_path / "again.idx") == _bytes(tmp_path / "port.idx")


# ------------------------------------------------------------------ IVF-PQ

def _carry_pq(jidx) -> ivf_pq.Index:
    return convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(jidx.codes),
         "source_ids": np.asarray(jidx.source_ids),
         "centers_rot": np.asarray(jidx.centers_rot),
         "codebooks": np.asarray(jidx.codebooks),
         "rotation": np.asarray(jidx.rotation),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr,
         "metric": jidx.metric.value, "pq_bits": jidx.pq_bits,
         "codebook_kind": jidx.codebook_kind}, device="cpu")


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(11)
    return (rng.standard_normal((N, D)).astype(np.float32),
            rng.standard_normal((64, D)).astype(np.float32))


def _pq_search(tidx, q):
    return ivf_pq.search(tidx, torch.from_numpy(q), K, ivf_pq.SearchParams(
        N_PROBES, lut_dtype=torch.float32))


def _jpq_search(jidx, q):
    return jpq.search(jidx, jnp.asarray(q), K, jpq.SearchParams(
        N_PROBES, lut_dtype=jnp.float32), algo="xla")


def _close(a, b) -> None:
    assert_knn_close(np.asarray(a[0]), np.asarray(a[1]), np.asarray(b[0]),
                     np.asarray(b[1]), rtol=1e-4, min_rows_equal=0.98)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("pq_bits,pq_dim", [(4, 8), (5, 7), (8, 8)])
def test_ivf_pq(tmp_path, gauss, pq_bits, pq_dim, metric):
    x, q = gauss
    jidx = jpq.build(jnp.asarray(x), jpq.IndexParams(
        n_lists=N_LISTS, pq_bits=pq_bits, pq_dim=pq_dim, metric=metric,
        seed=0))
    jpq.save(jidx, tmp_path / "jax.idx")
    ivf_pq.save(_carry_pq(jidx), tmp_path / "carried.idx")
    assert _bytes(tmp_path / "jax.idx") == _bytes(tmp_path / "carried.idx")

    loaded = ivf_pq.load(tmp_path / "jax.idx", device="cpu")
    assert (loaded.pq_bits, loaded.pq_dim) == (pq_bits, pq_dim)
    _close(_jpq_search(jidx, q), _pq_search(loaded, q))

    tidx = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=N_LISTS, pq_bits=pq_bits, pq_dim=pq_dim, metric=metric),
        device="cpu")
    ivf_pq.save(tidx, tmp_path / "port.idx")
    want = _pq_search(tidx, q)
    _close(_jpq_search(jpq.load(tmp_path / "port.idx"), q), want)
    _bits(_pq_search(ivf_pq.load(tmp_path / "port.idx", device="cpu"), q),
          want)


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_pack_codes_matches_jax(pq_bits):
    rng = np.random.default_rng(pq_bits)
    codes = rng.integers(0, 1 << pq_bits, (37, 13)).astype(np.uint8)
    packed = ivf_pq.pack_codes(codes, pq_bits)
    want = jpq.pack_codes(codes, pq_bits)
    assert packed.dtype == np.uint8 and packed.shape == (37, -(-13 * pq_bits
                                                               // 8))
    np.testing.assert_array_equal(packed, want)
    np.testing.assert_array_equal(ivf_pq.unpack_codes(want, 13, pq_bits),
                                  codes)
    np.testing.assert_array_equal(jpq.unpack_codes(packed, 13, pq_bits),
                                  codes)


def test_ivf_pq_refuses_per_cluster(tmp_path, gauss):
    """A PER_CLUSTER file (ported since it was refused) loads as a
    per-cluster index: its codebooks (n_lists, book, pq_len), its file
    byte-equal when the port saves it again."""
    jidx = jpq.build(jnp.asarray(gauss[0]), jpq.IndexParams(
        n_lists=N_LISTS, pq_bits=4, pq_dim=8,
        codebook_kind=jpq.CodebookGen.PER_CLUSTER))
    jpq.save(jidx, tmp_path / "j.idx")
    loaded = ivf_pq.load(tmp_path / "j.idx", device="cpu")
    assert loaded.codebook_kind is ivf_pq.CodebookGen.PER_CLUSTER
    assert tuple(loaded.codebooks.shape) == (N_LISTS, 16, 4)
    ivf_pq.save(loaded, tmp_path / "t.idx")
    assert _bytes(tmp_path / "t.idx") == _bytes(tmp_path / "j.idx")


# ------------------------------------------------------------------- CAGRA

D0, DEG = 24, 16
CSP = dict(itopk_size=16, search_width=1, max_iterations=4,
           candidate_dtype="float32")


@pytest.fixture
def jax_seeds(monkeypatch):
    """Make the port draw the JAX package's random seed rows."""
    def draw(m, n_seeds, high, seed, device):
        r = jax.random.randint(jax.random.key(seed), (m, n_seeds), 0, high)
        return torch.from_numpy(np.array(r)).to(device)

    monkeypatch.setattr(cagra, "_draw_seeds", draw)


def _carry_cagra(jidx) -> cagra.Index:
    return convert.cagra_index_from_numpy(
        {"dataset": np.asarray(jidx.dataset), "graph": np.asarray(jidx.graph),
         "metric": jidx.metric.value,
         "seed_nodes": (None if jidx.seed_nodes is None
                        else np.asarray(jidx.seed_nodes))}, device="cpu")


def _cagra_search(tidx, q, engine="gather"):
    return cagra.search(tidx, torch.from_numpy(q), K,
                        cagra.SearchParams(**CSP), engine=engine)


def _jcagra_search(jidx, q):
    return jcagra.search(jidx, jnp.asarray(q), K, jcagra.SearchParams(**CSP),
                         engine="gather")


@pytest.mark.parametrize("seed_nodes,version", [(-1, 2), (0, 1)])
def test_cagra(tmp_path, jax_seeds, seed_nodes, version):
    x, q = _rows("float32", seed=5, n=1000, d=16)
    jidx = jcagra.build(jnp.asarray(x), jcagra.IndexParams(
        intermediate_graph_degree=D0, graph_degree=DEG, seed=0,
        seed_nodes=seed_nodes))
    assert (jidx.seed_nodes is None) == (seed_nodes == 0)
    jcagra.save(jidx, tmp_path / "jax.idx")
    cagra.save(_carry_cagra(jidx), tmp_path / "carried.idx")
    assert _bytes(tmp_path / "jax.idx") == _bytes(tmp_path / "carried.idx")
    assert ser.load_arrays(tmp_path / "jax.idx")[1] == version

    loaded = cagra.load(tmp_path / "jax.idx", device="cpu")
    _equal(*_jcagra_search(jidx, q), *_cagra_search(loaded, q))

    tidx = cagra.build(x, cagra.IndexParams(
        intermediate_graph_degree=D0, graph_degree=DEG,
        knn_graph_algo="brute", seed_nodes=seed_nodes), device="cpu")
    cagra.prepare_traversal(tidx)
    cagra.save(tidx, tmp_path / "port.idx")
    assert ser.load_arrays(tmp_path / "port.idx")[1] == version
    want = _cagra_search(tidx, q)
    _equal(*_jcagra_search(jcagra.load(tmp_path / "port.idx"), q), *want)
    back = cagra.load(tmp_path / "port.idx", device="cpu")
    assert back.edge_store is None and not back.build_stats
    _bits(_cagra_search(back, q), want)
    # the edge store is rebuilt from the loaded graph on first use
    _bits(_cagra_search(back, q, "edge"), _cagra_search(tidx, q, "edge"))


def test_cagra_load_canonicalizes_seeds(tmp_path):
    """Seeds in a file come back sorted, unique and int32, as JAX's load
    gives them."""
    x, _ = _rows("float32", n=64, d=8)
    graph = np.zeros((64, 4), np.int32)
    seeds = np.array([9, 3, 9, 1], np.int64)
    ser.save_arrays(tmp_path / "c.idx", "cagra", 2, {"metric":
                                                      "l2_expanded"},
                    {"dataset": x, "graph": graph, "seed_nodes": seeds})
    idx = cagra.load(tmp_path / "c.idx", device="cpu")
    assert idx.seed_nodes.dtype == torch.int32
    np.testing.assert_array_equal(idx.seed_nodes.numpy(), [1, 3, 9])
    np.testing.assert_array_equal(
        idx.seed_nodes.numpy(),
        np.asarray(jcagra.load(tmp_path / "c.idx").seed_nodes))


def test_fortran_ordered_frames_load_contiguous(tmp_path):
    """A file whose frames are Fortran-ordered (np.save writes them so for
    such arrays) loads as C-contiguous tensors, which the kernels need."""
    x, q = _rows("float32", n=64, d=8)
    graph = np.random.default_rng(1).integers(0, 64, (64, 4)).astype(
        np.int32)
    ser.save_arrays(tmp_path / "f.idx", "brute_force", 2,
                    {"metric": "l2_expanded", "metric_arg": 2.0,
                     "store_dtype": "float32"},
                    {"dataset": np.asfortranarray(x)})
    ser.save_arrays(tmp_path / "c.idx", "cagra", 1,
                    {"metric": "l2_expanded"},
                    {"dataset": np.asfortranarray(x),
                     "graph": np.asfortranarray(graph)})
    bidx = brute_force.load(tmp_path / "f.idx", device="cpu")
    cidx = cagra.load(tmp_path / "c.idx", device="cpu")
    for t, want in ((bidx.dataset, x), (cidx.dataset, x),
                    (cidx.graph, graph)):
        assert t.is_contiguous()
        np.testing.assert_array_equal(t.numpy(), want)
    assert bidx.norms is None or bidx.norms.is_contiguous()


# ---------------------------------------------------------------- refusals

@pytest.mark.parametrize("family,kind", [
    (brute_force, "brute_force"), (ivf_flat, "ivf_flat"),
    (ivf_pq, "ivf_pq"), (cagra, "cagra")])
def test_unknown_version_and_wrong_kind(tmp_path, family, kind):
    ser.save_arrays(tmp_path / "v.idx", kind, 9, {"metric": "l2_expanded"},
                    {})
    with pytest.raises(RaftError, match="unsupported"):
        family.load(tmp_path / "v.idx", device="cpu")
    other = "cagra" if kind != "cagra" else "ivf_pq"
    ser.save_arrays(tmp_path / "k.idx", other, 1, {}, {})
    with pytest.raises(ValueError, match="expected index kind"):
        family.load(tmp_path / "k.idx", device="cpu")
