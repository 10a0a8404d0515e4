"""Dense pairwise distances (``distance/pairwise.py``), brute force's scan
engine for every metric, ``metric_arg`` and ``valid_rows``, and the
legacy header helpers of ``core/serialize.py``, in the PyTorch port
against the JAX package.

Inputs: non-negative rows (uniform in [0, 1) with a tenth of the cells
0, so that KL divergence, Jensen-Shannon, Hellinger, Canberra and
Bray-Curtis meet their zero branches, and Hamming its equal cells);
Haversine on (lat, lon) radians.

Tolerances. Distances to rtol 1e-5 with atol 1e-5·max|d| (the two
packages sum in different orders; the expanded forms cancel norms
against a cross term, so the absolute error follows the largest
distance), KL divergence and Jensen-Shannon to rtol 1e-4 (each term is
x·log(x/y) with log's float32 error, summed over d = 16 terms, and
Jensen-Shannon takes a square root of a difference of such sums). Brute
force: the same values slot by slot and ids equal on >= 99% of the rows
(:func:`test_torch_kernels.assert_knn_close`); where fewer rows are
admitted than k, the (worst, -1) slots equal. The header helpers and the
index files: byte-equal.
"""
import io
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import serialize as jser
from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.distance import pairwise as jpw
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch import convert
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import CorruptIndexError
from raft_tpu_torch.distance import pairwise
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.neighbors import brute_force
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)

N, D, M, K = 3000, 16, 40, 10
METRICS = sorted(m.value for m in
                 set(pairwise._EXPANDED) | pairwise._ELEMENTWISE)
LOOSE = {"kl_divergence": 1e-4, "jensenshannon": 1e-4}


def _rows(n, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, D)).astype(np.float32)
    x[rng.random((n, D)) < 0.1] = 0.0
    return x


@pytest.fixture(scope="module")
def data():
    return _rows(N, 0), _rows(M, 1)


def _close(got, want, rtol):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_metric_sets_match_jax():
    assert {m.value for m in pairwise._EXPANDED} == \
        {m.value for m in jpw._EXPANDED}
    assert {m.value for m in pairwise._ELEMENTWISE} == \
        {m.value for m in jpw._ELEMENTWISE}
    for shape in ((300, 3000, 16, 4), (7, 100, 128, 4), (5000, 8192, 512, 4)):
        for ws in (None, 1 << 20, 64 << 20):
            assert pairwise._tile_sizes(*shape, ws) == \
                jpw._tile_sizes(*shape, ws)


@pytest.mark.parametrize("metric", METRICS)
def test_pairwise_distance(data, metric):
    x, q = data
    want = jpw.pairwise_distance(jnp.asarray(q), jnp.asarray(x), metric, 3.0)
    got = pairwise.pairwise_distance(q, x, metric, 3.0, device="cpu")
    assert got.shape == (M, N) and got.dtype == torch.float32
    _close(got.numpy(), want, LOOSE.get(metric, 1e-5))


@pytest.mark.parametrize("metric", ["l1", "lp", "canberra",
                                    "jensenshannon"])
def test_pairwise_distance_tiled(data, metric):
    """A 1 MiB workspace cuts the elementwise engine into many tiles on
    both sides; the tiled result equals the one-block one's values."""
    x, q = data
    res = types.SimpleNamespace(workspace_bytes=1 << 20)
    tm, tn = pairwise._tile_sizes(300, N, D, 4, 1 << 20)
    assert tm < 300 and tn < N
    qq = _rows(300, 2)
    want = jpw.pairwise_distance(jnp.asarray(qq), jnp.asarray(x), metric,
                                 1.5, res=res)
    got = pairwise.pairwise_distance(qq, x, metric, 1.5, res=res,
                                     device="cpu")
    _close(got.numpy(), want, LOOSE.get(metric, 1e-5))
    one = pairwise.pairwise_distance(qq, x, metric, 1.5, device="cpu")
    torch.testing.assert_close(got, one, rtol=1e-6, atol=1e-6)


def test_haversine_and_distance_alias():
    rng = np.random.default_rng(3)
    a = rng.uniform(-1.5, 1.5, (50, 2)).astype(np.float32)
    b = rng.uniform(-1.5, 1.5, (70, 2)).astype(np.float32)
    _close(pairwise.distance(a, b, "haversine", device="cpu").numpy(),
           jpw.distance(jnp.asarray(a), jnp.asarray(b), "haversine"), 1e-5)
    with pytest.raises(Exception, match="2-D"):
        pairwise.pairwise_distance(a[:, :1], b[:, :1], "haversine",
                                   device="cpu")
    with pytest.raises(Exception, match="Precomputed"):
        pairwise.pairwise_distance(a, b, "precomputed", device="cpu")


@pytest.mark.parametrize("metric", METRICS + ["haversine"])
def test_brute_force_scan(data, metric):
    """``search(algo="scan")`` (and ``auto``, which takes the scan for
    every metric but K2's) against JAX's scan engine, tiles of 1,024
    rows (the last one short), k = 10."""
    x, q = data
    if metric == "haversine":
        x, q = x[:, :2] * 3 - 1.5, q[:, :2] * 3 - 1.5
    jv, ji = jbf.search(jbf.build(jnp.asarray(x), metric, metric_arg=3.0),
                        jnp.asarray(q), K, tile_size=1024, algo="scan")
    tidx = brute_force.build(x, metric, device="cpu", metric_arg=3.0)
    tv, ti = brute_force.search(tidx, q, K, algo="scan", tile_size=1024)
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy(),
                     rtol=LOOSE.get(metric, 1e-5))
    if brute_force.canonical_metric(metric) not in \
            brute_force._KERNEL_METRICS:
        av, ai = brute_force.search(tidx, q, K, tile_size=1024)
        assert torch.equal(av, tv) and torch.equal(ai, ti)


@pytest.mark.parametrize("metric", ["l1", "inner_product", "cosine"])
def test_brute_force_scan_filter_and_valid_rows(data, metric):
    """A filter and ``valid_rows`` together on the scan engine, with fewer
    admitted rows than k on some queries' tiles: values and ids equal to
    JAX's, (worst, -1) slots included."""
    x, q = data
    keep = np.random.default_rng(4).random(N) < 0.5
    kw = dict(tile_size=512, algo="scan", valid_rows=37)
    jv, ji = jbf.search(jbf.build(jnp.asarray(x), metric), jnp.asarray(q),
                        30, filter=JaxBitset.from_mask(jnp.asarray(keep)),
                        **kw)
    tv, ti = brute_force.search(brute_force.build(x, metric, device="cpu"),
                                q, 30, filter=Bitset.from_mask(
                                    torch.from_numpy(keep)), **kw)
    assert (np.asarray(ji) == -1).any()
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy())
    admitted = np.nonzero(keep[:37])[0]
    assert set(ti[ti >= 0].tolist()) <= set(admitted.tolist())


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_valid_rows_through_the_penalty_row(data, metric):
    """``valid_rows`` on the kernel engine (K2's plain version here) and
    the plain engine joins the penalty row: equal to JAX's matmul engine
    with ``valid_rows``."""
    x, q = data
    jv, ji = jbf.search(jbf.build(jnp.asarray(x), metric), jnp.asarray(q),
                        K, valid_rows=1234, algo="matmul")
    tidx = brute_force.build(x, metric, device="cpu")
    for algo in ("auto", "matmul"):
        tv, ti = brute_force.search(tidx, q, K, valid_rows=1234, algo=algo)
        assert int(ti.max()) < 1234
        assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                         ti.numpy())


def test_scan_on_stores(data):
    """The scan engine dequantizes each tile of a low-precision store as
    JAX's does (int8 rows, L1; bfloat16 rows, correlation)."""
    x, q = data
    for store, metric in (("int8", "l1"), ("bfloat16", "correlation")):
        jv, ji = jbf.search(jbf.build(jnp.asarray(x), metric, dtype=store),
                            jnp.asarray(q), K, algo="scan", tile_size=1024)
        tv, ti = brute_force.search(
            brute_force.build(x, metric, store, "cpu"), q, K, algo="scan",
            tile_size=1024)
        assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                         ti.numpy())


def test_knn_metric_arg(data):
    x, q = data
    jv, ji = jbf.knn(jnp.asarray(x), jnp.asarray(q), K, "minkowski", 1.5)
    tv, ti = brute_force.knn(x, q, K, "minkowski", device="cpu",
                             metric_arg=1.5)
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy())
    with pytest.raises(Exception, match="supports L2/cosine/IP"):
        brute_force.search(brute_force.build(x, "l1", device="cpu"), q, K,
                           algo="pallas")


@pytest.mark.parametrize("metric,arg", [("l1", 2.0), ("minkowski", 3.0),
                                        ("correlation", 2.0),
                                        ("sqeuclidean", 3.0)])
def test_brute_force_files_with_metric_arg(tmp_path, data, metric, arg):
    """A file of any metric and ``metric_arg``: the port's save of JAX's
    index carried over byte-equal to JAX's save; the port's own build's
    file read by JAX with both kept; JAX's file loaded by the port keeps
    both and searches like JAX."""
    x, q = data
    jidx = jbf.build(jnp.asarray(x), metric, metric_arg=arg)
    jbf.save(jidx, tmp_path / "j.idx")
    arrays = {"dataset": np.asarray(jidx.dataset), "metric": metric,
              "metric_arg": jidx.metric_arg}
    if jidx.norms is not None:
        arrays["norms"] = np.asarray(jidx.norms)
    brute_force.save(convert.brute_force_index_from_numpy(arrays,
                                                          device="cpu"),
                     tmp_path / "t.idx")
    assert (tmp_path / "t.idx").read_bytes() == \
        (tmp_path / "j.idx").read_bytes()
    brute_force.save(brute_force.build(x, metric, device="cpu",
                                       metric_arg=arg), tmp_path / "p.idx")
    back = jbf.load(tmp_path / "p.idx")
    assert back.metric_arg == arg and back.metric.value == \
        brute_force.canonical_metric(metric).value
    loaded = brute_force.load(tmp_path / "j.idx", device="cpu")
    assert loaded.metric is brute_force.canonical_metric(metric)
    assert loaded.metric_arg == arg
    jv, ji = jbf.search(jidx, jnp.asarray(q), K, algo="scan")
    tv, ti = brute_force.search(loaded, q, K, algo="scan")
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy())


META = {"metric": "l1", "metric_arg": 3.0, "n_lists": 7, "on": True,
        "store_dtype": "float32"}


def test_header_helpers_byte_equal():
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    jser.serialize_header(jbuf, "brute_force", 3, META)
    tser.serialize_header(tbuf, "brute_force", 3, META)
    assert tbuf.getvalue() == jbuf.getvalue()
    assert tbuf.getvalue().startswith(b"RAFT_TPU")
    for read in (tser.deserialize_header, jser.deserialize_header):
        got = read(io.BytesIO(tbuf.getvalue()), "brute_force")
        assert got == ("brute_force", 3, META)


def test_header_helpers_refuse():
    buf = io.BytesIO()
    tser.serialize_header(buf, "ivf_pq", 1, {})
    with pytest.raises(ValueError, match="expected index kind"):
        tser.deserialize_header(io.BytesIO(buf.getvalue()), "ivf_flat")
    with pytest.raises(CorruptIndexError, match="bad magic"):
        tser.deserialize_header(io.BytesIO(b"RAFTTPU2" + buf.getvalue()[8:]))
    with pytest.raises(CorruptIndexError, match="truncated"):
        tser.deserialize_header(io.BytesIO(buf.getvalue()[:12]))
    with pytest.raises(TypeError, match="unsupported meta"):
        tser.serialize_header(io.BytesIO(), "x", 1, {"a": [1]})


def test_build_keeps_norms_as_jax(data):
    """Norms only for the metrics whose distances read them (squared L2,
    L2, cosine), as JAX's build keeps them; ``metric_arg`` on the
    index."""
    x, _ = data
    for metric in ("sqeuclidean", "euclidean", "cosine", "inner_product",
                   "l1", "correlation"):
        t = brute_force.build(x, metric, device="cpu", metric_arg=1.5)
        j = jbf.build(jnp.asarray(x), metric, metric_arg=1.5)
        assert (t.norms is None) == (j.norms is None), metric
        assert t.metric_arg == j.metric_arg == 1.5
        assert t.metric is DistanceType(j.metric.value)
