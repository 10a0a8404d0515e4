"""Low-precision corpus stores (bfloat16, int8, uint8, int4) of the PyTorch
port against the JAX package: K2's plain version against
``raft_tpu.ops.fused_knn.fused_knn`` (interpret mode) and
``brute_force.search(algo="matmul")``; brute force and IVF-Flat on
JAX-built indexes carried over by ``raft_tpu_torch.convert``; the port's
own builds; the bench's ``dtype``.

Tolerances.
- Integer-valued data (``test_torch_kernels.store_case``): every store
  holds the rows exactly at a scale of 1, so every product, dot and
  distance is exact in float32 on both sides: values and ids, and their
  order, equal.
- Gaussian data: the packages sum the dots in different orders (and JAX's
  IVF-Flat ``xla`` engine scales the row before the dot, the port after
  it), so distances agree to ``rtol=1e-5, atol=1e-5·max|d|`` and ids on
  at least 99% of the rows (``assert_knn_close``).
- The port's K3 against JAX's Pallas IVF-Flat scan, which rounds the
  query to bf16 for every low-precision store: JAX's own tolerance
  between its Pallas and XLA engines (``tests/test_ivf_flat.py``): ids
  equal on more than 97% of the slots, distances to ``rtol=atol=5e-2``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu import bench as jbench
from raft_tpu.core.errors import RaftError as JaxRaftError
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.ops.fused_knn import fused_knn as jax_fused_knn
from raft_tpu_torch import bench, convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.ops import fused_knn as tfk
from raft_tpu_torch.ops import quant as tq
from test_torch_kernels import assert_knn_close, store_case

torch.set_num_threads(1)

STORES = ("bfloat16", "int8", "uint8", "int4")
IVF_STORES = ("bfloat16", "int8", "uint8")
M, N, D, K = 32, 2000, 32, 10


def _np(t: torch.Tensor) -> np.ndarray:
    """A tensor's values as numpy; bfloat16 widened to float32."""
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def _jax_rows(stored: torch.Tensor):
    """The port's stored rows as the JAX array of the same dtype."""
    if stored.dtype == torch.bfloat16:
        return jnp.asarray(stored.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(stored.numpy())


def _check(jv, ji, tv, ti, exact: bool):
    jv, ji = np.asarray(jv), np.asarray(ji)
    tv, ti = tv.numpy(), ti.numpy()
    if exact:
        np.testing.assert_array_equal(tv, jv)
        np.testing.assert_array_equal(ti, ji)
    else:
        assert_knn_close(jv, ji, tv, ti)


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("store", STORES)
def test_k2_plain_matches_jax_kernel(store, metric, integer):
    """K2's plain version on a store against the JAX kernel (interpret
    mode), both deriving the dequantized norms themselves."""
    x, sc, dim4, q = store_case(store, integer, N, D, M, 1)
    jv, ji = jax_fused_knn(jnp.asarray(q.numpy()), _jax_rows(x), K,
                           metric=metric,
                           scales=None if sc is None else jnp.asarray(
                               sc.numpy()),
                           int4_dim=dim4, interpret=True)
    tv, ti = tfk.fused_knn(q, x, K, metric, scales=sc, int4_dim=dim4)
    assert ti.dtype == torch.int32
    _check(jv, ji, tv, ti, integer)


def _jax_index(store: str, x: np.ndarray, metric="sqeuclidean"):
    return jbf.build(jnp.asarray(x), metric, dtype=store)


def _carry_bf(jidx) -> brute_force.Index:
    arrays = {"dataset": np.asarray(jidx.dataset), "metric": jidx.metric,
              "logical_dim": jidx.logical_dim}
    for f in ("norms", "scales"):
        if getattr(jidx, f) is not None:
            arrays[f] = np.asarray(getattr(jidx, f))
    return convert.brute_force_index_from_numpy(arrays, device="cpu")


def _source_rows(store: str, integer: bool, n=N, d=D, m=M, seed=2):
    """f32 source rows the store codes (:func:`store_case`'s, decoded) and
    queries, as numpy."""
    x, sc, dim4, q = store_case(store, integer, n, d, m, seed)
    return tq.dequantize_store(x, sc, dim4).numpy(), q.numpy()


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product",
                                    "cosine"])
@pytest.mark.parametrize("store", STORES)
def test_brute_force_on_jax_index(store, metric, integer):
    """A JAX-built index of each store, carried over, searched by the
    port (K2's plain version on the CPU) against JAX's matmul engine;
    with a filter on the integer rows."""
    x, q = _source_rows(store, integer)
    jidx = _jax_index(store, x, metric)
    tidx = _carry_bf(jidx)
    assert tidx.store_name == jidx.store_name and tidx.dim == jidx.dim
    jv, ji = jbf.search(jidx, q, K, algo="matmul")
    tv, ti = brute_force.search(tidx, q, K)
    _check(jv, ji, tv, ti, integer and metric != "cosine")
    if integer:
        from raft_tpu.core.bitset import Bitset as JaxBitset

        keep = np.random.default_rng(0).random(N) < 0.6
        jv, ji = jbf.search(jidx, q, K, algo="matmul",
                            filter=JaxBitset.from_mask(jnp.asarray(keep)))
        tv, ti = brute_force.search(tidx, q, K,
                                    filter=Bitset.from_mask(
                                        torch.from_numpy(keep)))
        _check(jv, ji, tv, ti, metric != "cosine")


@pytest.mark.parametrize("store", STORES)
def test_port_build_matches_jax_build(store):
    """``build(dtype=...)``: the same stored rows, scales, logical width
    and norms of the dequantized rows as JAX's ``build``; the same health
    report; the engines agree on the port's index."""
    x, q = _source_rows(store, False, seed=3)
    if store == "uint8":
        x = np.round(x)
    jidx = _jax_index(store, x)
    tidx = brute_force.build(x, "sqeuclidean", dtype=store, device="cpu")
    np.testing.assert_array_equal(_np(tidx.dataset),
                                  np.asarray(jidx.dataset, np.float32))
    assert tidx.dataset.dtype == tq.STORES[store]
    assert tidx.logical_dim == jidx.logical_dim
    assert (tidx.scales is None) == (jidx.scales is None)
    if jidx.scales is not None:
        np.testing.assert_array_equal(tidx.scales.numpy(),
                                      np.asarray(jidx.scales))
    np.testing.assert_allclose(tidx.norms.numpy(), np.asarray(jidx.norms),
                               rtol=1e-6)
    want = jbf.health(jidx)
    got = brute_force.health(tidx)
    assert got == {k: v for k, v in want.items() if k != "fused_cache"}
    mv, mi = brute_force.search(tidx, q, K, algo="matmul")
    av, ai = brute_force.search(tidx, q, K, algo="auto", query_chunk=7)
    assert torch.equal(mv, av) and torch.equal(mi, ai)


def test_int4_at_jax_shape():
    """JAX's own int4 case (tests/test_quant_ladder.py): (600, 100), 9
    queries, k = 7; the port's build and search against JAX's matmul and
    Pallas (interpret) engines: ids equal, distances to JAX's rtol=1e-5,
    atol=1e-4."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(600, 100)).astype(np.float32)
    q = rng.normal(size=(9, 100)).astype(np.float32)
    jidx = jbf.build(x, "sqeuclidean", dtype="int4")
    tidx = brute_force.build(x, "sqeuclidean", dtype="int4", device="cpu")
    assert tidx.store_name == "int4" and tidx.dim == 100
    assert tidx.dataset.shape == (600, tq.int4_half_width(100))
    tv, ti = brute_force.search(tidx, q, 7)
    for algo in ("matmul", "pallas"):
        jv, ji = jbf.search(jidx, q, 7, algo=algo)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-5,
                                   atol=1e-4)


def test_bf16_recall_floor():
    """JAX's floor for a bf16 store (tests/test_brute_force.py): recall@10
    above 0.95 against the exact float32 answer."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4000, 32)).astype(np.float32)
    q = rng.standard_normal((48, 32)).astype(np.float32)
    _, want = brute_force.search(brute_force.build(x, device="cpu"), q, 10)
    _, got = brute_force.search(brute_force.build(x, dtype="bfloat16",
                                                  device="cpu"), q, 10)
    hits = sum(len(set(a) & set(b)) for a, b in zip(got.tolist(),
                                                    want.tolist()))
    assert hits / want.numel() > 0.95


@pytest.mark.parametrize("store", STORES)
def test_convert_carries_every_store(store):
    """convert.py round trip: the carried index holds the JAX index's
    stored bits (bf16 as 16-bit words), scales, logical width and norms;
    without norms it derives them from the dequantized rows."""
    x, _ = _source_rows(store, False, seed=5)
    jidx = _jax_index(store, x)
    tidx = _carry_bf(jidx)
    raw = np.asarray(jidx.dataset)
    if store == "bfloat16":
        assert tidx.dataset.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tidx.dataset.view(torch.int16).numpy().view(np.uint16),
            raw.view(np.uint16))
        # the uint16 frame JAX's files use carries the same rows
        framed = convert.brute_force_index_from_numpy(
            {"dataset": raw.view(np.uint16), "metric": "sqeuclidean"},
            device="cpu")
        assert torch.equal(framed.dataset.view(torch.int16),
                           tidx.dataset.view(torch.int16))
    else:
        np.testing.assert_array_equal(tidx.dataset.numpy(), raw)
    np.testing.assert_array_equal(tidx.norms.numpy(), np.asarray(jidx.norms))
    derived = convert.brute_force_index_from_numpy(
        {"dataset": raw, "metric": "sqeuclidean",
         "scales": None if jidx.scales is None else np.asarray(jidx.scales),
         "logical_dim": jidx.logical_dim}, device="cpu")
    np.testing.assert_allclose(derived.norms.numpy(), np.asarray(jidx.norms),
                               rtol=1e-6)
    assert derived.store_name == store


# ------------------------------------------------------------ IVF-Flat --

def _ivf_data(store: str, integer: bool, n=3000, d=D, m=60, seed=6):
    return _source_rows(store, integer, n, d, m, seed)


def _jax_ivf(store: str, x: np.ndarray, n_lists=16):
    return jivf.build(jnp.asarray(x), jivf.IndexParams(
        n_lists=n_lists, seed=0, dtype=store))


def _carry_ivf(jidx) -> ivf_flat.Index:
    arrays = {f: np.asarray(getattr(jidx, f)) for f in (
        "data", "data_norms", "source_ids", "centers", "center_norms",
        "list_offsets", "list_sizes_arr")}
    if jidx.scales is not None:
        arrays["scales"] = np.asarray(jidx.scales)
    arrays["metric"] = jidx.metric
    return convert.ivf_flat_index_from_numpy(arrays, device="cpu")


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("store", IVF_STORES)
def test_ivf_flat_on_jax_index_matches_xla(store, integer):
    """A JAX-built IVF-Flat index of each store, carried over, searched at
    n_probes < n_lists by the port (K3's plain version) against JAX's
    ``algo="xla"`` engine."""
    x, q = _ivf_data(store, integer)
    jidx = _jax_ivf(store, x)
    tidx = _carry_ivf(jidx)
    assert tidx.store_name == store
    jv, ji = jivf.search(jidx, q, K, jivf.SearchParams(n_probes=5),
                         algo="xla")
    tv, ti = ivf_flat.search(tidx, q, K, ivf_flat.SearchParams(n_probes=5))
    _check(jv, ji, tv, ti, integer)


@pytest.mark.parametrize("store", IVF_STORES)
def test_ivf_flat_on_jax_index_near_jax_pallas(store):
    """The same against JAX's Pallas scan in interpret mode, which rounds
    the query to bf16, on JAX's own case (tests/test_ivf_flat.py: 20,000 x
    32 Gaussian rows, 100 queries, 64 lists, 16 probes, k = 8; for uint8
    the rows mapped onto bytes, the queries alike). bf16 and int8: JAX's
    own Pallas-vs-XLA tolerance. uint8: the query's rounding moves JAX's
    Pallas scan further from exact there (queries of magnitude ~128 lose
    ~0.25 a component), so the port is held where JAX's XLA engine is:
    its values equal XLA's, and its ids share exactly as many slots with
    the Pallas scan as XLA's do."""
    x = np.random.default_rng(7).standard_normal((20_000, 32)).astype(
        np.float32)
    q = np.random.default_rng(8).standard_normal((100, 32)).astype(
        np.float32)
    if store == "uint8":
        x = np.clip(np.round(x * 30 + 128), 0, 255)
        q = np.clip(np.round(q * 30 + 128), 0, 255)
    jidx = _jax_ivf(store, x, n_lists=64)
    tidx = _carry_ivf(jidx)
    jv, ji = jivf.search(jidx, q, 8, jivf.SearchParams(n_probes=16),
                         algo="pallas")
    tv, ti = ivf_flat.search(tidx, q, 8, ivf_flat.SearchParams(n_probes=16))
    shared = np.mean(ti.numpy() == np.asarray(ji))
    if store == "uint8":
        xv, xi = jivf.search(jidx, q, 8, jivf.SearchParams(n_probes=16),
                             algo="xla")
        np.testing.assert_array_equal(tv.numpy(), np.asarray(xv))
        assert shared == np.mean(np.asarray(xi) == np.asarray(ji))
        return
    assert shared > 0.97
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=5e-2,
                               atol=5e-2)


def test_ivf_flat_uint8_full_probe_equals_f32_oracle():
    """uint8 lists at n_probes = n_lists are exact: the same values and
    ids as float32 brute force over the same byte rows."""
    x, q = _ivf_data("uint8", True, seed=8)
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16, dtype="uint8"),
                         device="cpu")
    assert idx.data.dtype == torch.uint8 and idx.scales is None
    iv, ii = ivf_flat.search(idx, q, K, ivf_flat.SearchParams(n_probes=16))
    bv, bi = brute_force.search(brute_force.build(x, device="cpu"), q, K)
    assert torch.equal(iv, bv) and torch.equal(ii, bi)


@pytest.mark.parametrize("store", IVF_STORES)
def test_ivf_flat_build_reconstruct_health(store):
    """The port's ``build(IndexParams(dtype=...))``: each list row holds
    the codes (and the scale) of its source row, as ``quantize_rows``
    gives them, slack rows scale 1.0; ``reconstruct`` decodes them (bytes
    exactly) and refuses slack and out-of-range rows; ``health`` matches
    JAX's report of the same lists."""
    x, _ = _ivf_data(store, False, seed=9)
    if store == "uint8":
        x = np.round(x)
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16, dtype=store),
                         device="cpu")
    codes, scales = tq.quantize_rows(torch.from_numpy(x), store)
    ids = idx.source_ids.long()
    live = ids >= 0
    bits = (lambda t: t.view(torch.int16)  # noqa: E731
            if t.dtype == torch.bfloat16 else t)
    assert torch.equal(bits(idx.data[live]), bits(codes[ids[live]]))
    if scales is not None:
        assert torch.equal(idx.scales[live], scales[ids[live]])
        assert bool((idx.scales[~live] == 1.0).all())
    rows = torch.nonzero(live)[:50, 0]
    back = ivf_flat.reconstruct(idx, rows)
    want = tq.dequantize_rows(codes, scales)[ids[rows]]
    assert torch.equal(back, want)
    if store == "uint8":
        assert torch.equal(back, torch.from_numpy(x)[ids[rows]])
    with pytest.raises(RaftError):
        ivf_flat.reconstruct(idx, [idx.data.shape[0]])
    with pytest.raises(RaftError):
        ivf_flat.reconstruct(idx, torch.nonzero(~live)[:1, 0])
    jidx = _jax_ivf(store, x)
    want_h = jivf.health(jidx)
    got_h = ivf_flat.health(_carry_ivf(jidx))
    assert got_h == want_h


# --------------------------------------------------------------- bench --

def _bench_data(n=2000, d=16, m=40, seed=10):
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((m, d)).astype(np.float32)
    gt = np.argsort(((q[:, None, :] - base[None]) ** 2).sum(-1), axis=1,
                    kind="stable")[:, :10].astype(np.int32)
    return base, q, gt


@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "uint8"])
def test_bench_runs_each_store(dtype):
    """``run_benchmarks(dtype=...)`` for brute force and IVF-Flat: the JAX
    harness's names (the store in the tag) and brute force's recall equal
    to JAX's on the same inputs (uint8: both on the byte-grid remap)."""
    base, q, gt = _bench_data()
    algos = ("raft_brute_force", "raft_ivf_flat")
    kw = dict(k=10, algos=algos, reps=1, verbose=False, dtype=dtype)
    got = bench.run_benchmarks(base, q, gt, device="cpu", **kw)
    want = jbench.run_benchmarks(base, q, gt, **kw)
    assert [r.name for r in got] == [r.name for r in want]
    assert got[0].name == f"raft_brute_force.{dtype}"
    # the same hits; the two packages' float32 quotients may differ in
    # the last bit
    assert got[0].recall == pytest.approx(want[0].recall, abs=1e-6)
    if dtype != "uint8":
        assert got[0].recall > 0.9


def test_bench_int4_brute_force_only():
    base, q, gt = _bench_data()
    got = bench.run_benchmarks(base, q, gt, k=10,
                               algos=("raft_brute_force",), reps=1,
                               verbose=False, dtype="int4", device="cpu")
    assert [r.name for r in got] == ["raft_brute_force.int4"]
    with pytest.raises(RaftError, match="int4"):
        bench.run_benchmarks(base, q, gt, algos=("raft_ivf_flat",),
                             dtype="int4", device="cpu")


def test_byte_grid_matches_jax_remap():
    """The uint8 remap of a float corpus, bit for bit the JAX harness's
    numpy arithmetic (``raft_tpu/bench/runner.py``); a byte corpus passes
    through as it is; and the two guards raise in both packages."""
    base, q, gt = _bench_data(seed=11)
    mn, mx = float(base.min()), float(base.max())
    scale = 255.0 / max(mx - mn, 1e-30)
    want_b = np.round((base - mn) * scale).astype(np.float32)
    want_q = ((q - mn) * scale).astype(np.float32)
    got_b, got_q = bench.byte_grid(torch.from_numpy(base),
                                   torch.from_numpy(q), "sqeuclidean",
                                   ("raft_brute_force",))
    np.testing.assert_array_equal(got_b.numpy(), want_b)
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    same_b, same_q = bench.byte_grid(torch.from_numpy(want_b),
                                     torch.from_numpy(q), "sqeuclidean",
                                     ("raft_cagra",))
    assert np.array_equal(same_b.numpy(), want_b)
    assert np.array_equal(same_q.numpy(), q)
    for metric, algo in (("cosine", "raft_brute_force"),
                         ("sqeuclidean", "raft_cagra")):
        with pytest.raises(JaxRaftError):
            jbench.run_benchmarks(base, q, gt, metric=metric, algos=(algo,),
                                  dtype="uint8", verbose=False)
        with pytest.raises(RaftError, match="uint8 on a float corpus"):
            bench.run_benchmarks(base, q, gt, metric=metric, algos=(algo,),
                                 dtype="uint8", device="cpu")
