"""The port's host-memory tier (``raft_tpu_torch/neighbors/host_stream.py``
and ``prepare_host_stream`` / the streamed search of ``ivf_flat`` and
``ivf_pq``) against the JAX package's, run as its own tests run it
(``tests/test_quant_ladder.py::TestHostStream``).

Covered: ``probe_frequency``, ``plan_hot_cold`` and ``build_tier``'s
routing and chunks equal to JAX's (with and without a pinned chunk
shape); the plan of ``prepare_host_stream`` on a JAX-built index carried
over by ``convert`` equal to JAX's; the streamed IVF-Flat (float32, int8,
bfloat16; L2 and inner product) and IVF-PQ searches across two or more
chunks bit-equal to the port's resident searches, and filtered ones to
the resident searches under ``filter_policy.suspended()`` (also after a
filtered search filled the caches that the tier then drops, and with
every list cold); on JAX-built integer-valued IVF-Flat indexes the
streamed search equal to JAX's streamed search (``algo="pallas"`` in
interpret mode); IVF-PQ against JAX's resident ``algo="xla"`` search at
``lut_dtype=float32`` and JAX's streamed search with its chunk scan's
fallback forced (``faults.inject("kernel_compile", "ivf.host_stream")``);
the refusals (``save``, ``extend``, per-cluster codebooks), a budget
that holds everything, idempotence, ``hot_mask`` and
``RAFT_TPU_HBM_BUDGET_GB``.

Tolerances. Streamed against resident in the port: the same scan on the
same rows, so equal bit for bit. IVF-Flat against JAX on integer-valued
rows and queries: every distance is an exact float32 integer and both
packages break ties the same way (probe rank, then row, then part), so
values and ids are equal. IVF-PQ decodes through its codebooks and the
packages sum in other orders: ``assert_knn_close`` at
``tests/test_torch_ivf_pq.py``'s tolerance (rtol 1e-4, ids on >= 98% of
rows).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import faults as jfaults
from raft_tpu.neighbors import host_stream as jhs
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import host_stream as hs
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.ops import filter_policy
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)

N, D, M, K = 1500, 32, 16, 9


@pytest.fixture(scope="module")
def gauss():
    rng = np.random.default_rng(10)
    return (rng.normal(size=(N, D)).astype(np.float32),
            rng.normal(size=(M, D)).astype(np.float32))


@pytest.fixture(scope="module")
def ints():
    rng = np.random.default_rng(12)
    return (rng.integers(-4, 5, (N, D)).astype(np.float32),
            rng.integers(-4, 5, (M, D)).astype(np.float32))


def _carry_flat(j):
    return convert.ivf_flat_index_from_numpy(
        {"data": np.asarray(j.data), "data_norms": np.asarray(j.data_norms),
         "source_ids": np.asarray(j.source_ids),
         "centers": np.asarray(j.centers),
         "center_norms": np.asarray(j.center_norms),
         "list_offsets": j.list_offsets, "list_sizes_arr": j.list_sizes_arr,
         "metric": j.metric.value}, device="cpu")


def _carry_pq(j):
    return convert.ivf_pq_index_from_numpy(
        {"codes": np.asarray(j.codes), "source_ids": np.asarray(j.source_ids),
         "centers_rot": np.asarray(j.centers_rot),
         "codebooks": np.asarray(j.codebooks),
         "rotation": np.asarray(j.rotation),
         "list_offsets": j.list_offsets, "list_sizes_arr": j.list_sizes_arr,
         "metric": j.metric.value, "pq_bits": j.pq_bits,
         "codebook_kind": j.codebook_kind}, device="cpu")


def _same_routing(t, jt):
    assert np.array_equal(t.chunk_of, jt.chunk_of)
    assert np.array_equal(t.local_of, jt.local_of)
    assert (t.lmax, t.chunk_rows, t.chunk_lists, t.cold_rows,
            t.n_cold_lists, len(t.chunks)) == (
        jt.lmax, jt.chunk_rows, jt.chunk_lists, jt.cold_rows,
        jt.n_cold_lists, len(jt.chunks))
    for c, jc in zip(t.chunks, jt.chunks):
        assert np.array_equal(c.lists, jc.lists)
        assert np.array_equal(c.offsets, jc.offsets)
        assert np.array_equal(c.sizes, jc.sizes)


def _equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------- the plan
def test_probe_frequency_equals_jax():
    rng = np.random.default_rng(0)
    probed = rng.integers(-2, 40, (50, 7))
    assert np.array_equal(hs.probe_frequency(probed, 37),
                          jhs.probe_frequency(probed, 37))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("freq", [False, True])
@pytest.mark.parametrize("row_bytes", [1.5, 76, 520])
def test_plan_hot_cold_equals_jax(seed, freq, row_bytes):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 200, 64)
    sizes[rng.integers(0, 64, 5)] = 0
    f = rng.integers(0, 30, 64) if freq else None
    budget = int(sizes.sum() * row_bytes * rng.uniform(0.1, 0.9))
    assert np.array_equal(hs.plan_hot_cold(sizes, row_bytes, budget, f),
                          jhs.plan_hot_cold(sizes, row_bytes, budget, f))


@pytest.mark.parametrize("chunk_rows", [1, 100, 400, 5000])
@pytest.mark.parametrize("pin", [None, (600, 12, 300)])
def test_build_tier_equals_jax(chunk_rows, pin):
    rng = np.random.default_rng(chunk_rows)
    n_lists = 24
    sizes = rng.integers(0, 120, n_lists)
    caps = sizes + rng.integers(0, 9, n_lists)        # slack between lists
    offsets = np.zeros(n_lists + 1, np.int64)
    np.cumsum(caps, out=offsets[1:])
    data = rng.normal(size=(offsets[-1], 3)).astype(np.float32)
    ids = np.full(offsets[-1], -1, np.int32)
    for li in range(n_lists):
        ids[offsets[li]:offsets[li] + sizes[li]] = rng.integers(0, 10**6,
                                                                 sizes[li])
    hot = rng.random(n_lists) < 0.4
    jt, jhot, jho, jhsz = jhs.build_tier(
        {"data": data, "ids": ids}, offsets, sizes, hot, chunk_rows,
        fills={"ids": -1}, chunk_shape=pin)
    t, thot, tho, thsz = hs.build_tier(
        {"data": torch.from_numpy(data), "ids": torch.from_numpy(ids)},
        offsets, sizes, hot, chunk_rows, fills={"ids": -1}, chunk_shape=pin)
    _same_routing(t, jt)
    assert t.host_bytes == jt.host_bytes
    assert t.device_bytes_saved == jt.device_bytes_saved
    for c, jc in zip(t.chunks, jt.chunks):
        for name in ("data", "ids"):
            assert np.array_equal(c.arrays[name].numpy(), jc.arrays[name])
        assert np.array_equal(c.arrays["offsets"].numpy(), jc.offsets)
        assert np.array_equal(c.arrays["sizes"].numpy(), jc.sizes)
    assert np.array_equal(tho, jho) and np.array_equal(thsz, jhsz)
    for name in ("data", "ids"):
        assert np.array_equal(thot[name].numpy(), jhot[name])
    cold = np.flatnonzero(~hot)
    want = np.concatenate([ids[offsets[li]:offsets[li] + sizes[li]]
                           for li in cold] + [np.zeros(0, np.int32)])
    assert np.array_equal(t.cold_ids.numpy(), want)
    assert np.array_equal(t.cold_lists.numpy(), np.repeat(cold, sizes[cold]))
    probed = rng.integers(0, n_lists, (9, 5))
    for ci in range(len(t.chunks)):
        assert np.array_equal(t.local_probed(probed, ci),
                              jt.local_probed(probed, ci))
        assert np.array_equal(
            t.local_probed(torch.from_numpy(probed), ci).numpy(),
            jt.local_probed(probed, ci))
    assert np.array_equal(t.cold_probed(probed), jt.cold_probed(probed))


@pytest.mark.parametrize("sample", [False, True])
def test_prepare_plan_equals_jax(gauss, sample):
    """``prepare_host_stream`` on a JAX-built index carried over plans the
    same hot set and chunks as JAX's (JAX's row bytes: dim x 4 + 8)."""
    x, q = gauss
    jidx = jivf.build(x, jivf.IndexParams(n_lists=16))
    tidx = _carry_flat(jidx)
    kw = dict(budget_gb=90e3 / (1 << 30), chunk_mb=0.06,
              sample_queries=q[:8] if sample else None, n_probes=5)
    jivf.prepare_host_stream(jidx, **kw)
    ivf_flat.prepare_host_stream(tidx, **kw)
    _same_routing(tidx.host_tier, jidx._host_tier)
    assert np.array_equal(tidx.list_offsets, jidx.list_offsets)
    assert np.array_equal(tidx.list_sizes, jidx.list_sizes_arr)
    assert np.array_equal(tidx.source_ids.numpy(),
                          np.asarray(jidx.source_ids))


# ------------------------------------------------- streamed against resident
FLAT_CASES = [("float32", "sqeuclidean", 90e3), ("int8", "sqeuclidean", 30e3),
              ("bfloat16", "sqeuclidean", 40e3),
              ("float32", "inner_product", 90e3)]


@pytest.mark.parametrize("store,metric,budget", FLAT_CASES)
def test_flat_streamed_equals_resident(gauss, store, metric, budget):
    x, q = gauss
    params = ivf_flat.IndexParams(n_lists=16, dtype=store, metric=metric)
    res = ivf_flat.build(x, params, device="cpu")
    idx = ivf_flat.build(x, params, device="cpu")
    sp = ivf_flat.SearchParams(n_probes=5)
    filt = Bitset.from_mask(torch.from_numpy(
        np.random.default_rng(3).random(N) < 0.3))
    ivf_flat.search(idx, q, K, sp, filter=filt)        # fills the caches
    ivf_flat.prepare_host_stream(idx, budget_gb=budget / (1 << 30),
                                 sample_queries=q[:8], chunk_mb=0.03)
    tier = idx.host_tier
    assert tier.n_cold_lists > 0 and len(tier.chunks) >= 2
    assert "_filter_list_labels" not in idx.__dict__
    assert "_source_inverse" not in idx.__dict__
    _equal(ivf_flat.search(res, q, K, sp), ivf_flat.search(idx, q, K, sp))
    assert tier.streamed_chunks >= 2
    with filter_policy.suspended():
        want = ivf_flat.search(res, q, K, sp, filter=filt)
    _equal(want, ivf_flat.search(idx, q, K, sp, filter=filt))
    # chunked queries, and each chunk scanned twice
    _equal(ivf_flat.search(res, q, K, sp, query_chunk=5),
           ivf_flat.search(idx, q, K, sp, query_chunk=5))
    tier.passes = 2
    _equal(ivf_flat.search(res, q, K, sp), ivf_flat.search(idx, q, K, sp))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
@pytest.mark.parametrize("lut", ["float32", "bfloat16", "int8"])
def test_pq_streamed_equals_resident(gauss, metric, lut):
    x, q = gauss
    params = ivf_pq.IndexParams(n_lists=16, pq_dim=8, metric=metric)
    res = ivf_pq.build(x, params, device="cpu")
    idx = ivf_pq.build(x, params, device="cpu")
    sp = ivf_pq.SearchParams(n_probes=5, lut_dtype=lut)
    ivf_pq.prepare_host_stream(idx, budget_gb=20e3 / (1 << 30),
                               chunk_mb=0.003)
    assert len(idx.host_tier.chunks) >= 2
    _equal(ivf_pq.search(res, q, K, sp), ivf_pq.search(idx, q, K, sp))
    filt = Bitset.from_mask(torch.from_numpy(
        np.random.default_rng(4).random(N) < 0.2))
    with filter_policy.suspended():
        want = ivf_pq.search(res, q, K, sp, filter=filt)
    _equal(want, ivf_pq.search(idx, q, K, sp, filter=filt))


def test_every_list_cold(gauss):
    """A budget of one byte leaves no list resident: the search is the
    chunks' alone."""
    x, q = gauss
    res = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16), device="cpu")
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16), device="cpu")
    ivf_flat.prepare_host_stream(idx, budget_gb=1 / (1 << 30),
                                 chunk_mb=0.05)
    assert idx.size == 0 and idx.host_tier.cold_rows == N
    sp = ivf_flat.SearchParams(n_probes=5)
    _equal(ivf_flat.search(res, q, K, sp), ivf_flat.search(idx, q, K, sp))


# --------------------------------------------------- against the JAX package
@pytest.mark.parametrize("sample", [False, True])
def test_flat_streamed_equals_jax_streamed(ints, sample):
    x, q = ints
    jidx = jivf.build(x, jivf.IndexParams(n_lists=16))
    tidx = _carry_flat(jidx)
    kw = dict(budget_gb=60e3 / (1 << 30), chunk_mb=0.05,
              sample_queries=q[:8] if sample else None, n_probes=5)
    jivf.prepare_host_stream(jidx, **kw)
    ivf_flat.prepare_host_stream(tidx, **kw)
    assert len(tidx.host_tier.chunks) >= 2
    sp = jivf.SearchParams(n_probes=5)
    jd, ji = jivf.search(jidx, jnp.asarray(q), K, sp, algo="pallas")
    td, ti = ivf_flat.search(tidx, q, K, ivf_flat.SearchParams(n_probes=5))
    assert np.array_equal(td.numpy(), np.asarray(jd))
    assert np.array_equal(ti.numpy(), np.asarray(ji))


def test_pq_streamed_against_jax(gauss):
    x, q = gauss
    jidx = jpq.build(x, jpq.IndexParams(n_lists=16, pq_dim=8))
    jsp = jpq.SearchParams(n_probes=5, lut_dtype=jnp.float32)
    rd, ri = jpq.search(jidx, jnp.asarray(q), K, jsp, algo="xla")
    tidx = _carry_pq(jidx)
    kw = dict(budget_gb=20e3 / (1 << 30), chunk_mb=0.01)
    jpq.prepare_host_stream(jidx, **kw)
    ivf_pq.prepare_host_stream(tidx, **kw)
    _same_routing(tidx.host_tier, jidx._host_tier)
    td, ti = ivf_pq.search(tidx, q, K, ivf_pq.SearchParams(
        n_probes=5, lut_dtype="float32"))
    assert_knn_close(torch.from_numpy(np.asarray(rd)),
                     torch.from_numpy(np.asarray(ri)), td, ti, rtol=1e-4,
                     min_rows_equal=0.98)
    with jfaults.inject("kernel_compile", "ivf.host_stream"):
        sd, si = jpq.search(jidx, jnp.asarray(q), K, jsp, algo="xla")
    assert_knn_close(torch.from_numpy(np.asarray(sd)),
                     torch.from_numpy(np.asarray(si)), td, ti, rtol=1e-4,
                     min_rows_equal=0.98)


# --------------------------------------------------------------- refusals
def test_no_op_budget_and_idempotence(gauss, tmp_path):
    x, q = gauss
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16), device="cpu")
    data = idx.data
    ivf_flat.prepare_host_stream(idx, budget_gb=1.0)
    assert idx.host_tier is None and idx.data is data
    ivf_flat.prepare_host_stream(idx, hot_mask=np.ones(16, bool))
    assert idx.host_tier is None
    with pytest.raises(RaftError, match="hot_mask"):
        ivf_flat.prepare_host_stream(idx, hot_mask=np.ones(15, bool))
    ivf_flat.save(idx, tmp_path / "before.idx")
    ivf_flat.prepare_host_stream(idx, budget_gb=40e3 / (1 << 30))
    tier = idx.host_tier
    assert tier is not None
    ivf_flat.prepare_host_stream(idx, budget_gb=1e-9)
    assert idx.host_tier is tier
    with pytest.raises(RaftError, match="host-streamed"):
        ivf_flat.save(idx, tmp_path / "after.idx")
    with pytest.raises(RaftError, match="host-streamed"):
        ivf_flat.extend(idx, x[:4])
    hot = np.zeros(16, bool)
    hot[:3] = True
    idx2 = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16), device="cpu")
    ivf_flat.prepare_host_stream(idx2, hot_mask=hot)
    assert np.array_equal(idx2.host_tier.chunk_of < 0,
                          hot | (idx2.host_tier.chunk_of < 0) & ~hot
                          & (np.asarray(ivf_flat.build(
                              x, ivf_flat.IndexParams(n_lists=16),
                              device="cpu").list_sizes) == 0))


def test_extend_refused_as_jax_drops_the_cold_rows(gauss):
    """The JAX package's ``extend`` of a streamed index keeps only the
    resident lists (its cold rows are gone from the result); the port
    refuses the call."""
    x, _ = gauss
    jidx = jivf.build(x, jivf.IndexParams(n_lists=16))
    jivf.prepare_host_stream(jidx, budget_gb=40e3 / (1 << 30))
    assert jivf.extend(jidx, x[:100]).size < N
    tidx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16), device="cpu")
    ivf_flat.prepare_host_stream(tidx, budget_gb=40e3 / (1 << 30))
    with pytest.raises(RaftError, match="extend"):
        ivf_flat.extend(tidx, x[:100])


def test_pq_refusals(gauss, tmp_path):
    """Per-cluster codebooks are refused (the JAX package's tier fails on
    them); a streamed IVF-PQ index refuses save and extend."""
    x, _ = gauss
    pc = ivf_pq.build(x, ivf_pq.IndexParams(
        n_lists=16, pq_dim=8, codebook_kind=ivf_pq.CodebookGen.PER_CLUSTER),
        device="cpu")
    with pytest.raises(RaftError, match="per-cluster"):
        ivf_pq.prepare_host_stream(pc, budget_gb=20e3 / (1 << 30))
    jpc = jpq.build(x, jpq.IndexParams(
        n_lists=16, pq_dim=8, codebook_kind=jpq.CodebookGen.PER_CLUSTER))
    with pytest.raises(Exception):
        jpq.prepare_host_stream(jpc, budget_gb=20e3 / (1 << 30))
    idx = ivf_pq.build(x, ivf_pq.IndexParams(n_lists=16, pq_dim=8),
                       device="cpu")
    ivf_pq.prepare_host_stream(idx, budget_gb=20e3 / (1 << 30))
    with pytest.raises(RaftError, match="host-streamed"):
        ivf_pq.save(idx, tmp_path / "pq.idx")
    with pytest.raises(RaftError, match="host-streamed"):
        ivf_pq.extend(idx, x[:4])


@pytest.mark.parametrize("raw", ["", "0.5", "2", "abc", "1e-3"])
def test_budget_bytes_env(monkeypatch, raw):
    monkeypatch.setenv("RAFT_TPU_HBM_BUDGET_GB", raw)
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        b = hs.budget_bytes()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert b == jhs.budget_bytes()
    assert (raw == "abc") == any(issubclass(w.category, RuntimeWarning)
                                 for w in got)
    assert hs.budget_bytes(0.25) == jhs.budget_bytes(0.25) == 1 << 28


def test_prepare_reads_the_env_budget(gauss, monkeypatch):
    x, _ = gauss
    idx = ivf_flat.build(x, ivf_flat.IndexParams(n_lists=16), device="cpu")
    monkeypatch.delenv("RAFT_TPU_HBM_BUDGET_GB", raising=False)
    with pytest.raises(RaftError, match="budget"):
        ivf_flat.prepare_host_stream(idx)
    monkeypatch.setenv("RAFT_TPU_HBM_BUDGET_GB", "not-a-number")
    with pytest.warns(RuntimeWarning, match="RAFT_TPU_HBM_BUDGET_GB"):
        with pytest.raises(RaftError, match="budget"):
            ivf_flat.prepare_host_stream(idx)
    monkeypatch.setenv("RAFT_TPU_HBM_BUDGET_GB", str(40e3 / (1 << 30)))
    ivf_flat.prepare_host_stream(idx)
    assert idx.host_tier is not None
