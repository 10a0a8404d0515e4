"""The port's sharded search (``raft_tpu_torch.parallel``) against the JAX
package's, on CPU shards.

Sharded brute force: the port over ``Mesh(["cpu"] * 8)`` against JAX's
``sharded_knn.search(..., algo="scan")`` on the 8-device CPU mesh, with n
not divisible by p and k above the last shard's row count, on
integer-valued data, where every distance is exact: ids and distances
equal, for every merge engine and on every shard's copy.

Sharded IVF-Flat and IVF-PQ: indexes built by JAX's ``sharded_ann`` over
4 CPU devices, carried over shard by shard with
``convert.sharded_ivf_*_from_numpy`` and searched by both packages
(JAX's default merge on the CPU, allgather; the port's with each engine),
plain, filtered, and with a shard marked failed under
``allow_partial``. Gaussian data: IVF-Flat to the ``assert_knn_close``
contract (distances to rtol 1e-5, ids equal on >= 99% of rows: XLA and
torch sum in other orders); IVF-PQ at a float32 LUT to rtol 1e-4 and ids
on >= 98% of rows (expanded against residual form, as in
``test_torch_ivf_pq.py``; the bf16 LUTs differ by design). The filters
keep every list alive, so the port's zero-survivor prune and JAX's
sharded scan of such lists cannot part.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from ann_utils import naive_knn
from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.core.errors import ShardsDownError as JaxShardsDown
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.parallel import sharded_ann as jsa
from raft_tpu.parallel import sharded_knn as jsk
from raft_tpu_torch import convert
from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import ShardsDownError
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.ops import ring_topk
from raft_tpu_torch.parallel import sharded_ann, sharded_knn
from raft_tpu_torch.stats.metrics import neighborhood_recall
from test_torch_kernels import assert_knn_close
from test_torch_slice import _clustered

torch.set_num_threads(1)

N, D, M, K, N_LISTS, N_PROBES, P4 = 2400, 16, 40, 10, 8, 3, 4


def _check_replicas(ds, gs, want_d, want_i):
    for d, g in zip(ds, gs):
        np.testing.assert_array_equal(d.numpy(), want_d)
        np.testing.assert_array_equal(g.numpy(), want_i)


@pytest.fixture
def copies(monkeypatch):
    """What every ``ring_topk.merge`` call returned: its merged copies, one
    per shard (a sharded search returns the first shard's)."""
    seen, merge = [], ring_topk.merge

    def tap(*args, **kwargs):
        seen.append(merge(*args, **kwargs))
        return seen[-1]

    monkeypatch.setattr(ring_topk, "merge", tap)
    return seen


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_sharded_knn_matches_jax(multichip_mesh, copies, metric):
    rng = np.random.default_rng(5)
    x = rng.integers(-3, 4, (58, 8)).astype(np.float32)  # shards 8 x 7 + 2
    q = rng.integers(-3, 4, (12, 8)).astype(np.float32)
    k = 6
    jidx = jsk.build(x, multichip_mesh, metric)
    jd, ji = jsk.search(jidx, q, k, algo="scan")
    jd, ji = np.asarray(jd), np.asarray(ji)
    tidx = sharded_knn.build(x, Mesh(["cpu"] * 8), metric)
    assert tidx.shard_rows == jidx.shard_rows == 8
    assert tidx.shards[-1].size == 2 < k
    for eng in ring_topk.ENGINES:
        d, i = sharded_knn.search(tidx, q, k, merge_engine=eng)
        ds, gs = copies[-1]
        assert d is ds[0] and i is gs[0]
        _check_replicas(ds, gs, jd, ji)
    d, i = sharded_knn.search(tidx, q, k)
    assert ring_topk.active_engines["knn"] == "allgather"
    np.testing.assert_array_equal(i.numpy(), ji)


def test_sharded_knn_empty_shards_and_dryrun():
    """More shards than row blocks: the empty shards pad; the answer is
    the single index's."""
    rng = np.random.default_rng(6)
    x = rng.integers(-3, 4, (10, 4)).astype(np.float32)
    idx = sharded_knn.build(x, Mesh(["cpu"] * 8))     # 2-row blocks
    assert idx.shards[5:] == [None] * 3
    _, ref = naive_knn(x, x, 2)
    d, i = sharded_knn.search(idx, x, 2, merge_engine="ring")
    assert (d[:, 0] == 0).all() and set(i[:, 0].tolist()) <= set(range(10))
    assert neighborhood_recall(i, torch.from_numpy(ref)) == 1.0
    assert "every merge engine" in sharded_knn.dryrun(4)


@pytest.fixture(scope="module")
def ivf_data():
    x, q = _clustered(N, M, D, 3)
    keep = np.random.default_rng(4).random(N) < 0.6
    return x, q, keep


@pytest.fixture(scope="module")
def mesh4():
    return JaxMesh(np.array(jax.devices()[:P4]), ("shard",))


def _carry_flat(j):
    return convert.sharded_ivf_flat_from_numpy(
        {"data": np.asarray(j.data), "data_norms": np.asarray(j.data_norms),
         "source_ids": np.asarray(j.source_ids),
         "centers": np.asarray(j.centers),
         "center_norms": np.asarray(j.center_norms),
         "offsets": np.asarray(j.offsets), "sizes": np.asarray(j.sizes),
         "n_total": j.n_total, "metric": j.metric.value},
        Mesh(["cpu"] * P4))


def _carry_pq(j):
    return convert.sharded_ivf_pq_from_numpy(
        {"codes": np.asarray(j.codes), "source_ids": np.asarray(j.source_ids),
         "centers_rot": np.asarray(j.centers_rot),
         "codebooks": np.asarray(j.codebooks),
         "rotations": np.asarray(j.rotations),
         "offsets": np.asarray(j.offsets), "sizes": np.asarray(j.sizes),
         "pq_bits": j.pq_bits, "codebook_kind": j.codebook_kind,
         "n_total": j.n_total, "metric": j.metric.value},
        Mesh(["cpu"] * P4))


FAMILIES = {
    "ivf_flat": dict(
        build=lambda x, mesh: jsa.build_ivf_flat(
            x, mesh, jivf.IndexParams(n_lists=N_LISTS, seed=0)),
        carry=_carry_flat,
        jsearch=lambda idx, q, **kw: jsa.search_ivf_flat(
            idx, q, K, jivf.SearchParams(n_probes=N_PROBES), **kw),
        tsearch=lambda idx, q, **kw: sharded_ann.search_ivf_flat(
            idx, q, K, ivf_flat.SearchParams(n_probes=N_PROBES), **kw),
        close=dict()),
    "ivf_pq": dict(
        build=lambda x, mesh: jsa.build_ivf_pq(
            x, mesh, jpq.IndexParams(n_lists=N_LISTS, pq_dim=8, seed=0)),
        carry=_carry_pq,
        jsearch=lambda idx, q, **kw: jsa.search_ivf_pq(
            idx, q, K, jpq.SearchParams(n_probes=N_PROBES,
                                        lut_dtype=jnp.float32), **kw),
        tsearch=lambda idx, q, **kw: sharded_ann.search_ivf_pq(
            idx, q, K, ivf_pq.SearchParams(n_probes=N_PROBES,
                                           lut_dtype=torch.float32), **kw),
        close=dict(rtol=1e-4, min_rows_equal=0.98)),
}


@pytest.fixture(scope="module")
def carried(mesh4, ivf_data):
    """family -> (JAX sharded index, the port's carried copy), built on
    first use."""
    cache = {}

    def get(family):
        if family not in cache:
            j = FAMILIES[family]["build"](ivf_data[0], mesh4)
            cache[family] = (j, FAMILIES[family]["carry"](j))
        return cache[family]

    return get


@pytest.mark.parametrize("case", ["plain", "filtered", "partial"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_sharded_ivf_matches_jax(carried, ivf_data, copies, family, case):
    f = FAMILIES[family]
    jidx, tidx = carried(family)
    _, q, keep = ivf_data
    assert [s.size for s in tidx.shards] == [N // P4] * P4
    jkw, tkw = {}, {}
    if case == "filtered":
        jkw["filter"] = JaxBitset.from_mask(jnp.asarray(keep))
        tkw["filter"] = Bitset.from_mask(torch.from_numpy(keep))
    if case == "partial":
        jidx.mark_shard_failed(2)
        tidx.mark_shard_failed(2)
        jkw["allow_partial"] = tkw["allow_partial"] = True
    try:
        jout = f["jsearch"](jidx, q, **jkw)
        outs = {}
        for eng in ring_topk.ENGINES:
            res = f["tsearch"](tidx, q, merge_engine=eng, **tkw)
            outs[eng] = res, copies[-1]
    finally:
        jidx.mark_shard_failed(2, ok=True)
        tidx.mark_shard_failed(2, ok=True)
    jd, ji = np.asarray(jout[0]), np.asarray(jout[1])
    ref = outs["allgather"][0]
    assert_knn_close(jd, ji, ref[0].numpy(), ref[1].numpy(), **f["close"])
    for res, (ds, gs) in outs.values():   # every engine, every copy: equal
        assert res[0] is ds[0] and res[1] is gs[0]
        _check_replicas(ds, gs, ref[0].numpy(), ref[1].numpy())
    ids = ref[1].numpy()
    if case == "filtered":
        assert keep[ids[ids >= 0]].all()
    if case == "partial":
        assert list(jout[2]) == list(ref[2]) == [True, True, False, True]
        assert not ((ids >= 2 * N // P4) & (ids < 3 * N // P4)).any()


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_shards_down(carried, ivf_data, family):
    f = FAMILIES[family]
    jidx, tidx = carried(family)
    q = ivf_data[1]
    tidx.mark_shard_failed(1)
    jidx.mark_shard_failed(1)
    try:
        with pytest.raises(ShardsDownError, match="allow_partial"):
            f["tsearch"](tidx, q)
        with pytest.raises(JaxShardsDown):
            f["jsearch"](jidx, q)
        for i in range(P4):
            tidx.mark_shard_failed(i)
        with pytest.raises(ShardsDownError, match="all 4 shards") as e:
            f["tsearch"](tidx, q, allow_partial=True)
        assert e.value.shards_ok == [False] * P4
    finally:
        for i in range(P4):
            tidx.mark_shard_failed(i, ok=True)
        jidx.mark_shard_failed(1, ok=True)


def test_port_build_global_ids(ivf_data):
    """The port's own sharded builds: every row once under its global id,
    and recall against exact search."""
    x, q, _ = ivf_data
    mesh = Mesh(["cpu"] * 3)
    _, ref = naive_knn(x, q, K)
    flat = sharded_ann.build_ivf_flat(x, mesh, ivf_flat.IndexParams(
        n_lists=N_LISTS))
    pq = sharded_ann.build_ivf_pq(x, mesh, ivf_pq.IndexParams(
        n_lists=N_LISTS, pq_dim=8))
    for idx in (flat, pq):
        ids = torch.cat([s.source_ids[s.source_ids >= 0]
                         for s in idx.shards])
        assert sorted(ids.tolist()) == list(range(N))
    _, fi = sharded_ann.search_ivf_flat(flat, q, K, ivf_flat.SearchParams(
        n_probes=N_LISTS))
    assert neighborhood_recall(fi, torch.from_numpy(ref)) == 1.0
    _, pi = sharded_ann.search_ivf_pq(pq, q, K, ivf_pq.SearchParams(
        n_probes=N_LISTS))
    assert neighborhood_recall(pi, torch.from_numpy(ref)) >= 0.5
