"""Kernel K3 (IVF-Flat list scan + per-query merge) and the coarse probe
of the PyTorch port against ``raft_tpu.ops.ivf_scan`` (the Pallas scan
in interpret mode).

Tolerances: integer-valued inputs are exact in float32, so values and
row ids (and their order) must be equal; Gaussian inputs use the contract
of ``test_torch_kernels.assert_knn_close`` (distances to
``rtol=1e-5, atol=1e-5·max|d|``, ids equal on >= 99% of rows), because
XLA and torch sum the dot products in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.ops.ivf_scan import coarse_probe as jax_coarse_probe
from raft_tpu.ops.ivf_scan import ivf_flat_scan as jax_ivf_flat_scan
from raft_tpu.ops.ivf_scan import pack_pairs as jax_pack_pairs
from raft_tpu_torch import convert
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.ops import ivf_scan as tis
from test_torch_kernels import assert_knn_close, assert_knn_sets_close
from test_torch_slice import _clustered

torch.set_num_threads(1)

N, D, L, M, P, K = 2000, 32, 16, 64, 4, 10


def _layout(integer: bool, seed=0):
    """A cluster-sorted store: list l holds its rows at [offsets[l],
    offsets[l] + sizes[l]), starts aligned to 8 with slack in between,
    one list empty; plus queries and their probed lists."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, L, N)
    labels[labels == 3] = 4                       # list 3 stays empty
    sizes = np.bincount(labels, minlength=L)
    caps = (sizes + 8 + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]])
    rows = int(caps.sum())
    if integer:
        data = rng.integers(-3, 4, (rows, D)).astype(np.float32)
        q = rng.integers(-3, 4, (M, D)).astype(np.float32)
    else:
        data = rng.standard_normal((rows, D)).astype(np.float32)
        q = rng.standard_normal((M, D)).astype(np.float32)
    norms = (data.astype(np.float64) ** 2).sum(1).astype(np.float32)
    probed = np.stack([rng.permutation(L)[:P] for _ in range(M)])
    pen = np.where(rng.random(rows) < 0.25, np.inf, 0.0).astype(np.float32)
    return (data, norms, probed.astype(np.int32), offsets.astype(np.int32),
            sizes.astype(np.int32), q, pen)


def _both(arrays, metric, with_penalty):
    data, norms, probed, offsets, sizes, q, pen = arrays
    pen = pen if with_penalty else None
    jv, ji = jax_ivf_flat_scan(
        jnp.asarray(data), jnp.asarray(norms), jnp.asarray(probed),
        jnp.asarray(offsets), jnp.asarray(sizes), jnp.asarray(q), K,
        int(sizes.max()), metric=metric, interpret=True,
        penalty=None if pen is None else jnp.asarray(pen))
    t = torch.from_numpy
    tv, ti = tis.ivf_flat_scan(t(data), t(norms), t(probed), t(offsets),
                               t(sizes), t(q), K, metric=metric,
                               penalty=None if pen is None else t(pen))
    assert ti.dtype == torch.int32
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
def test_scan_matches_jax_kernel(metric, with_penalty):
    jv, ji, tv, ti = _both(_layout(False), metric, with_penalty)
    assert_knn_close(jv, ji, tv, ti)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_scan_integer_inputs_exact(metric):
    """Ties everywhere: equal values go to the lower probe rank, then the
    lower row, in both packages."""
    jv, ji, tv, ti = _both(_layout(True, 1), metric, True)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
def test_coarse_probe_matches(metric):
    rng = np.random.default_rng(2)
    centers = rng.integers(-3, 4, (64, D)).astype(np.float32)
    q = rng.integers(-3, 4, (M, D)).astype(np.float32)
    surv = rng.integers(0, 3, 64).astype(np.int32)
    for survivors in (None, surv):
        jp = jax_coarse_probe(
            jnp.asarray(q), jnp.asarray(centers), 8, metric,
            survivors=None if survivors is None else jnp.asarray(survivors))
        tp = tis.coarse_probe(
            torch.from_numpy(q), torch.from_numpy(centers), 8, metric,
            survivors=None if survivors is None
            else torch.from_numpy(survivors))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _probes(kind: str, m=300, p=6, lists=40, seed=7):
    """(m, p) distinct probed lists a query: uniform draws, or skewed —
    list 5 probed by every query, list 9 by one, lists 30 and up by
    none."""
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        return np.stack([rng.permutation(lists)[:p] for _ in range(m)])
    others = np.array([c for c in range(30) if c not in (5, 9)])
    probed = np.stack([np.concatenate(
        [[5], rng.permutation(others)[:p - 1]]) for _ in range(m)])
    probed[0, 1] = 9
    return probed


@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_pack_pairs_matches_jax(kind):
    """The port's grouping against the JAX package's at its 128 queries a
    group: the same sorted pair order, and for each live group tile the
    same list, first sorted pair and count of pairs (JAX's ``flat`` puts
    sorted pair i in slot group·128 + lane)."""
    probed = _probes(kind).astype(np.int32)
    m, p = probed.shape
    _, jlist, jalive, flat, jorder, n_groups = jax_pack_pairs(
        jnp.asarray(probed), 40)
    glist, gstart, gcount, order = tis.pack_pairs(torch.from_numpy(probed),
                                                  40, 128)
    assert glist.shape == (n_groups,) and order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), np.asarray(jorder))
    group_of = np.asarray(flat) // 128
    live = np.asarray(jalive)
    np.testing.assert_array_equal(gcount.numpy() > 0, live)
    for g in np.nonzero(live)[0]:
        at = np.nonzero(group_of == g)[0]
        assert (int(glist[g]), int(gstart[g]), int(gcount[g])) == (
            int(np.asarray(jlist)[g]), int(at.min()), len(at))


@pytest.mark.parametrize("qg", [1, 7, 64, 128, 300])
@pytest.mark.parametrize("kind", ["uniform", "skewed"])
def test_pack_pairs_covers_every_pair_once(kind, qg):
    """At any group size: every pair in exactly one live group tile of its
    own list, at most ``qg`` to a tile, a list's tiles back to back in
    the sorted order, and the static bound of tiles."""
    probed = _probes(kind)
    m, p = probed.shape
    glist, gstart, gcount, order = (t.numpy() for t in tis.pack_pairs(
        torch.from_numpy(probed.astype(np.int32)), 40, qg))
    assert len(glist) == -(-m * p // qg) + 40
    assert gcount.max() <= qg and gcount.min() >= 0
    seen = np.zeros(m * p, np.int64)
    flat = probed.reshape(-1)
    live = np.nonzero(gcount)[0]
    for g in live:
        pairs = order[gstart[g]:gstart[g] + gcount[g]]
        seen[pairs] += 1
        assert (flat[pairs] == glist[g]).all()
    assert (seen == 1).all()
    assert sorted(np.sort(order)) == list(range(m * p))
    # tiles in sorted order: each starts where the last one ended
    np.testing.assert_array_equal(gstart[live][1:],
                                  (gstart[live] + gcount[live])[:-1])
    n_tiles = -(-np.bincount(flat, minlength=40) // qg)
    np.testing.assert_array_equal(np.bincount(glist[live], minlength=40),
                                  n_tiles)


# ---- the grouped forms past k = 256 ----

@pytest.mark.parametrize("k,form", [(1, "group"), (256, "group"),
                                    (257, "group"), (512, "group"),
                                    (513, "group"), (1024, "group")])
def test_scan_form_by_k(k, form):
    """K3 and K4 take the grouped form at every k (its k-list plans up to
    GROUP_MAX_K = 512, its wide plan past it, as the JAX kernels take any
    k); ``check_form`` keeps the per-pair form reachable by name up to
    PAIR_MAX_K = 1024 and refuses it past that, and the grouped form is
    taken by name at every k."""
    assert tis.GROUP_MAX_K == 512 and tis.PAIR_MAX_K == 1024
    assert tis.scan_form(k) == form
    assert tis.check_form(None, k) == form
    assert tis.check_form("pair", k) == "pair"
    assert tis.check_form("group", k) == "group"
    assert tis.check_form("group", 16 * k) == "group"
    with pytest.raises(RaftError):
        tis.check_form("pair", tis.PAIR_MAX_K + k)
    with pytest.raises(RaftError):
        tis.check_form("rows", k)


def test_group_queries_follow_the_plans():
    """The group size both wrappers hand ``pack_pairs`` (and the kernels
    check): 128 queries up to k = 64, 64 up to 256, 32 up to 512, with
    the plans' warp queue (32·R keys) holding k and a buffer that one fold
    takes (CAP <= 32·R); past 512 the wide plan, 32 queries and no
    k-list, at every k; no plan at k <= 0."""
    for k in range(1, tis.GROUP_MAX_K + 1):
        bm, r, cap = tis.group_plan(k)
        assert tis.group_queries(k) == bm
        assert bm == (128 if k <= 64 else 64 if k <= 256 else 32)
        assert k <= 32 * r and cap <= 32 * r and bm % 32 == 0
    for k in (tis.GROUP_MAX_K + 1, 1024, 1025, 2048, 16_500, 10**6):
        assert tis.group_plan(k) == (32, 0, 0)
        assert tis.group_queries(k) == 32
    with pytest.raises(RaftError):
        tis.group_plan(0)


@pytest.mark.parametrize("d", [32, 100, 128, 256])
@pytest.mark.parametrize("kernel,store", [
    ("ivf_flat_scan", "float32"), ("ivf_flat_scan", "bfloat16"),
    ("ivf_flat_scan", "int8"), ("ivf_flat_scan", "uint8"),
    ("ivf_pq_scan", "float32")])
def test_group_plans_fit_shared_memory(kernel, store, d):
    """For every k up to GROUP_MAX_K a grouped block's layout (the k-lists
    and buffers, the side arrays, the query tile and the ring) fits in a
    block's 232,448 bytes of shared memory; the bytes are stated by hand
    here for the plan past 256 at k = 512: K3's (32 queries, 128-key
    buffers, query tile resident where it fits) and K4's own (32 queries,
    no k-lists: three side slots, the pairs' key ranges, the tiles or the
    warps' 64 KB of selection space, whichever is larger, with room for
    two blocks an SM at these widths)."""
    for k in range(1, tis.GROUP_MAX_K + 1):
        smem, a_res, ns = tis.group_smem(kernel, k, d, store)
        assert 0 < smem <= 232_448 and a_res in (0, 1, 2) and ns >= 2, k
    nk = -(-d // 32)
    smem, a_res, ns = tis.group_smem(kernel, 512, d, store)
    if kernel == "ivf_pq_scan":
        fixed = 3 * 2 * 128 * 4 + 6 * 32 * 4 + 2 * nk * 32 * 4
        tiles = (a_res * nk * 32 * 32 * 4
                 + ns * ((0 if a_res else 32 * 32 * 4) + 32 * 128 * 4))
        assert a_res == 2 and ns == 2
        assert smem == max(tiles, 65_536) + fixed
        assert smem + 128 <= 115_712
        return
    lists = 8 * 32 * (512 + 128) + 4 * 32
    raw = store != "float32"
    fixed = lists + 4 * (3 if raw else 2) * 128 * 4 + 2 * 32 * 4
    stage = 32 * 128 * {"float32": 4, "bfloat16": 2}.get(store, 1)
    assert smem == (a_res * nk * 32 * 32 * 4
                    + ns * ((0 if a_res else 32 * 32 * 4) + stage) + fixed)


@pytest.mark.parametrize("d", [32, 100, 128, 256, 1024])
@pytest.mark.parametrize("kernel,store", [
    ("ivf_flat_scan", "float32"), ("ivf_flat_scan", "bfloat16"),
    ("ivf_flat_scan", "int8"), ("ivf_flat_scan", "uint8"),
    ("ivf_pq_scan", "float32")])
def test_wide_plans_fit_shared_memory(kernel, store, d):
    """Past GROUP_MAX_K (K4: past 256) the wide plan's layout does not
    depend on k: the same bytes at 513, 1024 and 16,500. Stated by hand
    here: the tiles (query tile split into its TF32 parts, resident or
    streamed; K3 a ring of 3 stages then 2, K4 of 2) or the warps' 64 KB
    of selection space, whichever is larger, beside K3's four side slots
    and the group's pairs and queries (K4's three side slots, pairs,
    queries, norms, key ranges and the columns' subspaces); the first
    layout with room for two blocks an SM (115,712 bytes with the 128
    static ones), else one."""
    nk = -(-d // 32)
    raw = store != "float32"
    stage_b = 32 * 128 * {"float32": 4, "bfloat16": 2}.get(store, 1)
    if kernel == "ivf_pq_scan":
        fixed = 3 * 2 * 128 * 4 + 6 * 32 * 4 + 2 * nk * 32 * 4
        stages = (2,)
    else:
        fixed = 4 * (3 if raw else 2) * 128 * 4 + 2 * 32 * 4
        stages = (3, 2)
    want = None
    for limit in (115_712, 232_448):
        for a_res in (2, 1, 0):
            for ns in stages:
                tiles = max(a_res * nk * 32 * 32 * 4
                            + ns * ((0 if a_res else 32 * 32 * 4)
                                    + stage_b), 65_536)
                if want is None and tiles + fixed + 128 <= limit:
                    want = (tiles + fixed, a_res, ns)
    assert want is not None
    first = tis.GROUP_MAX_K + 1 if kernel == "ivf_flat_scan" else 257
    for k in (first, 1024, 16_500):
        assert tis.group_smem(kernel, k, d, store) == want, k
    if d <= 256:
        assert want[0] + 128 <= 115_712   # two blocks an SM


@pytest.fixture(scope="module")
def carried_ivf():
    """A JAX-built IVF-Flat index (4,000 rows of 32 dims in 32 lists) and
    its queries, carried into the port by ``convert``."""
    x, q = _clustered(4000, 64, D, 3)
    jidx = jivf.build(jnp.asarray(x), jivf.IndexParams(n_lists=32, seed=0))
    tidx = convert.ivf_flat_index_from_numpy(
        {"data": np.asarray(jidx.data),
         "data_norms": np.asarray(jidx.data_norms),
         "source_ids": np.asarray(jidx.source_ids),
         "centers": np.asarray(jidx.centers),
         "center_norms": np.asarray(jidx.center_norms),
         "list_offsets": jidx.list_offsets,
         "list_sizes_arr": jidx.list_sizes_arr,
         "metric": jidx.metric.value}, device="cpu")
    return jidx, tidx, q


@pytest.mark.parametrize("k,n_probes", [(257, 8), (512, 8), (512, 3)])
def test_plain_scan_wide_k_matches_jax_xla(carried_ivf, k, n_probes):
    """The plain K3 + merge at the grouped form's new widths, through
    ``ivf_flat.search`` on a JAX-built index, against JAX's exact
    ``algo="xla"`` engine: values slot by slot, ids as sets (near ties
    reorder ids over this many slots); with 3 probes of ~125 rows, fewer
    candidates than k: (+inf, -1) past them in both."""
    jidx, tidx, q = carried_ivf
    jv, ji = jivf.search(jidx, jnp.asarray(q), k,
                         jivf.SearchParams(n_probes=n_probes), algo="xla")
    tv, ti = ivf_flat.search(tidx, torch.from_numpy(q), k,
                             ivf_flat.SearchParams(n_probes=n_probes))
    assert tv.shape == (len(q), k) and ti.dtype == torch.int32
    assert_knn_sets_close(np.asarray(jv), np.asarray(ji), tv.numpy(),
                          ti.numpy())
    assert (ti.numpy() == -1).any() == (n_probes == 3)
