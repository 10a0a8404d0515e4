"""The port's CUDA kernels against their plain PyTorch versions, and the
comparison contract the port's parity tests share.

This file imports neither JAX nor ``raft_tpu``, so it runs on a machine
with a card and no JAX. The card tests are marked ``cuda`` and skip
without one; on the card::

    python -m pytest tests/test_torch_kernels.py -m cuda --noconftest -q

(``--noconftest``: the suite's conftest imports JAX.)

Tolerances. Integer-valued inputs: every product and sum is exact in
float32, so values and ids, and their order, must be equal. Gaussian
inputs: the kernels, torch and XLA sum the dot products in different
orders, so distances agree to ``rtol=1e-5, atol=1e-5·max|d|`` and ids are
equal on at least 99% of rows (:func:`assert_knn_close`). K4 reads a
codebook of small integers in its integer cases, so its LUT entries and
sums stay exact in float32 and bfloat16. K5 and K6 and their plain
versions add in the same order (``graph_expand.lane_order_dot``), so they
are equal on any input: on an edge store of small integers with integer
scales (``edge_store``), where every score is an exact integer and ties
abound, and on Gaussian queries with real scales. K7 and K8 move values
and compute none, so they equal their plain versions (and
``knn_merge_parts``) on any input.
"""
import numpy as np
import pytest
import torch

from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.matrix import select_k as tsk
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors import cagra as tcagra
from raft_tpu_torch.ops import cagra_fused as tcf
from raft_tpu_torch.ops import fused_knn as tfk
from raft_tpu_torch.ops import graph_expand as tge
from raft_tpu_torch.ops import ivf_pq_scan as tpq
from raft_tpu_torch.ops import ivf_scan as tis
from raft_tpu_torch.ops import ring_topk as trt
from raft_tpu_torch.stats.metrics import neighborhood_recall

torch.set_num_threads(1)


def assert_knn_close(ref_v, ref_i, v, i, rtol=1e-5, min_rows_equal=0.99):
    """The Gaussian-input contract of the module docstring: distances to
    ``rtol`` and ``atol = rtol·max|d|``, ids equal on at least
    ``min_rows_equal`` of the rows. Values are compared slot by slot, so
    where the two ids at a slot differ, the two candidates' distances
    differ by less than the tolerance (a near tie)."""
    ref_v = np.asarray(ref_v, np.float64)
    v = np.asarray(v, np.float64)
    ref_i, i = np.asarray(ref_i), np.asarray(i)
    assert v.shape == ref_v.shape and i.shape == ref_i.shape
    finite = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(v), finite)
    np.testing.assert_array_equal(v[~finite], ref_v[~finite])
    np.testing.assert_array_equal(i[~finite], ref_i[~finite])
    atol = rtol * (np.abs(ref_v[finite]).max() if finite.any() else 1.0)
    np.testing.assert_allclose(v[finite], ref_v[finite], rtol=rtol,
                               atol=atol)
    rows_equal = (i == ref_i).all(axis=1)
    assert rows_equal.mean() >= min_rows_equal, (
        f"ids differ on {int((~rows_equal).sum())} of {len(rows_equal)} "
        "rows")


def need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels run only there")


def _ivf_store(integer: bool, seed: int, n=6000, d=40, lists=24, m=150,
               p=6):
    """Cluster-sorted rows with list starts aligned to 8, slack between
    lists, one empty list; queries, probed lists and a penalty row."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, lists, n)
    labels[labels == 3] = 4
    sizes = np.bincount(labels, minlength=lists)
    caps = (sizes + 8 + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps)[:-1]])
    rows = int(caps.sum())
    gen = ((lambda s: rng.integers(-3, 4, s)) if integer
           else rng.standard_normal)
    data = gen((rows, d)).astype(np.float32)
    q = gen((m, d)).astype(np.float32)
    norms = (data.astype(np.float64) ** 2).sum(1).astype(np.float32)
    probed = np.stack([rng.permutation(lists)[:p] for _ in range(m)])
    pen = np.where(rng.random(rows) < 0.25, np.inf, 0.0).astype(np.float32)
    return [torch.from_numpy(a) for a in
            (data, norms, probed.astype(np.int32), offsets.astype(np.int32),
             sizes.astype(np.int32), q, pen)]


def pq_store(integer: bool, seed: int, pq_bits: int = 8, n=4000, pq_dim=8,
             pq_len=4, lists=16, m=64, p=4):
    """A cluster-sorted PQ store: uint8 codes with list starts aligned to
    8, slack between lists, list 3 empty; a (pq_dim, 2^pq_bits, pq_len)
    codebook, rotated centers and queries (small integers or Gaussian),
    probed lists, a penalty row, and the decoded row norms. Returns a
    dict of CPU tensors plus ``list_offsets`` (lists + 1,) numpy."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, lists, n)
    labels[labels == 3] = 4
    sizes = np.bincount(labels, minlength=lists)
    caps = (sizes + 8 + 7) // 8 * 8
    offsets = np.concatenate([[0], np.cumsum(caps)])
    rows = int(offsets[-1])
    rot_dim = pq_dim * pq_len
    gen = ((lambda s: rng.integers(-3, 4, s)) if integer
           else rng.standard_normal)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    store = {
        "codes": t(rng.integers(0, 1 << pq_bits, (rows, pq_dim)).astype(
            np.uint8)),
        "codebooks": t(gen((pq_dim, 1 << pq_bits, pq_len)).astype(
            np.float32)),
        "centers_rot": t(gen((lists, rot_dim)).astype(np.float32)),
        "q_rot": t(gen((m, rot_dim)).astype(np.float32)),
        "probed": t(np.stack([rng.permutation(lists)[:p]
                              for _ in range(m)]).astype(np.int32)),
        "offsets": t(offsets[:-1].astype(np.int32)),
        "sizes": t(sizes.astype(np.int32)),
        "penalty": t(np.where(rng.random(rows) < 0.25, np.inf, 0.0).astype(
            np.float32)),
        "list_offsets": offsets,
    }
    store["row_norms"] = tpq.decoded_row_norms(
        store["codes"], store["centers_rot"], store["codebooks"], offsets)
    return store


def pq_scan_args(store, mode: str, device="cpu"):
    """The positional arguments of ``ivf_pq_scan`` up to ``q_rot``."""
    names = ("codes", "row_norms", "centers_rot", "codebooks", "probed",
             "offsets", "sizes", "q_rot")
    args = [store[n].to(device) for n in names]
    args[3] = tpq.lut_codebook(args[3], mode)
    return args


def edge_store(dtype, seed: int, integer: bool = True, n=3000, degree=40,
               deg_p=64, dim=100, m=96, itopk=32):
    """An edge store (CPU tensors): (n, deg_p, dim_p) rows of small
    integers (int8 or bf16), per-edge scales and the matching norms in
    ``aux``, padded graph rows, queries, an edge penalty (+inf on a
    quarter of the edges), parents, and a sorted seeded buffer (distinct
    ids, +inf tail). ``integer``: scales of 1 or 2 and integer queries,
    so every score is an exact integer; else Gaussian queries and
    uniform scales."""
    rng = np.random.default_rng(seed)
    dim_p = (dim + 127) // 128 * 128
    rows = np.zeros((n, deg_p, dim_p), np.float32)
    rows[:, :, :dim] = rng.integers(-3, 4, (n, deg_p, dim))
    if integer:
        scales = rng.integers(1, 3, (n, deg_p)).astype(np.float32)
        q = rng.integers(-3, 4, (m, dim)).astype(np.float32)
    else:
        scales = rng.uniform(0.2, 0.6, (n, deg_p)).astype(np.float32)
        q = rng.standard_normal((m, dim)).astype(np.float32)
    aux = np.stack([scales, scales ** 2 * (rows ** 2).sum(-1)], axis=1)
    gph = rng.integers(0, n, (n, deg_p)).astype(np.int32)
    pen = np.where(rng.random((n, deg_p)) < 0.25, np.inf, 0.0).astype(
        np.float32)
    if integer:
        buf_d = rng.integers(200, 900, (m, itopk)).astype(np.float32)
    else:   # around the candidates' scores: ||q||² + ~64 +- 25
        buf_d = ((q ** 2).sum(1)[:, None] + 64
                 + rng.uniform(-25, 25, (m, itopk))).astype(np.float32)
    buf_d = np.sort(buf_d, axis=1)
    buf_d[:, itopk - 3:] = np.inf
    buf_i = np.stack([rng.permutation(n)[:itopk] for _ in range(m)]).astype(
        np.int32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    return {"vecs": t(rows).to(dtype), "aux": t(aux), "gph": t(gph),
            "q": t(q), "pen": t(pen), "degree": degree,
            "parents": t(rng.integers(0, n, (m, 2)).astype(np.int32)),
            "buf_d": t(buf_d), "buf_i": t(buf_i)}


def test_kernel_entries_refuse_cpu_tensors():
    """The kernel-only entries launch or raise; they never run a plain
    version."""
    x = torch.zeros((8, 4))
    with pytest.raises(RaftError):
        tfk.fused_knn_candidates(x, None, x, None, None, 2, "ip")
    data, norms, probed, offsets, sizes, q, _ = _ivf_store(False, 0)
    with pytest.raises(RaftError):
        tis.ivf_flat_scan_candidates(data, norms, None, q, None, probed,
                                     offsets, sizes, 3, "l2")
    st = pq_store(False, 0)
    with pytest.raises(RaftError):
        tpq.ivf_pq_scan_candidates(
            st["codes"], st["row_norms"], None, st["codebooks"],
            st["centers_rot"], st["q_rot"], st["probed"], st["offsets"],
            st["sizes"], 3, "l2")
    es = edge_store(torch.int8, 0, n=50, m=4)
    with pytest.raises(RaftError):
        tge.graph_expand_kernel(es["parents"], es["q"], es["vecs"],
                                es["aux"], 4)
    with pytest.raises(RaftError):
        tcf.fused_traverse_kernel(es["q"], es["buf_d"], es["buf_i"],
                                  es["vecs"], es["aux"], es["gph"],
                                  itopk=32, width=1, max_iter=2, kprime=8,
                                  degree=40)
    ds, gs = ring_parts(4, 6, 5, 0)
    with pytest.raises(RaftError):
        trt.ring_topk_kernel(ds, gs, 5, True, Mesh(["cpu"] * 4))


def ring_parts(p, m, k, seed, select_min=True, integer=True,
               device="cpu"):
    """p shards' (m, k) candidate lists: rows sorted except shard 0's,
    shard 1 an exact copy of shard 0's values (cross-shard ties), shard 2
    dead — (±inf, -1) — when p > 2; integer values with ties inside rows,
    or Gaussian ones."""
    rng = np.random.default_rng(seed)
    d = (rng.integers(0, 20, (p, m, k)) if integer
         else rng.standard_normal((p, m, k))).astype(np.float32)
    d[1:] = np.sort(d[1:], axis=-1)
    d[1] = d[0]
    gid = rng.integers(0, 1 << 20, (p, m, k)).astype(np.int32)
    if p > 2:
        d[2], gid[2] = np.inf, -1
    if not select_min:
        d = -d
    return ([torch.from_numpy(d[r]).to(device) for r in range(p)],
            [torch.from_numpy(gid[r]).to(device) for r in range(p)])


@pytest.mark.parametrize("integer", [True, False])
def test_plain_versions_agree_on_cpu(integer):
    """The CPU paths the kernels are held against: the IVF scan's plain
    version over every list equals brute force over the same rows."""
    data, norms, probed, offsets, sizes, q, pen = _ivf_store(integer, 1)
    lists = offsets.shape[0]
    every = torch.arange(lists, dtype=torch.int32).expand(q.shape[0], -1)
    sv, si = tis.ivf_flat_scan(data, norms, every.contiguous(), offsets,
                               sizes, q, 7, "l2", pen)
    pen = pen.clone()
    valid = torch.zeros(data.shape[0], dtype=torch.bool)
    for o, s in zip(offsets.tolist(), sizes.tolist()):
        valid[o:o + s] = True
    pen[~valid] = float("inf")
    bv, bi = tfk.fused_knn(q, data, 7, "l2", norms, pen)
    if integer:
        assert torch.equal(sv, bv) and torch.equal(si, bi)
    else:
        assert_knn_close(bv, bi, sv, si)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [200, 1024, 20000])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_kernel_on_card(n, select_min):
    """K1 against its plain version: rows in shared memory (n <= 12288)
    and streamed from device memory (n = 20000), heavy ties, infinities."""
    need_cuda()
    rng = np.random.default_rng(n)
    x = rng.integers(0, 50, (300, n)).astype(np.float32)
    x[rng.random((300, n)) < 0.05] = np.inf if select_min else -np.inf
    x[5] = np.inf if select_min else -np.inf
    xc = torch.from_numpy(x).cuda()
    for k in (1, 20, 100):
        kv, ki = tsk.kpass_select_k(xc, k, select_min)
        pv, pi = tsk.select_k_plain(xc, k, select_min)
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
@pytest.mark.parametrize("m", [7, 200])
def test_fused_knn_kernel_on_card(metric, m):
    """K2 against its plain version, with the corpus split over blocks and
    merged by K1: exact on integer-valued inputs, close on Gaussian."""
    need_cuda()
    rng = np.random.default_rng(m)
    for integer in (True, False):
        gen = ((lambda s: rng.integers(-2, 3, s)) if integer
               else rng.standard_normal)
        q = torch.from_numpy(gen((m, 48)).astype(np.float32)).cuda()
        x = torch.from_numpy(gen((40000, 48)).astype(np.float32)).cuda()
        pen = torch.where(torch.rand(40000, device="cuda") < 0.2,
                          float("inf"), 0.0)
        for k in (1, 17, 100):
            kv, ki = tfk.fused_knn(q, x, k, metric, penalty=pen)
            pv, pi = tfk.fused_knn_plain(q, x, k, metric, penalty=pen)
            torch.cuda.synchronize()
            if integer and metric != "cos":
                assert torch.equal(kv, pv) and torch.equal(ki, pi)
            else:
                assert_knn_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "cos", "ip"])
def test_ivf_flat_scan_kernel_on_card(metric):
    """K3 + the K1 merge against the plain version: exact on
    integer-valued inputs, close on Gaussian ones."""
    need_cuda()
    for integer in (True, False):
        c = [t.cuda() for t in _ivf_store(integer, 3)]
        for k in (1, 10, 64):
            kv, ki = tis.ivf_flat_scan(*c[:6], k, metric, c[6])
            pv, pi = tis.ivf_flat_scan_plain(*c[:6], k, metric, c[6])
            torch.cuda.synchronize()
            if integer and metric != "cos":
                assert torch.equal(kv, pv) and torch.equal(ki, pi)
            else:
                assert_knn_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu())


@pytest.mark.cuda
@pytest.mark.parametrize("pq_bits", [4, 8])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("mode", ["f32", "bf16", "int8"])
def test_ivf_pq_scan_kernel_on_card(mode, metric, pq_bits):
    """K4 + the K1 merge against the plain version, with the penalty row
    and an empty list: exact on small-integer inputs (f32 and bf16 LUT
    modes; the int8 scales are not integers), close on Gaussian ones."""
    need_cuda()
    for integer in (True, False):
        st = pq_store(integer, 5 + pq_bits, pq_bits, n=12000, pq_dim=16,
                      pq_len=2, lists=24, m=150, p=6)
        args = pq_scan_args(st, mode, "cuda")
        pen = st["penalty"].cuda()
        for k in (1, 10, 64):
            kv, ki = tpq.ivf_pq_scan(*args, k, metric, pen)
            pv, pi = tpq.ivf_pq_scan_plain(*args, k, metric, pen)
            torch.cuda.synchronize()
            if integer and mode != "int8":
                assert torch.equal(kv, pv) and torch.equal(ki, pi)
            else:
                assert_knn_close(pv.cpu(), pi.cpu(), kv.cpu(), ki.cpu())


@pytest.mark.cuda
def test_ivf_pq_scan_kernel_byte_codes_and_padding():
    """K4 with a pq_dim that is not a multiple of 16 (byte loads), a probe
    of only the empty list, and k past the candidates: (+inf, -1) slots
    as in the plain version."""
    need_cuda()
    st = pq_store(True, 9, 8, n=3000, pq_dim=6, pq_len=3, lists=12, m=40,
                  p=3)
    st["probed"][:5] = 3                          # only the empty list
    args = pq_scan_args(st, "f32", "cuda")
    for k in (5, 1000):
        kv, ki = tpq.ivf_pq_scan(*args, k, "l2")
        pv, pi = tpq.ivf_pq_scan_plain(*args, k, "l2")
        torch.cuda.synchronize()
        assert torch.equal(kv, pv) and torch.equal(ki, pi)
        assert bool((ki[:5] == -1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_graph_expand_kernel_on_card(dtype, metric, penalty):
    """K5 against its plain version, which adds in the kernel's order:
    equal values and edge positions on an integer-valued store and on
    Gaussian queries with real scales, pad edges and penalized edges as
    (+inf, -1), for k' below and at deg_p."""
    need_cuda()
    for integer in (True, False):
        es = {k: v.cuda() if torch.is_tensor(v) else v
              for k, v in edge_store(dtype, 11, integer).items()}
        pen = es["pen"] if penalty else None
        for kout in (1, 24, 64):
            args = (es["parents"], es["q"], es["vecs"], es["aux"], kout,
                    metric, es["degree"], pen)
            kv, ki = tge.graph_expand(*args)
            pv, pi = tge.graph_expand_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("penalty", [False, True])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.int8, torch.bfloat16])
def test_cagra_fused_kernel_on_card(dtype, metric, penalty):
    """K6 against its plain version (max_iter edge hops on the plain K5)
    at width 1 and 3 and k' 1 and 16: equal buffers, ties included, on an
    integer-valued store and on Gaussian queries with real scales."""
    need_cuda()
    for integer, (width, kprime) in ((True, (1, 16)), (True, (3, 16)),
                                     (True, (2, 1)), (False, (1, 16)),
                                     (False, (3, 16))):
        es = {k: v.cuda() if torch.is_tensor(v) else v
              for k, v in edge_store(dtype, 12, integer).items()}
        pen = es["pen"] if penalty else None
        kw = dict(itopk=32, width=width, max_iter=6, kprime=kprime,
                  degree=es["degree"], metric=metric)
        args = (es["q"], es["buf_d"], es["buf_i"], es["vecs"], es["aux"],
                es["gph"], pen)
        kd, ki, hops, parents = tcf.fused_traverse_kernel(*args, **kw)
        pd, pi = tcf.fused_traverse_plain(*args, **kw)
        torch.cuda.synchronize()
        assert torch.equal(kd, pd) and torch.equal(ki, pi)
        assert int(hops.max()) <= 6 and bool((parents <= hops * width).all())


# the CAGRA engine test's data and plans, shared with the CPU test that
# reads the recall its floor rests on (test_torch_cagra.py)
ENGINE_TEST_BUILD = dict(intermediate_graph_degree=48, graph_degree=32)
ENGINE_TEST_SEARCH = dict(itopk_size=32, search_width=2)
ENGINE_TEST_FLOOR = 0.9


def engine_test_data():
    """(4000, 48) rows and (300, 48) queries, Gaussian, from seed 13."""
    rng = np.random.default_rng(13)
    return (rng.standard_normal((4000, 48)).astype(np.float32),
            rng.standard_normal((300, 48)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_cagra_engines_on_card(metric):
    """A CAGRA index built on the card: the edge (K5) and fused (K6)
    engines return equal ids and distances, through K2, K1, K5 and K6;
    they and the gather engine (bf16 rows, so another traversal) reach
    recall@10 >= ENGINE_TEST_FLOOR against brute force.
    ``test_torch_cagra.py::test_engine_test_data_recall`` holds the CPU
    build of this data (the plain K5, equal to the kernel) and the JAX
    package's gather engine above the floor with room to spare: the floor
    leaves room for the card's own build (k-means seeds with atomic
    adds), not for a wrong traversal."""
    need_cuda()
    x, q = (torch.from_numpy(a).cuda() for a in engine_test_data())
    idx = tcagra.build(x, tcagra.IndexParams(metric=metric,
                                             **ENGINE_TEST_BUILD))
    tcagra.prepare_traversal(idx)
    sp = tcagra.SearchParams(**ENGINE_TEST_SEARCH)
    ev, ei = tcagra.search(idx, q, 10, sp, engine="edge")
    fv, fi = tcagra.search(idx, q, 10, sp, engine="fused")
    gv, gi = tcagra.search(idx, q, 10, sp, engine="gather")
    torch.cuda.synchronize()
    assert torch.equal(ei, fi) and torch.equal(ev, fv)
    assert bool(((ei >= 0) & (ei < 4000)).all())
    _, ref = brute_force.search(brute_force.build(x, metric), q, 10)
    for ids in (ei, gi):
        assert neighborhood_recall(ids, ref) >= ENGINE_TEST_FLOOR


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 16, 16, 16), (301, 10, 37, 20),
                                   (257, 100, 100, 100), (64, 3, 5, 8)])
@pytest.mark.parametrize("select_min", [True, False])
def test_merge_step_kernel_on_card(shape, select_min):
    """K7 against its plain version: integer values with ties inside rows
    and across the lists, w1 != w2, k below and equal to w1 + w2,
    infinities, unsorted lists, running positions above the block's."""
    need_cuda()
    m, w1, w2, k = shape
    rng = np.random.default_rng(m + w1)
    for above in (False, True):
        d = rng.integers(0, 9, (m, w1 + w2)).astype(np.float32)
        d[rng.random(d.shape) < 0.1] = np.inf
        d[0] = np.inf
        if not select_min:
            d = -d
        pos = np.stack([rng.permutation(w1 + w2 + 7)[: w1 + w2]
                        for _ in range(m)]).astype(np.int32)
        if above:
            pos = -np.sort(-pos, axis=1)
        gid = rng.integers(0, 1 << 20, (m, w1 + w2)).astype(np.int32)
        t = [torch.from_numpy(np.ascontiguousarray(a)).cuda()
             for a in (d[:, :w1], pos[:, :w1], gid[:, :w1], d[:, w1:],
                       pos[:, w1:], gid[:, w1:])]
        before = trt.merge_step_launches
        got = trt.merge_step(*t, k, select_min)
        want = trt.merge_step_plain(*t, k, select_min)
        torch.cuda.synchronize()
        assert trt.merge_step_launches == before + 1
        for a, b in zip(want, got):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("select_min", [True, False])
def test_ring_topk_kernel_on_card(p, k, select_min):
    """K8 with p shards on one card against the plain ring and
    knn_merge_parts: every shard's copy equal, ties across shards, a dead
    shard, a last row tile that is not full."""
    need_cuda()
    mesh = Mesh(["cuda"] * p)
    for integer in (True, False):
        ds, gs = ring_parts(p, 1001, k, p * k, select_min, integer, "cuda")
        before = trt.ring_launches
        out_d, out_g = trt.ring_topk(ds, gs, k, select_min, mesh)
        assert trt.ring_launches == before + 1
        plain_d, plain_g = trt.ring_topk_plain(ds, gs, k, select_min, mesh)
        ref_d, ref_i = brute_force.knn_merge_parts(
            torch.stack(ds), torch.stack(gs), select_min)
        torch.cuda.synchronize()
        for r in range(p):
            assert torch.equal(out_d[r], plain_d[r])
            assert torch.equal(out_g[r], plain_g[r])
            assert torch.equal(out_d[r], ref_d) and torch.equal(out_g[r],
                                                                ref_i)
    # the engines of merge, and the default engine, on the same shards
    assert trt.resolve_engine(1001, k, p, mesh=mesh) == "ring_pallas"
    for eng in trt.ENGINES:
        md, mg = trt.merge(ds, gs, k, select_min, mesh, engine=eng)
        torch.cuda.synchronize()
        assert all(torch.equal(a, ref_d) for a in md)
        assert all(torch.equal(a, ref_i) for a in mg)


@pytest.mark.cuda
def test_ring_topk_kernel_refuses_what_it_cannot_hold():
    """k above RING_MAX_K: not ring_capable, so the default engine is
    allgather and an explicit ring_pallas raises."""
    need_cuda()
    k = trt.RING_MAX_K + 1
    mesh = Mesh(["cuda"] * 2)
    ds, gs = ring_parts(2, 8, k, 0, device="cuda")
    assert not trt.ring_capable(8, k, mesh)
    assert trt.resolve_engine(8, k, 2, mesh=mesh) == "allgather"
    with pytest.raises(RaftError):
        trt.merge(ds, gs, k, True, mesh, engine="ring_pallas")


@pytest.mark.cuda
@pytest.mark.parametrize("per_card", [1, 2])
@pytest.mark.parametrize("k", [10, 100])
@pytest.mark.parametrize("select_min", [True, False])
def test_ring_topk_kernel_across_cards(per_card, k, select_min):
    """K8's cross-card mode: one shard a card, or shards alternating over
    the cards (every neighbour on another card), one launch per card,
    peer memory for the neighbours' slots; against the plain ring and
    knn_merge_parts on the CPU."""
    need_cuda()
    n = torch.cuda.device_count()
    if n < 2:
        pytest.skip("the cross-card ring needs at least 2 cards")
    mesh = Mesh([f"cuda:{r % n}" for r in range(per_card * n)])
    if not trt.ring_capable(1001, k, mesh):
        pytest.skip("these cards have no peer access to each other")
    # unrun until this test passes: the default keeps to one card
    assert trt.resolve_engine(1001, k, mesh.size, mesh=mesh) == "allgather"
    ds, gs = ring_parts(mesh.size, 1001, k, 9 + k, select_min)
    want = trt.ring_topk_plain(ds, gs, k, select_min,
                               Mesh(["cpu"] * mesh.size))
    ref_d, ref_i = brute_force.knn_merge_parts(torch.stack(ds),
                                               torch.stack(gs), select_min)
    ds = [d.to(dev) for d, dev in zip(ds, mesh.devices)]
    gs = [g.to(dev) for g, dev in zip(gs, mesh.devices)]
    before = trt.ring_launches
    out_d, out_g = trt.ring_topk(ds, gs, k, select_min, mesh)
    assert trt.ring_launches == before + n
    assert torch.cuda.current_device() == 0
    for r, (d, g) in enumerate(zip(out_d, out_g)):
        assert d.device == mesh.devices[r]
        assert torch.equal(d.cpu(), want[0][r]) and torch.equal(
            g.cpu(), want[1][r])
        assert torch.equal(d.cpu(), ref_d) and torch.equal(g.cpu(), ref_i)
