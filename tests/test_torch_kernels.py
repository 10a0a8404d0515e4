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


SELECT_KS = (1, 20, 32, 33, 64, 100, 129, 256, 257)


def select_rows(n, select_min, seed, rows=300):
    """Integer rows with heavy ties and ±inf cells, row 5 all ±inf; then
    (from another generator) -0.0 against 0.0, and rows 6-9 with only 1,
    19, 40 and 0 finite cells (fewer than most k)."""
    rng = np.random.default_rng(seed)
    bad = np.inf if select_min else -np.inf
    x = rng.integers(0, 50, (rows, n)).astype(np.float32)
    x[rng.random((rows, n)) < 0.05] = bad
    x[5] = bad
    more = np.random.default_rng(seed + 1)
    x[x == 0] = np.where(more.random(int((x == 0).sum())) < 0.5, 0.0, -0.0)
    for r, fin in zip(range(6, 10), (1, 19, 40, 0)):
        x[r, fin:] = bad
        x[r] = x[r, more.permutation(n)]
    return torch.from_numpy(x).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [20, 140, 200, 1024, 1806, 20000])
@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_kernel_on_card(n, select_min):
    """K1, each form, against its plain version: the warp select for
    k <= 256 and the k passes for every k, rows in shared memory and (n =
    20000) streamed from device memory, heavy ties, -0.0 against 0.0,
    rows of ±inf and rows with fewer finite values than k. Each call
    counts one launch of its form, and the default takes the form the
    rule gives."""
    need_cuda()
    xc = select_rows(n, select_min, n)
    for k in (k for k in SELECT_KS if k <= n):
        pv, pi = tsk.select_k_plain(xc, k, select_min)
        forms = ("warp", "kpass") if k <= tsk.WARP_MAX_K else ("kpass",)
        for form in forms + (None,):
            counts = (tsk.warp_launches, tsk.kpass_launches)
            kv, ki = tsk.kpass_select_k(xc, k, select_min, form=form)
            torch.cuda.synchronize()
            assert torch.equal(kv, pv) and torch.equal(ki, pi), (k, form)
            used = form or tsk.select_form(k)
            assert (tsk.warp_launches - counts[0],
                    tsk.kpass_launches - counts[1]) == (
                        (1, 0) if used == "warp" else (0, 1))


@pytest.mark.cuda
def test_select_k_kernel_nan_is_never_selected():
    """NaN cells are never selected (the plain sort would order them last):
    a row with fewer than k cells that are not NaN ends in (±inf, -1)."""
    need_cuda()
    x = torch.full((4, 64), float("nan"), device="cuda")
    x[:, :5] = torch.arange(5.0, device="cuda")
    for form in ("warp", "kpass"):
        for sel in (True, False):
            v, i = tsk.kpass_select_k(x if sel else -x, 8, sel, form=form)
            torch.cuda.synchronize()
            assert i[:, 5:].eq(-1).all()
            assert i[:, :5].eq(torch.arange(5, device="cuda")).all()
            assert torch.isinf(v[:, 5:]).all()


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


def ring_odd_cells(ds, seed):
    """The lists with -0.0 against 0.0 and NaN, -inf and +inf cells mixed
    in (the ring orders NaN after +inf; select_k would drop it)."""
    rng = np.random.default_rng(seed)
    out = []
    for d in ds:
        d = d.cpu().numpy().copy()
        z = d == 0
        d[z] = np.where(rng.random(int(z.sum())) < 0.5, 0.0, -0.0)
        for v, share in ((np.nan, 0.05), (-np.inf, 0.03), (np.inf, 0.05)):
            d[rng.random(d.shape) < share] = v
        out.append(torch.from_numpy(d).cuda())
    return out


def assert_bits_equal(a, b):
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 3, 4, 8, 16])
@pytest.mark.parametrize("k", [1, 10, 31, 64, 100, 256, 1024])
@pytest.mark.parametrize("select_min", [True, False])
def test_ring_topk_kernel_on_card(p, k, select_min):
    """K8 with p shards on one card against the plain ring and
    knn_merge_parts, on every shard's copy, each form of its row work
    (k <= 32 in lane groups, k <= 256 in registers, k > 256 in shared
    memory), at m = 1 (fewer rows than
    ring blocks), 3, 1001 and 10,000: an unsorted shard 0, ties across
    shards, a dead shard; and with -0.0 / NaN / ±inf cells against the
    plain ring bit for bit. Two calls back to back on one stream must
    both be right: no stale flag of the first reaches the second. (m =
    10,000 where p·k <= 4,096: the host-side fixtures of the widest cases
    would take most of the test's time.)"""
    need_cuda()
    mesh = Mesh(["cuda"] * p)
    for m in (1, 3, 1001) + ((10_000,) if p * k <= 4096 else ()):
        for integer in (True, False):
            seed = p * k if m == 1001 else p * k + m
            ds, gs = ring_parts(p, m, k, seed, select_min, integer, "cuda")
            odd = ring_odd_cells(ds, m + k)
            before = trt.ring_launches
            first = trt.ring_topk(ds, gs, k, select_min, mesh)
            second = trt.ring_topk(odd, gs, k, select_min, mesh)
            assert trt.ring_launches == before + 2
            plain = trt.ring_topk_plain(ds, gs, k, select_min, mesh)
            plain_odd = trt.ring_topk_plain(odd, gs, k, select_min, mesh)
            ref_d, ref_i = brute_force.knn_merge_parts(
                torch.stack(ds).cpu(), torch.stack(gs).cpu(), select_min)
            torch.cuda.synchronize()
            for r in range(p):
                assert torch.equal(first[0][r], plain[0][r])
                assert torch.equal(first[1][r], plain[1][r])
                assert torch.equal(first[0][r].cpu(), ref_d)
                assert torch.equal(first[1][r].cpu(), ref_i)
                assert_bits_equal(second[0][r], plain_odd[0][r])
                assert torch.equal(second[1][r], plain_odd[1][r])
    # the engines of merge, and the default engine, on the same shards
    ds, gs = ring_parts(p, 1001, k, p * k, select_min, True, "cuda")
    assert trt.resolve_engine(1001, k, p, mesh=mesh) == "ring_pallas"
    ref_d, ref_i = brute_force.knn_merge_parts(
        torch.stack(ds).cpu(), torch.stack(gs).cpu(), select_min)
    for eng in trt.ENGINES if k <= 100 else ("ring_pallas",):
        md, mg = trt.merge(ds, gs, k, select_min, mesh, engine=eng)
        torch.cuda.synchronize()
        assert all(torch.equal(a.cpu(), ref_d) for a in md)
        assert all(torch.equal(a.cpu(), ref_i) for a in mg)


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
