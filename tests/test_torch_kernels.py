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
sums stay exact in float32 and bfloat16.
"""
import numpy as np
import pytest
import torch

from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.matrix import select_k as tsk
from raft_tpu_torch.ops import fused_knn as tfk
from raft_tpu_torch.ops import ivf_pq_scan as tpq
from raft_tpu_torch.ops import ivf_scan as tis

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
