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
equal on at least 99% of rows (:func:`assert_knn_close`).
"""
import numpy as np
import pytest
import torch

from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.matrix import select_k as tsk
from raft_tpu_torch.ops import fused_knn as tfk
from raft_tpu_torch.ops import ivf_scan as tis

torch.set_num_threads(1)


def assert_knn_close(ref_v, ref_i, v, i, rtol=1e-5):
    """The Gaussian-input contract of the module docstring. Values are
    compared slot by slot, so where the two ids at a slot differ, the two
    candidates' distances differ by less than the tolerance (a near
    tie)."""
    ref_v = np.asarray(ref_v, np.float64)
    v = np.asarray(v, np.float64)
    ref_i, i = np.asarray(ref_i), np.asarray(i)
    assert v.shape == ref_v.shape and i.shape == ref_i.shape
    finite = np.isfinite(ref_v)
    np.testing.assert_array_equal(np.isfinite(v), finite)
    np.testing.assert_array_equal(v[~finite], ref_v[~finite])
    np.testing.assert_array_equal(i[~finite], ref_i[~finite])
    atol = 1e-5 * (np.abs(ref_v[finite]).max() if finite.any() else 1.0)
    np.testing.assert_allclose(v[finite], ref_v[finite], rtol=rtol,
                               atol=atol)
    rows_equal = (i == ref_i).all(axis=1)
    assert rows_equal.mean() >= 0.99, (
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
