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

from raft_tpu.ops.ivf_scan import coarse_probe as jax_coarse_probe
from raft_tpu.ops.ivf_scan import ivf_flat_scan as jax_ivf_flat_scan
from raft_tpu_torch.ops import ivf_scan as tis
from test_torch_kernels import assert_knn_close

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
