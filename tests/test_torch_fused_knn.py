"""Kernel K2 (fused distance + running top-k) of the PyTorch port against
``raft_tpu.ops.fused_knn.fused_knn`` in interpret mode.

Tolerances. Integer-valued inputs: every product and sum is exact in
float32, so values and ids (and their order) must be equal. Gaussian
inputs: XLA and torch sum the dot products in different orders, so
distances agree to ``rtol=1e-5, atol=1e-5·max|d|``, ids are equal on at
least 99% of rows, and a differing id may only sit at a slot whose two
values agree within that tolerance, a near tie
(``test_torch_kernels.assert_knn_close``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.fused_knn import fused_knn as jax_fused_knn
from raft_tpu_torch.ops import fused_knn as tfk
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)

M, N, D, K = 64, 3000, 32, 10

# metric name -> (kernel metric code, post-processing on both sides)
_METRICS = {
    "sqeuclidean": ("l2", None),
    "euclidean": ("l2", np.sqrt),
    "cosine": ("cos", None),
    "inner_product": ("ip", None),
}


def _gaussian(seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((M, D)).astype(np.float32)
    x = rng.standard_normal((N, D)).astype(np.float32)
    pen = np.where(rng.random(N) < 0.3, np.inf, 0.0).astype(np.float32)
    return q, x, pen


@pytest.mark.parametrize("with_penalty", [False, True])
@pytest.mark.parametrize("metric", list(_METRICS))
def test_matches_jax_kernel(metric, with_penalty):
    q, x, pen = _gaussian()
    code, post = _METRICS[metric]
    pen = pen if with_penalty else None
    jv, ji = jax_fused_knn(jnp.asarray(q), jnp.asarray(x), K, metric=code,
                           penalty=None if pen is None else jnp.asarray(pen),
                           interpret=True)
    tv, ti = tfk.fused_knn(torch.from_numpy(q), torch.from_numpy(x), K,
                           metric=code,
                           penalty=None if pen is None
                           else torch.from_numpy(pen))
    jv, tv = np.asarray(jv), tv.numpy()
    if post is not None:
        jv, tv = post(jv), post(tv)
    assert ti.dtype == torch.int32
    assert_knn_close(jv, np.asarray(ji), tv, ti.numpy())
    if with_penalty:
        assert not np.isin(ti.numpy(), np.nonzero(np.isinf(pen))[0]).any()


@pytest.mark.parametrize("code", ["l2", "ip"])
def test_integer_inputs_exact(code):
    """Integer-valued rows with heavy ties: ids and order are equal."""
    rng = np.random.default_rng(1)
    q = rng.integers(-2, 3, (M, D)).astype(np.float32)
    x = rng.integers(-2, 3, (N, D)).astype(np.float32)
    jv, ji = jax_fused_knn(jnp.asarray(q), jnp.asarray(x), K, metric=code,
                           interpret=True)
    tv, ti = tfk.fused_knn(torch.from_numpy(q), torch.from_numpy(x), K,
                           metric=code)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_k_past_survivors_pads():
    """Fewer surviving rows than k: the tail is (+inf, -1), as in JAX."""
    q, x, _ = _gaussian(2)
    pen = np.full(N, np.inf, np.float32)
    pen[[5, 17, 2999]] = 0.0
    jv, ji = jax_fused_knn(jnp.asarray(q), jnp.asarray(x), K,
                           penalty=jnp.asarray(pen), interpret=True)
    tv, ti = tfk.fused_knn(torch.from_numpy(q), torch.from_numpy(x), K,
                           penalty=torch.from_numpy(pen))
    assert (ti.numpy()[:, 3:] == -1).all()
    assert_knn_close(np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy())
