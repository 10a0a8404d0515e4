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


@pytest.mark.parametrize("m,n,k,slots", [
    (10_000, 1_000_000, 10, 132), (10_000, 1_000_000, 10, 264),
    (32_768, 1_000_000, 129, 132), (512, 1_000_000, 10, 132),
    (7, 40_000, 100, 132), (200, 40_000, 256, 132), (1, 100, 1, 132),
    (10_000, 250_000, 10, 132)])
def test_split_plan(m, n, k, slots):
    """K2's grid: every corpus row in exactly one split of a multiple of
    128 rows (at least 4 tiles unless the corpus is smaller), about 4 waves
    of the card's resident blocks, and among the split counts near that
    aim the one whose last wave is fullest."""
    splits, rows = tfk.split_plan(m, n, k, slots)
    assert rows % 128 == 0 and splits >= 1
    assert (splits - 1) * rows < n <= splits * rows
    assert rows >= min(4 * 128, -(-n // 128) * 128)
    tiles = -(-m // tfk.block_queries(k))
    blocks = tiles * splits
    fill = blocks / (-(-blocks // slots) * slots)
    aim = max(1, min(-(-n // 512), -(-4 * slots // tiles)))
    for s in range(max(1, aim // 2), min(-(-n // 512), 2 * aim) + 1):
        r = -(-(-(-n // s)) // 128) * 128
        b = tiles * -(-n // r)
        assert b / (-(-b // slots) * slots) <= fill + 1e-12


def test_block_queries():
    assert [tfk.block_queries(k) for k in (1, 64, 65, 129, 256)] == [
        128, 128, 64, 64, 64]


def test_zero_distance_is_positive_zero():
    """The penalty row is always added, as in the JAX kernel (a zero row
    when there is no filter): an inner product of +0.0 gives the distance
    +0.0, never -0.0, so the split merge's totalOrder and the kernel's
    float compare agree."""
    q = torch.tensor([[1.0, 0.0], [0.0, 0.0]])
    x = torch.tensor([[0.0, 1.0], [0.0, -2.0], [1.0, 1.0]])
    v, i = tfk.fused_knn_plain(q, x, 3, "ip")
    zero = v == 0
    assert zero.any() and not torch.signbit(v[zero]).any()
    jv, ji = jax_fused_knn(jnp.asarray(q.numpy()), jnp.asarray(x.numpy()),
                           3, metric="ip")
    np.testing.assert_array_equal(v.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
