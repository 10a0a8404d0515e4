"""Kernel K1 (select_k) of the PyTorch port against
``raft_tpu.matrix.select_k``: the Pallas k-pass in interpret mode and the
``lax.top_k`` engine.

Tolerance: none. Rows are integer-valued (ties abound) with +inf
columns, and selection does no arithmetic, so values and ids must be
equal, including which of the tied columns comes first (the lowest).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.matrix.select_k import _kpass_2d
from raft_tpu.matrix.select_k import select_k as jax_select_k
from raft_tpu_torch.matrix import select_k as tsk

torch.set_num_threads(1)

ROWS, N = 256, 1000


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, (ROWS, N)).astype(np.float32)
    x[rng.random((ROWS, N)) < 0.1] = np.inf
    x[7, :] = np.inf                  # a row of nothing but +inf
    return x


@pytest.mark.parametrize("k", [1, 10, 64])
def test_kpass_matches_pallas_kernel(k):
    x = _rows()
    jv, ji = _kpass_2d(jnp.asarray(x), k, True)
    tv, ti = tsk.kpass_select_k(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("algo", ["auto", "kpass", "topk"])
def test_select_k_matches_topk_engine(k, select_min, algo):
    x = _rows(1)
    if not select_min:
        x = np.where(np.isinf(x), -np.inf, x)
    jv, ji = jax_select_k(jnp.asarray(x), k, select_min=select_min,
                          algo="topk")
    tv, ti = tsk.select_k(torch.from_numpy(x), k, select_min=select_min,
                          algo=algo)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_batched_leading_dims_and_indices():
    x = _rows(2).reshape(4, 64, N)
    ids = np.arange(4 * 64 * N, dtype=np.int32).reshape(4, 64, N)
    jv, ji = jax_select_k(jnp.asarray(x), 5, indices=jnp.asarray(ids),
                          algo="topk")
    tv, ti = tsk.select_k(torch.from_numpy(x), 5,
                          indices=torch.from_numpy(ids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_k_out_of_range_raises():
    from raft_tpu_torch.core.errors import RaftError

    with pytest.raises(RaftError):
        tsk.select_k(torch.zeros((2, 5)), 6)
