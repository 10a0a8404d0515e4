"""The CAGRA frontier expansion of the PyTorch port (the plain version of
kernel K5) and its storage coding against the JAX package:
``raft_tpu.ops.graph_expand.graph_expand`` with its Pallas kernel in
interpret mode, over an edge store built by ``raft_tpu``'s
``cagra.prepare_traversal``, and ``raft_tpu.ops.quant.quantize_rows``.

Tolerances: the int8 codes and scales and the bf16 rows are equal (the
same float32 division and half-to-even rounding). Gaussian queries: the
per-parent values agree to ``rtol=1e-5, atol=1e-5·max|v|`` and the edge
positions on >= 99% of the (query, parent) rows (float32 sums in another
order; ``assert_knn_close``). Integer-valued data and queries: every
product and sum is exact, so values and positions are equal, ties
included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops import quant as jquant
from raft_tpu.ops.graph_expand import graph_expand as jax_graph_expand
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.ops import graph_expand as tge
from raft_tpu_torch.ops import quant as tquant
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)

N, D, M, WIDTH, KOUT = 600, 24, 40, 2, 16


def _data(integer: bool, seed: int):
    rng = np.random.default_rng(seed)
    gen = ((lambda s: rng.integers(-4, 5, s)) if integer
           else rng.standard_normal)
    return (gen((N, D)).astype(np.float32), gen((M, D)).astype(np.float32),
            rng)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_quantize_rows_matches_jax(dtype):
    x = np.random.default_rng(0).standard_normal((300, 40)).astype(
        np.float32) * 3
    x[7] = 0.0                                    # the 1e-30 scale floor
    jr, js = jquant.quantize_rows(jnp.asarray(x), getattr(jnp, dtype))
    tr, ts = tquant.quantize_rows(torch.from_numpy(x), dtype)
    assert tr.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tr.to(torch.float32).numpy(),
                                  np.asarray(jr).astype(np.float32))
    if dtype == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        assert ts is None and js is None


# (store, metric, penalty, degree): each store meets both metrics, both
# penalty settings and both degrees (each case compiles the Pallas kernel
# once, ~5 s); degree 24 pads to JAX's 32-edge tile and is cut to k' = 16
CASES = [("int8", "l2", True, 24), ("int8", "ip", False, 16),
         ("bfloat16", "l2", False, 24), ("bfloat16", "ip", True, 16)]


@pytest.mark.parametrize("store,metric,penalty,degree", CASES)
def test_graph_expand_plain_matches_jax(store, metric, penalty, degree):
    for integer in (False, True):
        x, q, rng = _data(integer, degree)
        graph = rng.integers(0, N, (N, degree)).astype(np.int32)
        jidx = jcagra.Index(jnp.asarray(x), jnp.asarray(graph),
                            jcagra.DistanceType.L2Expanded)
        jcagra.prepare_traversal(jidx, store)
        _, ev, aux, _, _ = jidx._edge_store
        deg_p = ev.shape[1]
        pen = None
        if penalty:
            pen = np.where(rng.random((N, deg_p)) < 0.25, np.inf,
                           0.0).astype(np.float32)
        parents = rng.integers(0, N, (M, WIDTH)).astype(np.int32)
        jv, je = jax_graph_expand(
            jnp.asarray(parents), jnp.asarray(q), ev, aux, KOUT,
            metric=metric, degree=degree,
            pen=None if pen is None else jnp.asarray(pen))
        tvecs = torch.from_numpy(np.array(ev.astype(jnp.float32))).to(
            getattr(torch, store))
        tv, te = tge.graph_expand(
            torch.from_numpy(parents), torch.from_numpy(q), tvecs,
            torch.from_numpy(np.array(aux)), KOUT, metric, degree,
            None if pen is None else torch.from_numpy(pen))
        assert tv.shape == (M, WIDTH, KOUT) and te.dtype == torch.int32
        jv = np.asarray(jv).reshape(M * WIDTH, KOUT)
        je = np.asarray(je).reshape(M * WIDTH, KOUT)
        tv, te = tv.reshape(M * WIDTH, KOUT), te.reshape(M * WIDTH, KOUT)
        if integer:
            np.testing.assert_array_equal(tv.numpy(), jv)
            np.testing.assert_array_equal(te.numpy(), je)
        else:
            assert_knn_close(jv, je, tv.numpy(), te.numpy())
        assert bool((te < degree).all())


def test_graph_expand_refuses_unported_modes():
    vecs = torch.zeros((4, 32, 128), dtype=torch.int8)
    aux = torch.zeros((4, 2, 32))
    for mode in ("int4", "pq"):
        with pytest.raises(RaftError, match="not ported"):
            tge.graph_expand(torch.zeros((2, 1), dtype=torch.int32),
                             torch.zeros((2, 8)), vecs, aux, 4, mode=mode)
