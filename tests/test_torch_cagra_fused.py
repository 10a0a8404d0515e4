"""The one-launch CAGRA traversal of the PyTorch port (the plain version
of kernel K6, ``max_iter`` edge hops on the plain K5) against
``raft_tpu.ops.cagra_fused.fused_traverse`` with its Pallas kernel in
interpret mode, from the same seeded buffer over an edge store built by
``raft_tpu``; and the port's fused engine against its edge engine.

Tolerances: integer-valued data and queries make every score an exact
float32 integer, so the buffers are equal, ties included. On Gaussian
data the scores are float32 sums in another order than XLA's:
``assert_knn_close`` (values to rtol 1e-5, ids on >= 99% of rows). The
port's fused and edge engines compute the same values by construction
(the same plain K5 on the CPU), so their results are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops.cagra_fused import fused_traverse as jax_fused_traverse
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import cagra_fused as tcf
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)

N, D, DEG, M, ITOPK, KPRIME, HOPS = 700, 16, 24, 16, 16, 16, 3


def _case(integer: bool, penalty: bool, seed: int):
    """A JAX int8 edge store over a random graph, queries, an optional
    edge penalty, and a seeded buffer: the exact distances of ITOPK
    distinct random rows, sorted, with a +inf tail."""
    rng = np.random.default_rng(seed)
    gen = ((lambda s: rng.integers(-4, 5, s)) if integer
           else rng.standard_normal)
    x = gen((N, D)).astype(np.float32)
    q = gen((M, D)).astype(np.float32)
    graph = rng.integers(0, N, (N, DEG)).astype(np.int32)
    jidx = jcagra.Index(jnp.asarray(x), jnp.asarray(graph),
                        jcagra.DistanceType.L2Expanded)
    jcagra.prepare_traversal(jidx)
    _, ev, aux, gp, _ = jidx._edge_store
    pen = None
    if penalty:
        pen = np.where(rng.random(gp.shape) < 0.3, np.inf, 0.0).astype(
            np.float32)
    ids = np.stack([rng.permutation(N)[:ITOPK] for _ in range(M)])
    d = ((x[ids] - q[:, None, :]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    buf_d = np.take_along_axis(d, order, 1).astype(np.float32)
    buf_i = np.take_along_axis(ids, order, 1).astype(np.int32)
    buf_d[:, -2:] = np.inf
    return q, ev, aux, gp, pen, buf_d, buf_i


@pytest.mark.parametrize("width,penalty", [(1, False), (2, True)])
def test_fused_traverse_plain_matches_jax(width, penalty):
    for integer in (False, True):
        q, ev, aux, gp, pen, buf_d, buf_i = _case(integer, penalty, width)
        kw = dict(itopk=ITOPK, width=width, max_iter=HOPS, kprime=KPRIME,
                  degree=DEG)
        jd, ji = jax_fused_traverse(
            jnp.asarray(q), jnp.asarray(buf_d), jnp.asarray(buf_i), ev, aux,
            gp, None if pen is None else jnp.asarray(pen), **kw)
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        td, ti = tcf.fused_traverse(
            t(q), t(buf_d), t(buf_i), t(ev), t(aux), t(gp),
            None if pen is None else t(pen), **kw)
        assert td.shape == (M, ITOPK) and ti.dtype == torch.int32
        if integer:
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        else:
            assert_knn_close(np.asarray(jd), np.asarray(ji), td.numpy(),
                             ti.numpy())


@pytest.fixture(scope="module")
def port_index():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((900, D)).astype(np.float32)
    q = rng.standard_normal((40, D)).astype(np.float32)
    idx = cagra.build(x, cagra.IndexParams(intermediate_graph_degree=32,
                                           graph_degree=DEG), device="cpu")
    cagra.prepare_traversal(idx)
    return idx, torch.from_numpy(q), rng.random(900) < 0.7


@pytest.mark.parametrize("k,itopk,width,filtered", [
    (5, 16, 1, False), (5, 32, 2, False), (5, 16, 2, True),
    (1, 16, 1, False), (1, 1, 1, True)])
def test_fused_engine_equals_edge_engine(port_index, k, itopk, width,
                                         filtered):
    """The port's fused and edge engines return equal ids and distances,
    at width 1 and 2, k' = itopk < degree, under a filter, and at k = 1
    (itopk 1: one candidate per parent)."""
    idx, q, keep = port_index
    sp = cagra.SearchParams(itopk_size=itopk, search_width=width,
                            max_iterations=6)
    filt = Bitset.from_mask(torch.from_numpy(keep)) if filtered else None
    ev, ei = cagra.search(idx, q, k, sp, filter=filt, engine="edge")
    fv, fi = cagra.search(idx, q, k, sp, filter=filt, engine="fused")
    assert torch.equal(ei, fi) and torch.equal(ev, fv)
    found = ei[ei >= 0]
    assert found.numel() > 0 and bool((found < idx.size).all())
    if filtered:
        assert bool(torch.from_numpy(keep)[found.long()].all())


def test_fused_traverse_refuses_int4_store(port_index):
    idx, q, _ = port_index
    st = idx.edge_store
    buf = torch.zeros((q.shape[0], 16))
    with pytest.raises(RaftError, match="not ported"):
        tcf.fused_traverse(q, buf, buf.int(), st.vecs, st.aux, st.gp,
                           itopk=16, width=1, max_iter=1, kprime=16,
                           degree=DEG, mode="int4")
