"""NN-descent in the PyTorch port against the JAX package:
``raft_tpu_torch.ops.nn_descent`` (CAGRA's batched builder) against
``raft_tpu.ops.nn_descent`` and ``raft_tpu_torch.neighbors.nn_descent``
(the GNND-shaped API) against ``raft_tpu.neighbors.nn_descent``.

Tolerance: equal. The data are small integers, so every distance is an
exact integer in float32 under either package's sum order, and ties,
which are many, break the same way (lowest position first in
``select_k``, stable sorts in the reverse sample and the dedup). The
batched builder draws its random ids through one function
(``ops.nn_descent._draw_ints``); the whole-graph test injects JAX's
``jax.random.randint`` draws there, in JAX's key order. The GNND-shaped
API samples on the host with ``np.random.default_rng(seed)`` in both
packages, so it needs no injection. The parity tests run the batched
builder with the JAX package's exposure (``exposure="closest"``); its
default, which CAGRA's route runs, offers sampled neighbors instead
(``"sampled"``), a difference by design that
``tests/test_torch_cagra_routes.py`` holds against JAX's route. The
port's own draws are held to JAX's recall floor on JAX's fixture
(``tests/test_graph_build.py``: edge recall >= 0.9 at n = 1000, k = 16,
5 rounds) with either exposure.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ann_utils import calc_recall
from raft_tpu.distance.distance_types import DistanceType
from raft_tpu.neighbors import nn_descent as jnn
from raft_tpu.ops import nn_descent as jnnd
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import nn_descent as tnn
from raft_tpu_torch.ops import nn_descent as tnnd
from test_graph_build import clustered, exact_graph_oracle

torch.set_num_threads(1)

METRICS = [DistanceType.L2Expanded, DistanceType.InnerProduct]


def _ints(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def test_rev_sample_matches_jax():
    rng = np.random.default_rng(0)
    n, s = 300, 6
    # hot targets (many arrivals, past s), junk ids, -1
    fwd = rng.integers(0, 40, (n, s)).astype(np.int32)
    fwd[rng.random((n, s)) < 0.1] = -1
    fwd[rng.random((n, s)) < 0.05] = n + 3
    want = np.asarray(jnnd._rev_sample(jnp.asarray(fwd), s))
    got = tnnd._rev_sample(torch.from_numpy(fwd), s)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("join", [0, 3])
@pytest.mark.parametrize("metric", METRICS)
def test_join_batch_matches_jax(metric, join):
    rng = np.random.default_rng(1)
    n, d, k, b, t = 200, 12, 10, 64, 8
    score = _ints(rng, (n, d))
    norms = (score ** 2).sum(1).astype(np.float32)
    graph = rng.integers(0, n, (n, k)).astype(np.int32)
    graph[rng.random((n, k)) < 0.2] = -1
    dist = np.sort(rng.integers(0, 150, (n, k)).astype(np.float32), axis=1)
    dist[graph < 0] = np.inf
    dist = np.sort(dist, axis=1)
    rows = rng.permutation(n)[:b].astype(np.int32)
    jlist = rng.integers(0, n, (b, t)).astype(np.int32)
    jlist[rng.random((b, t)) < 0.15] = -1
    jlist[:5, 0] = rows[:5]                   # a node proposing itself
    ji, jd, jc = jnnd._join_batch(
        jnp.asarray(score), jnp.asarray(norms), jnp.asarray(graph),
        jnp.asarray(dist), jnp.asarray(jlist), jnp.asarray(rows), k, join,
        metric.value)
    ti, td, tc = tnnd._join_batch(
        torch.from_numpy(score), torch.from_numpy(norms),
        torch.from_numpy(graph), torch.from_numpy(dist),
        torch.from_numpy(jlist), torch.from_numpy(rows), k,
        torch.from_numpy(graph[:, :join]) if join else None,
        metric is DistanceType.InnerProduct)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.fixture
def jax_draws(monkeypatch):
    """Make the port draw JAX's ids: one key split a draw, in the order
    JAX's build_graph splits (the initial ids, then one a round)."""
    def install(seed):
        key = [jax.random.PRNGKey(seed)]

        def draw(gen, shape, high):
            key[0], sub = jax.random.split(key[0])
            r = jax.random.randint(sub, shape, 0, high, dtype=jnp.int32)
            return torch.from_numpy(np.array(r)).to(gen.device)

        monkeypatch.setattr(tnnd, "_draw_ints", draw)

    return install


@pytest.mark.parametrize("metric", METRICS)
def test_build_graph_matches_jax(jax_draws, metric):
    """The whole graph, over several batches with a short last one (JAX
    wraps it around to the batch shape), init and 4 rounds."""
    x = _ints(np.random.default_rng(2), (700, 16))
    kw = dict(rounds=4, sample=6, join=5, termination=0.0, seed=9,
              batch=256)
    jax_rule = dict(exposure="closest")
    rates = []
    want = jnnd.build_graph(x, 12, metric, progress=lambda r, t, rate, s:
                            rates.append(rate), **kw)
    jax_draws(9)
    got_rates = []
    got = tnnd.build_graph(x, 12, metric.value,
                           progress=lambda r, t, rate, s:
                           got_rates.append(rate), device="cpu", **kw,
                           **jax_rule)
    assert got.dtype == torch.int32 and got.shape == (700, 12)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_rates == rates and len(rates) == 4


def test_build_graph_from_init_graph_matches_jax(jax_draws):
    rng = np.random.default_rng(3)
    x = _ints(rng, (400, 8))
    init = rng.integers(0, 400, (400, 7)).astype(np.int32)
    kw = dict(rounds=2, sample=4, join=4, termination=0.0, seed=4,
              batch=150)
    want = jnnd.build_graph(x, 9, init_graph=init, progress=lambda *a: None,
                            **kw)
    jax_draws(4)
    got = tnnd.build_graph(x, 9, init_graph=init, exposure="closest",
                           device="cpu", **kw)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("exposure", ["closest", "sampled"])
def test_build_graph_own_draws_recall_floor(exposure):
    """The port's own draws on JAX's fixture, with JAX's exposure and
    with CAGRA's: JAX's floor (edge recall >= 0.9), no self edges, every
    slot valid, the same graph twice."""
    x = clustered(1000, 32, seed=5)
    kw = dict(rounds=5, seed=3, exposure=exposure, device="cpu")
    g1 = tnnd.build_graph(x, 16, **kw).numpy()
    r = calc_recall(g1, exact_graph_oracle(x, 16))
    assert r >= 0.9, f"nn_descent graph recall {r}"
    assert (g1 != np.arange(len(x))[:, None]).all()
    assert g1.min() >= 0 and g1.max() < len(x)
    np.testing.assert_array_equal(g1, tnnd.build_graph(x, 16, **kw).numpy())


def test_build_graph_refuses_unserved_metric():
    x = _ints(np.random.default_rng(4), (50, 4))
    assert not tnnd.supports("cosine") and tnnd.supports("inner_product")
    with pytest.raises(RaftError, match="L2/IP"):
        tnnd.build_graph(x, 5, "cosine", device="cpu")
    with pytest.raises(RaftError, match="unknown exposure"):
        tnnd.build_graph(x, 5, exposure="random", device="cpu")


@pytest.mark.parametrize("metric", METRICS)
def test_gnnd_build_matches_jax(metric):
    x = _ints(np.random.default_rng(5), (600, 10))
    kw = dict(n_iters=3, seed=21, batch=256)
    want = jnn.build(x, 10, metric, **kw)
    got = tnn.build(x, 10, metric.value, device="cpu", **kw)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_builders_need_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = _ints(np.random.default_rng(6), (50, 4))
    with pytest.raises(RaftError, match="no CUDA device"):
        tnnd.build_graph(x, 5)
    with pytest.raises(RaftError, match="no CUDA device"):
        tnn.build(x, 5)
