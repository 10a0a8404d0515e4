"""``raft_tpu_torch.random`` against ``raft_tpu.random`` and against the
distributions' contracts.

The port draws from ``torch.Generator`` and the JAX package from threefry
keys, so their streams differ by design. What is compared bit for bit is
the arithmetic that does not depend on the stream: ``make_blobs`` with
given centers, ``cluster_std=0`` and no shuffle equals JAX's exactly, and
the labels and cluster sizes are equal whatever the noise. Everything
else is held to its contract on 10^5 draws: each sample mean within 5
standard errors of the distribution's mean (5σ keeps a correct generator
from failing by chance), each sample standard deviation within 2% of the
distribution's, supports and ranges exact.
"""
import math

import numpy as np
import pytest
import torch

from raft_tpu import random as jrnd
from raft_tpu_torch import random as trnd
from raft_tpu_torch.core.errors import RaftError

torch.set_num_threads(1)

N_DRAWS = 100_000


def test_make_blobs_bit_equal_without_noise():
    centers = np.random.default_rng(0).uniform(-10, 10, (7, 12)).astype(
        np.float32)
    jd, jl = jrnd.make_blobs(1000, 12, centers=centers, cluster_std=0.0,
                             shuffle=False)
    td, tl = trnd.make_blobs(1000, 12, centers=centers, cluster_std=0.0,
                             shuffle=False, device="cpu")
    assert td.dtype == torch.float32 and tl.dtype == torch.int32
    np.testing.assert_array_equal(td.numpy().view(np.int32),
                                  np.asarray(jd).view(np.int32))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("shuffle", [False, True])
def test_make_blobs_labels_and_sizes(shuffle):
    jd, jl = jrnd.make_blobs(1003, 8, n_clusters=10, shuffle=shuffle)
    td, tl = trnd.make_blobs(1003, 8, n_clusters=10, shuffle=shuffle,
                             rng=trnd.RngState(3, device="cpu"))
    assert td.shape == (1003, 8) and tuple(jd.shape) == (1003, 8)
    np.testing.assert_array_equal(np.bincount(tl.numpy(), minlength=10),
                                  np.bincount(np.asarray(jl), minlength=10))
    if not shuffle:
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    else:
        assert not np.array_equal(tl.numpy(), np.arange(1003) % 10)


def test_make_blobs_cluster_moments():
    """Per cluster, the mean lies within 3σ/√n of its center, every
    coordinate's std within 3% of ``cluster_std``, and the centers inside
    ``center_box``."""
    std, n, k, d = 3.0, 40_000, 4, 16
    centers = trnd.uniform(trnd.RngState(5, device="cpu"), (k, d), -10, 10)
    x, lab = trnd.make_blobs(n, d, cluster_std=std, centers=centers,
                             rng=trnd.RngState(6, device="cpu"))
    for c in range(k):
        rows = x[lab == c].double()
        m = rows.shape[0]
        assert m == n // k
        dev = (rows.mean(0) - centers[c].double()).abs().max()
        assert dev < 3 * std / math.sqrt(m) * 1.5
        s = rows.std(0)
        assert ((s - std).abs() < 0.03 * std).all()
    own, _ = trnd.make_blobs(500, d, n_clusters=3, device="cpu")
    assert own.abs().max() < 10 + 6 * 1.0


def test_rng_state_deterministic_fork_and_device():
    a = trnd.uniform(trnd.RngState(7, device="cpu"), (64,))
    b = trnd.uniform(trnd.RngState(7, device="cpu"), (64,))
    assert torch.equal(a, b)
    st = trnd.RngState(7, device="cpu")
    first, second = trnd.normal(st, (64,)), trnd.normal(st, (64,))
    assert not torch.equal(first, second)         # each draw advances
    f1 = trnd.uniform(st.fork(1), (64,))
    f1b = trnd.uniform(trnd.RngState(7, 1, device="cpu"), (64,))
    f2 = trnd.uniform(st.fork(2), (64,))
    assert torch.equal(f1, f1b) and not torch.equal(f1, f2)
    assert not torch.equal(f1, a)                 # stream 1 is not stream 0
    assert st.fork(3).device == torch.device("cpu")
    assert trnd.permute(st, 10).device.type == "cpu"


def test_rng_state_needs_a_card_or_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RaftError, match="no CUDA device"):
        trnd.RngState(0)
    with pytest.raises(RaftError, match="no CUDA device"):
        trnd.make_blobs(10, 2)


def _moments_ok(x, mean, std):
    x = x.double()
    m, s = float(x.mean()), float(x.std())
    assert abs(m - mean) < 5 * std / math.sqrt(x.numel()), (m, mean)
    assert abs(s - std) < 0.02 * std, (s, std)


# name → (draw(state), mean, std)
DISTRIBUTIONS = {
    "uniform": (lambda s: trnd.uniform(s, (N_DRAWS,), -2.0, 4.0),
                1.0, 6 / math.sqrt(12)),
    "uniform_int": (lambda s: trnd.uniform_int(s, (N_DRAWS,), 3, 13),
                    7.5, math.sqrt((10 ** 2 - 1) / 12)),
    "normal": (lambda s: trnd.normal(s, (N_DRAWS,), 1.5, 2.0), 1.5, 2.0),
    "bernoulli": (lambda s: trnd.bernoulli(s, (N_DRAWS,), 0.3).float(),
                  0.3, math.sqrt(0.21)),
    "scaled_bernoulli": (lambda s: trnd.scaled_bernoulli(
        s, (N_DRAWS,), 0.25, 2.0), -1.0, 2 * math.sqrt(0.75)),
    "gumbel": (lambda s: trnd.gumbel(s, (N_DRAWS,), 1.0, 2.0),
               1.0 + 2.0 * 0.5772156649, math.pi / math.sqrt(6) * 2.0),
    "lognormal": (lambda s: trnd.lognormal(s, (N_DRAWS,), 0.0, 0.5),
                  math.exp(0.125), math.sqrt((math.exp(0.25) - 1)
                                             * math.exp(0.25))),
    "logistic": (lambda s: trnd.logistic(s, (N_DRAWS,), -1.0, 0.5),
                 -1.0, 0.5 * math.pi / math.sqrt(3)),
    "exponential": (lambda s: trnd.exponential(s, (N_DRAWS,), 2.0),
                    0.5, 0.5),
    "rayleigh": (lambda s: trnd.rayleigh(s, (N_DRAWS,), 1.5),
                 1.5 * math.sqrt(math.pi / 2),
                 1.5 * math.sqrt((4 - math.pi) / 2)),
    "laplace": (lambda s: trnd.laplace(s, (N_DRAWS,), 2.0, 0.5),
                2.0, 0.5 * math.sqrt(2)),
    "discrete": (lambda s: trnd.discrete(s, (N_DRAWS,),
                                         [1.0, 0.0, 3.0]).float(),
                 1.5, math.sqrt(0.25 * 2.25 + 0.75 * 0.25)),
}


@pytest.mark.parametrize("name", sorted(DISTRIBUTIONS))
def test_distribution_moments(name):
    draw, mean, std = DISTRIBUTIONS[name]
    x = draw(trnd.RngState(11, device="cpu"))
    assert x.shape == (N_DRAWS,) and bool(torch.isfinite(x).all())
    _moments_ok(x, mean, std)
    if name == "uniform_int":
        assert int(x.min()) == 3 and int(x.max()) == 12
    if name == "discrete":
        assert not bool((x == 1).any())           # weight 0: never drawn
    if name == "scaled_bernoulli":
        assert set(x.unique().tolist()) == {-2.0, 2.0}


def test_multivariable_gaussian_moments():
    cov = np.array([[2.0, 0.6], [0.6, 1.0]], np.float32)
    x = trnd.multivariable_gaussian(trnd.RngState(12, device="cpu"), N_DRAWS,
                                    [1.0, -2.0], cov).double()
    assert x.shape == (N_DRAWS, 2)
    np.testing.assert_allclose(x.mean(0).numpy(), [1.0, -2.0], atol=0.02)
    np.testing.assert_allclose(np.cov(x.numpy().T), cov, atol=0.04)


def test_sample_without_replacement_and_permute():
    st = trnd.RngState(13, device="cpu")
    for _ in range(20):
        ids = trnd.sample_without_replacement(st, 50, n_population=80)
        assert ids.unique().numel() == 50 and 0 <= ids.min() < ids.max() < 80
    pool = torch.arange(100, 130)
    got = trnd.sample_without_replacement(st, 30, pool=pool)
    assert sorted(got.tolist()) == list(range(100, 130))
    # weights: a zero-weight member is never taken while others remain
    w = torch.ones(40)
    w[7] = 0.0
    for _ in range(20):
        ids = trnd.sample_without_replacement(st, 39, n_population=40,
                                              weights=w)
        assert 7 not in ids.tolist() and ids.unique().numel() == 39
    with pytest.raises(RaftError):
        trnd.sample_without_replacement(st, 81, n_population=80)
    p = trnd.permute(st, 1000)
    assert p.dtype == torch.int32 and sorted(p.tolist()) == list(range(1000))


def test_make_regression_linear_model():
    x, y, coef = trnd.make_regression(500, 6, n_informative=4, n_targets=2,
                                      bias=1.5, rng=trnd.RngState(
                                          14, device="cpu"))
    assert x.shape == (500, 6) and y.shape == (500, 2)
    assert bool((coef[4:] == 0).all()) and bool((coef[:4] > 0).all())
    torch.testing.assert_close(y, x @ coef + 1.5)


def test_rmat_within_bounds():
    st = trnd.RngState(15, device="cpu")
    theta = [0.57, 0.19, 0.19, 0.05]
    src, dst = trnd.rmat_rectangular_generator(st, theta, 10, 6, 50_000)
    assert src.dtype == torch.int32 and dst.dtype == torch.int32
    assert int(src.min()) >= 0 and int(src.max()) < 1 << 10
    assert int(dst.min()) >= 0 and int(dst.max()) < 1 << 6
    # R-MAT skew: row 0 (every level's top half) is the most frequent
    counts = torch.bincount(src.long(), minlength=1 << 10)
    assert int(counts.argmax()) == 0
    # the JAX generator's law on the same levels: the mean row bit at the
    # top level is P(bottom) = c + d
    top = (src >> 9).float().mean()
    assert abs(float(top) - 0.24) < 0.01
    jsrc, jdst = jrnd.rmat_rectangular_generator(
        jrnd.RngState(0), np.asarray(theta, np.float32), 10, 6, 50_000)
    assert abs(float(np.mean(np.asarray(jsrc) >> 9)) - float(top)) < 0.01
