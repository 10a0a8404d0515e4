"""RngState and the distribution generators: counterpart of
``raft_tpu/random/rng.py`` (raft/random/rng.cuh:50-418).

The JAX package splits threefry keys; here an :class:`RngState` holds one
``torch.Generator`` on an explicit device, seeded from (seed, stream), and
every draw advances it, as the reference's stateful generators do. The
streams cannot equal JAX's bits: the distributions are held to their
contracts (moments, supports, no repeats) instead.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.errors import expects
from ..utils import resolve_device

__all__ = [
    "RngState", "uniform", "uniform_int", "normal", "bernoulli",
    "scaled_bernoulli", "gumbel", "lognormal", "logistic", "exponential",
    "rayleigh", "laplace", "discrete", "sample_without_replacement",
    "permute", "multivariable_gaussian",
]


class RngState:
    """Seed + stream state (rng_state.hpp:29-52) on ``device`` (the CUDA
    card by default). ``fork(stream)`` gives the deterministic state of
    another stream of the same seed."""

    def __init__(self, seed: int = 0, stream: int = 0, device=None):
        self.seed = int(seed)
        self.stream = int(stream)
        self.device = resolve_device(device)
        # (seed, stream) mixed into one 63-bit seed
        mixed = np.random.SeedSequence(
            [self.seed, self.stream]).generate_state(1, np.uint64)[0]
        self.gen = torch.Generator(device=self.device).manual_seed(
            int(mixed) & ((1 << 63) - 1))

    def fork(self, stream: int) -> "RngState":
        return RngState(self.seed, stream, self.device)


def _open01(rng: RngState, shape, dtype=torch.float32) -> torch.Tensor:
    """Uniform in (0, 1): the smallest normal number for 0."""
    u = torch.rand(shape, generator=rng.gen, device=rng.device, dtype=dtype)
    return torch.clamp_min(u, torch.finfo(dtype).tiny)


def uniform(rng: RngState, shape, low=0.0, high=1.0, dtype=torch.float32):
    u = torch.rand(shape, generator=rng.gen, device=rng.device, dtype=dtype)
    return u * (high - low) + low


def uniform_int(rng: RngState, shape, low, high, dtype=torch.int32):
    return torch.randint(low, high, shape, generator=rng.gen,
                         device=rng.device, dtype=torch.int64).to(dtype)


def normal(rng: RngState, shape, mu=0.0, sigma=1.0, dtype=torch.float32):
    return mu + sigma * torch.randn(shape, generator=rng.gen,
                                    device=rng.device, dtype=dtype)


def bernoulli(rng: RngState, shape, prob=0.5):
    return torch.rand(shape, generator=rng.gen, device=rng.device) < prob


def scaled_bernoulli(rng: RngState, shape, prob=0.5, scale=1.0,
                     dtype=torch.float32):
    """±scale with P(+) = prob (rng.cuh scaled_bernoulli)."""
    b = bernoulli(rng, shape, prob)
    return torch.where(b, scale, -scale).to(dtype)


def gumbel(rng: RngState, shape, mu=0.0, beta=1.0, dtype=torch.float32):
    return mu - beta * torch.log(-torch.log(_open01(rng, shape, dtype)))


def lognormal(rng: RngState, shape, mu=0.0, sigma=1.0, dtype=torch.float32):
    return torch.exp(normal(rng, shape, mu, sigma, dtype))


def logistic(rng: RngState, shape, mu=0.0, scale=1.0, dtype=torch.float32):
    u = _open01(rng, shape, dtype)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def exponential(rng: RngState, shape, lam=1.0, dtype=torch.float32):
    return -torch.log1p(-uniform(rng, shape, dtype=dtype)) / lam


def rayleigh(rng: RngState, shape, sigma=1.0, dtype=torch.float32):
    u = uniform(rng, shape, 1e-12, 1.0, dtype)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def laplace(rng: RngState, shape, mu=0.0, scale=1.0, dtype=torch.float32):
    """Inverse CDF of a uniform in (-1, 1)."""
    u = 2.0 * _open01(rng, shape, dtype) - 1.0
    return mu - scale * torch.sign(u) * torch.log1p(-u.abs())


def discrete(rng: RngState, shape, weights):
    """Indices drawn with the given (unnormalized) weights."""
    w = torch.as_tensor(weights, dtype=torch.float32, device=rng.device)
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    n = int(np.prod(shape))
    out = torch.multinomial(torch.clamp_min(w, 1e-30), n, replacement=True,
                            generator=rng.gen)
    return out.reshape(shape).to(torch.int32)


def sample_without_replacement(
    rng: RngState, n_samples: int, pool: Optional[torch.Tensor] = None,
    n_population: Optional[int] = None,
    weights: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Weighted sampling without replacement (rng.cuh:338) by one
    Gumbel-top-k pass over the log-weights (uniform keys without
    weights): a single sort, no rejection loop."""
    if pool is not None:
        pool = torch.as_tensor(pool, device=rng.device)
        n_pop = pool.shape[0]
    else:
        expects(n_population is not None, "need pool or n_population")
        n_pop = int(n_population)
    expects(0 < n_samples <= n_pop,
            "n_samples %d out of range for population %d", n_samples, n_pop)
    if weights is None:
        scores = uniform(rng, (n_pop,))
    else:
        w = torch.as_tensor(weights, dtype=torch.float32, device=rng.device)
        scores = -(torch.log(torch.clamp_min(w, 1e-30))
                   + gumbel(rng, (n_pop,)))
    idx = torch.argsort(scores, stable=True)[:n_samples].to(torch.int32)
    return pool[idx.long()] if pool is not None else idx


def permute(rng: RngState, n: int) -> torch.Tensor:
    """Random permutation of [0, n) (permute.cuh)."""
    return torch.randperm(n, generator=rng.gen, device=rng.device).to(
        torch.int32)


def multivariable_gaussian(rng: RngState, n_samples: int, mean, cov
                           ) -> torch.Tensor:
    """(n_samples, d) draws from N(mean, cov): the Cholesky factor of cov
    times standard normals (random/multi_variable_gaussian.cuh)."""
    mean = torch.as_tensor(mean, dtype=torch.float32, device=rng.device)
    cov = torch.as_tensor(cov, dtype=torch.float32, device=rng.device)
    d = mean.shape[0] if mean.dim() == 1 else -1
    expects(mean.dim() == 1 and tuple(cov.shape) == (d, d),
            "bad mean/cov shapes %s %s", tuple(mean.shape), tuple(cov.shape))
    chol = torch.linalg.cholesky(cov)
    return mean + normal(rng, (n_samples, d)) @ chol.T
