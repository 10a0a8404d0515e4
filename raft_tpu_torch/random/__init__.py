"""Random generation: counterpart of ``raft_tpu/random/`` (rng_state.hpp,
rng.cuh, make_blobs.cuh, make_regression.cuh,
rmat_rectangular_generator.cuh, permute.cuh).

``RngState`` holds a ``torch.Generator`` on an explicit device; the
distributions and the dataset generators the bench harness uses draw from
it.
"""
from .datagen import make_blobs, make_regression, rmat_rectangular_generator
from .rng import (RngState, bernoulli, discrete, exponential, gumbel,
                  laplace, logistic, lognormal, multivariable_gaussian,
                  normal, permute, rayleigh, sample_without_replacement,
                  scaled_bernoulli, uniform, uniform_int)

__all__ = [
    "RngState", "uniform", "uniform_int", "normal", "bernoulli",
    "scaled_bernoulli", "gumbel", "lognormal", "logistic", "exponential",
    "rayleigh", "laplace", "discrete", "sample_without_replacement",
    "permute", "multivariable_gaussian", "make_blobs", "make_regression",
    "rmat_rectangular_generator",
]
