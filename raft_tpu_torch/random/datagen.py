"""Dataset generators: counterpart of ``raft_tpu/random/datagen.py``
(raft/random/make_blobs.cuh, make_regression.cuh,
rmat_rectangular_generator.cuh).

The arithmetic is the JAX package's: ``centers[labels] + cluster_std *
noise``, equal-sized clusters by ``arange % n_clusters``, then a
permutation when ``shuffle``. With given centers, ``cluster_std=0`` and
no shuffle, ``make_blobs`` equals JAX's bit for bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.errors import expects
from .rng import RngState, normal, permute, uniform

__all__ = ["make_blobs", "make_regression", "rmat_rectangular_generator"]


def _state(rng, device) -> RngState:
    return rng if isinstance(rng, RngState) else RngState(int(rng),
                                                          device=device)


def make_blobs(
    n_samples: int,
    n_features: int,
    n_clusters: int = 5,
    cluster_std: float = 1.0,
    centers=None,
    center_box: Tuple[float, float] = (-10.0, 10.0),
    shuffle: bool = True,
    rng: RngState | int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Isotropic Gaussian blobs → (data (n, d) float32, labels (n,) int32)
    on the state's device (an int ``rng`` seeds a state on ``device``,
    the CUDA card by default). Centers uniform in ``center_box`` unless
    given."""
    rng = _state(rng, device)
    dev = rng.device
    if centers is None:
        centers = uniform(rng, (n_clusters, n_features), center_box[0],
                          center_box[1])
    else:
        centers = torch.as_tensor(centers, dtype=torch.float32, device=dev)
        n_clusters = centers.shape[0]
    labels = torch.arange(n_samples, device=dev) % n_clusters
    noise = cluster_std * normal(rng, (n_samples, n_features))
    data = centers[labels] + noise
    labels = labels.to(torch.int32)
    if shuffle:
        perm = permute(rng, n_samples).long()
        data, labels = data[perm], labels[perm]
    return data, labels


def make_regression(
    n_samples: int,
    n_features: int,
    n_informative: Optional[int] = None,
    n_targets: int = 1,
    bias: float = 0.0,
    noise: float = 0.0,
    shuffle: bool = True,
    rng: RngState | int = 0,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear-model data → (X (n, d), y (n, t), coef (d, t))
    (make_regression.cuh)."""
    rng = _state(rng, device)
    n_informative = n_informative or n_features
    expects(n_informative <= n_features, "n_informative > n_features")
    x = normal(rng, (n_samples, n_features))
    coef = torch.zeros((n_features, n_targets), dtype=torch.float32,
                       device=rng.device)
    coef[:n_informative] = 100.0 * uniform(rng, (n_informative, n_targets))
    y = x @ coef + bias
    if noise > 0:
        y = y + noise * normal(rng, tuple(y.shape))
    if shuffle:
        perm = permute(rng, n_samples).long()
        x, y = x[perm], y[perm]
    return x, y, coef


def rmat_rectangular_generator(
    rng: RngState,
    theta,
    r_scale: int,
    c_scale: int,
    n_edges: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """R-MAT edge generator → (src (e,), dst (e,)) int32
    (rmat_rectangular_generator.cuh). ``theta``: (max(r_scale, c_scale),
    4) per-level quadrant probabilities [a, b, c, d] (a level past one
    side's scale splits the other side only), or one (4,) for every
    level."""
    dev = rng.device
    levels = max(r_scale, c_scale)
    theta = torch.as_tensor(theta, dtype=torch.float32, device=dev)
    if theta.dim() == 1:
        theta = theta.expand(levels, 4)
    expects(theta.shape[1] == 4, "theta must have 4 quadrant probs per level")
    u = uniform(rng, (n_edges, levels))          # one draw per level
    src = torch.zeros((n_edges,), dtype=torch.int32, device=dev)
    dst = torch.zeros((n_edges,), dtype=torch.int32, device=dev)
    for lvl in range(levels):
        a, b, c, d = (float(v) for v in theta[lvl])
        split_r, split_c = lvl < r_scale, lvl < c_scale
        x = u[:, lvl]
        if split_r and split_c:
            # quadrant by the cumulative [a, a+b, a+b+c]
            right = ((x >= a) & (x < a + b)) | (x >= a + b + c)
            bottom = x >= a + b
        elif split_r:
            bottom = x < (c + d) / max(a + b + c + d, 1e-30)
            right = torch.zeros_like(bottom)
        else:
            right = x < (b + d) / max(a + b + c + d, 1e-30)
            bottom = torch.zeros_like(right)
        if split_r:
            src = src * 2 + bottom.to(torch.int32)
        if split_c:
            dst = dst * 2 + right.to(torch.int32)
    return src, dst
