"""Lloyd's k-means pieces the balanced trainer calls: counterpart of
``raft_tpu/cluster/kmeans.py`` (``_plus_plus``, ``_update_centers``,
``_lloyd``, ``predict``).

Randomness comes from an explicit ``torch.Generator``; it gives other
numbers than ``jax.random`` from the same seed, so a build here matches a
JAX build in quality (recall), not bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..distance.fused_l2_nn import fused_l2_nn_argmin

__all__ = ["predict"]


def _plus_plus(gen: torch.Generator, x: torch.Tensor, k: int
               ) -> torch.Tensor:
    """Exact k-means++ D² sampling, one center per step."""
    n = x.shape[0]
    first = int(torch.randint(0, n, (1,), generator=gen,
                              device=gen.device).item())
    centers = torch.empty((k, x.shape[1]), dtype=x.dtype, device=x.device)
    centers[0] = x[first]
    min_d2 = torch.full((n,), float("inf"), dtype=torch.float32,
                        device=x.device)
    for i in range(k - 1):
        d2 = ((x - centers[i][None, :]) ** 2).sum(dim=1)
        min_d2 = torch.minimum(min_d2, d2)
        probs = min_d2 / torch.clamp_min(min_d2.sum(), 1e-30)
        pick = torch.multinomial(probs.clamp_min(1e-30), 1, generator=gen)
        centers[i + 1] = x[pick[0]]
    return centers


def _update_centers(x: torch.Tensor, labels: torch.Tensor, k: int,
                    old_centers: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-sum centroid update; empty clusters keep their old
    center."""
    sums = torch.zeros((k, x.shape[1]), dtype=x.dtype, device=x.device)
    sums.index_add_(0, labels, x)
    counts = torch.bincount(labels, minlength=k).to(x.dtype)
    centers = sums / torch.clamp_min(counts, 1.0)[:, None]
    return torch.where((counts > 0)[:, None], centers, old_centers), counts


def _lloyd(x: torch.Tensor, centers: torch.Tensor, max_iter: int,
           tol: float):
    """Lloyd iterations until the squared center shift is at most
    ``tol`` → (centers, labels, inertia, n_iter)."""
    k = centers.shape[0]
    it = 0
    shift = float("inf")
    while shift > tol and it < max_iter:
        labels, _ = fused_l2_nn_argmin(x, centers)
        new_centers, _ = _update_centers(x, labels, k, centers)
        shift = float(((new_centers - centers) ** 2).sum())
        centers = new_centers
        it += 1
    labels, d2 = fused_l2_nn_argmin(x, centers)
    return centers, labels, d2.sum(), it


def predict(x: torch.Tensor, centroids: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Labels + per-sample squared distance (kmeans::predict)."""
    return fused_l2_nn_argmin(x, centroids)
