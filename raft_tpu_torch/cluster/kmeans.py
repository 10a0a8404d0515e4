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

__all__ = ["predict", "segment_sum"]


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


def segment_sum(x: torch.Tensor, labels: torch.Tensor, k: int
                ) -> torch.Tensor:
    """(k, d) sums of the finite rows of ``x`` (n, d) by label, exact in
    fixed point, so any order of addition gives the same bits, on a card
    as on the CPU (a float ``index_add_`` adds with atomics on a card, in
    the order its threads arrive). Each column is scaled by the power of
    two that puts its largest magnitude under 2**(62 - bits(n)), rounded
    to int64 and summed there (n such terms stay under 2**62), then
    scaled back: float32 rows lose nothing to the rounding while
    n < 2**38."""
    n, d = x.shape
    top = x.abs().amax(dim=0) if n else x.new_zeros(d)
    shift = 62 - n.bit_length() - torch.frexp(top)[1].long()
    # the float64 2**shift, from its exponent bits
    scale = ((shift.clamp_max(1000) + 1023) << 52).view(torch.float64)
    q = (x * scale).round_().long()
    sums = torch.zeros((k, d), dtype=torch.int64, device=x.device)
    sums.index_add_(0, labels, q)
    return (sums.double() / scale).to(x.dtype)


def _update_centers(x: torch.Tensor, labels: torch.Tensor, k: int,
                    old_centers: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Segment-sum centroid update (:func:`segment_sum`); empty clusters
    keep their old center."""
    sums = segment_sum(x, labels, k)
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
