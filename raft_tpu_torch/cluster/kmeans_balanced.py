"""Hierarchical balanced k-means, the IVF coarse-quantizer trainer:
counterpart of ``raft_tpu/cluster/kmeans_balanced.py``
(``BalancedKMeansParams``, ``fit``, ``predict``).

Same hierarchy as the JAX package (and raft's ``build_hierarchical``):
about sqrt(n_clusters) mesoclusters trained first, a proportional share of
fine centers seeded inside each mesocluster from its own points, then all
fine centers polished jointly by Lloyd steps with ``adjust_centers``
re-balancing rounds. Randomness comes from ``torch.Generator``s made from
``seed`` (the fine seeding uses numpy's generator, as the JAX package
does).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from ..core.errors import expects
from ..distance.fused_l2_nn import fused_l2_nn_argmin
from .kmeans import _lloyd, _plus_plus, _update_centers

__all__ = ["BalancedKMeansParams", "fit", "predict", "adjust_centers"]


@dataclasses.dataclass
class BalancedKMeansParams:
    """Mirror of kmeans_balanced_params (kmeans_balanced.cuh)."""

    n_iters: int = 20              # per-level Lloyd iterations
    seed: int = 0
    # adjust_centers threshold: clusters smaller than avg/ratio re-seed
    balancing_pessimism: float = 2.5
    balancing_rounds: int = 4
    max_train_points: int = 1 << 20  # subsample bound for training


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def adjust_centers(centers, counts, x, labels, threshold_ratio: float,
                   gen: torch.Generator):
    """Re-seed clusters smaller than avg/ratio near points of large
    clusters (sampling weight = size of the point's cluster), nudged
    1e-3 of the way back toward the old center."""
    k = centers.shape[0]
    avg = x.shape[0] / k
    small = counts < (avg / threshold_ratio)
    w = counts[labels]
    probs = w / torch.clamp_min(w.sum(), 1e-30)
    picks = torch.multinomial(probs.clamp_min(1e-30), k, replacement=True,
                              generator=gen)
    donors = x[picks]
    new_centers = donors + 1e-3 * (donors - centers)
    return torch.where(small[:, None], new_centers, centers), small.sum()


def _lloyd_steps(x, centers, n_steps: int):
    k = centers.shape[0]
    for _ in range(n_steps):
        labels, _ = fused_l2_nn_argmin(x, centers)
        centers, _ = _update_centers(x, labels, k, centers)
    return centers


def _balanced_lloyd(x, centers, n_iters: int, rounds: int,
                    pessimism: float, gen: torch.Generator):
    """Lloyd iterations with periodic adjust_centers re-balancing."""
    k = centers.shape[0]
    for _ in range(rounds):
        centers = _lloyd_steps(x, centers, n_iters)
        labels, _ = fused_l2_nn_argmin(x, centers)
        counts = torch.bincount(labels, minlength=k).to(torch.float32)
        centers, _ = adjust_centers(centers, counts, x, labels, pessimism,
                                    gen)
    # final polish without a trailing re-seed
    return _lloyd_steps(x, centers, n_iters // 2 + 1)


def fit(x: torch.Tensor, n_clusters: int,
        params: BalancedKMeansParams | None = None) -> torch.Tensor:
    """Train ``n_clusters`` balanced centroids → (n_clusters, d) on
    ``x``'s device."""
    p = params or BalancedKMeansParams()
    x = x.to(torch.float32)
    n, _ = x.shape
    expects(0 < n_clusters <= n, "bad n_clusters %d for n=%d", n_clusters, n)
    if n > p.max_train_points:
        stride = n // p.max_train_points
        x = x[::stride][: p.max_train_points]
        n = x.shape[0]
    gen = _generator(p.seed, x.device)

    if n_clusters <= 4:
        centers, *_ = _lloyd(x, _plus_plus(gen, x, n_clusters), p.n_iters,
                             1e-6)
        return centers

    # level 1: mesoclusters
    n_meso = max(2, int(math.sqrt(n_clusters)))
    meso_centers, *_ = _lloyd(x, _plus_plus(gen, x, n_meso), p.n_iters,
                              1e-6)
    meso_labels, _ = fused_l2_nn_argmin(x, meso_centers)

    # proportional fine-cluster allocation (host side: n_meso numbers)
    counts = torch.bincount(meso_labels, minlength=n_meso).cpu().numpy()
    counts = counts.astype(np.float64)
    alloc = np.maximum(1, np.floor(counts / counts.sum() * n_clusters)
                       ).astype(int)
    while alloc.sum() < n_clusters:
        alloc[np.argmax(counts / alloc)] += 1
    while alloc.sum() > n_clusters:
        i = np.argmax(alloc)
        if alloc[i] <= 1:
            break
        alloc[i] -= 1

    # level 2: seed each mesocluster's fine centers from a random sample
    # of its own points (a meso-sorted row order + one gather)
    order = torch.argsort(meso_labels, stable=True)
    starts = np.concatenate([[0], np.cumsum(counts.astype(np.int64))[:-1]])
    seed_rng = np.random.default_rng(p.seed ^ 0x9E3779B9)
    pos = np.zeros(n_clusters, np.int64)
    slot_meso = np.repeat(np.arange(n_meso), alloc)
    valid = np.zeros(n_clusters, bool)
    s = 0
    for mi in range(n_meso):
        km, cm = int(alloc[mi]), int(counts[mi])
        if cm > 0:
            if cm > km:
                local = seed_rng.choice(cm, km, replace=False)
            else:
                local = np.arange(km) % cm
            pos[s : s + km] = starts[mi] + local
            valid[s : s + km] = True
        s += km
    dev = x.device
    picks = order[torch.as_tensor(pos, device=dev)]
    centers0 = torch.where(torch.as_tensor(valid, device=dev)[:, None],
                           x[picks],
                           meso_centers[torch.as_tensor(slot_meso,
                                                        device=dev)])
    return _balanced_lloyd(x, centers0, p.n_iters, p.balancing_rounds,
                           p.balancing_pessimism,
                           _generator(p.seed + 17, dev))


def predict(x: torch.Tensor, centroids: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label assignment (kmeans_balanced::predict) → (labels, sq dists)."""
    return fused_l2_nn_argmin(x, centroids)
