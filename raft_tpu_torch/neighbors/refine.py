"""Candidate re-ranking: counterpart of ``raft_tpu/neighbors/refine.py``.

Given candidate lists (e.g. from ``ivf_pq.search`` with a larger k), the
exact distances against the original dataset are recomputed and the best
k kept: one gather, batched dot products (``torch.bmm``) and a select
(kernel K1 on CUDA, its plain version on the CPU). The JAX function has
no Pallas kernel. A bfloat16 or uint8 corpus is gathered in its own type
and widened to float32 after the gather; with a bfloat16 corpus the
queries enter the dot products rounded to bfloat16, as in the JAX
package, so the products are exact and only the float32 sums round.
-1 candidate ids (padding from an upstream search) are masked out.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.errors import expects
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..utils import resolve_device

__all__ = ["refine"]

_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.InnerProduct, DistanceType.CosineExpanded)


def refine(dataset, queries, candidates, k: int,
           metric: DistanceType | str = DistanceType.L2Expanded,
           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact re-rank: (m, c) candidate ids → (m, k) distances + int32 ids,
    on ``device`` (the CUDA card by default). Slots past the valid
    candidates hold (+inf, -1) (-inf for inner product)."""
    dev = resolve_device(device)
    x = torch.as_tensor(dataset).to(dev)
    if x.dtype not in (torch.bfloat16, torch.uint8):
        x = x.to(torch.float32)
    q = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    cand = torch.as_tensor(candidates).to(device=dev, dtype=torch.int64)
    mt = canonical_metric(metric)
    expects(mt in _METRICS, "refine supports L2/IP/cosine metrics, got %s",
            mt.name)
    expects(x.dim() == 2 and q.dim() == 2 and q.shape[1] == x.shape[1],
            "dim mismatch")
    expects(cand.dim() == 2 and cand.shape[0] == q.shape[0],
            "candidates must be (n_queries, n_candidates)")
    expects(0 < k <= cand.shape[1], "k %d > n_candidates %d", k,
            cand.shape[1])

    valid = cand >= 0
    rows = torch.where(valid, cand, 0)
    vecs = x[rows]                                   # (m, c, d)
    qd = q.to(torch.bfloat16) if vecs.dtype == torch.bfloat16 else q
    vecs = vecs.to(torch.float32)
    ip = torch.bmm(vecs, qd.to(torch.float32)[:, :, None])[:, :, 0]
    if mt is DistanceType.InnerProduct:
        dist = -ip
    elif mt is DistanceType.CosineExpanded:
        qn = torch.sqrt(torch.clamp_min((q * q).sum(dim=1, keepdim=True),
                                        1e-30))
        vn = torch.sqrt(torch.clamp_min((vecs * vecs).sum(dim=2), 1e-30))
        dist = 1.0 - ip / (qn * vn)
    else:
        q2 = (q * q).sum(dim=1, keepdim=True)
        dist = torch.clamp_min(q2 + (vecs * vecs).sum(dim=2) - 2.0 * ip, 0.0)
        if mt is DistanceType.L2SqrtExpanded:
            dist = torch.sqrt(dist)
    dist = torch.where(valid, dist, float("inf")).contiguous()
    vals, locs = select_k(dist, k, select_min=True)
    ids = torch.gather(rows, 1, locs.long())
    ids = torch.where(torch.isfinite(vals), ids, -1).to(torch.int32)
    if mt is DistanceType.InnerProduct:
        vals = torch.where(torch.isfinite(vals), -vals, -float("inf"))
    return vals, ids
