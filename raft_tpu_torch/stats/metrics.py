"""ANN quality metrics: counterpart of ``raft_tpu/stats/metrics.py``
(``neighborhood_recall``)."""
from __future__ import annotations

import torch

from ..core.errors import expects

__all__ = ["neighborhood_recall"]


def neighborhood_recall(indices, ref_indices, distances=None,
                        ref_distances=None, eps: float = 1e-4) -> float:
    """Recall of ``indices`` (m, k) against ground truth ``ref_indices``
    (m, k): the share of (query, slot) pairs whose id appears in the
    query's reference row. When both distance arrays are given, a slot
    whose distance lies within ``eps`` of a reference distance also counts
    (the tied-distance relaxation). Returns a Python float."""
    idx = torch.as_tensor(indices)
    ref = torch.as_tensor(ref_indices).to(idx.device)
    expects(idx.shape == ref.shape, "shape mismatch %s vs %s",
            tuple(idx.shape), tuple(ref.shape))
    match = (idx[:, :, None] == ref[:, None, :]).any(dim=2)
    if distances is not None and ref_distances is not None:
        d = torch.as_tensor(distances).to(idx.device)
        rd = torch.as_tensor(ref_distances).to(idx.device)
        tie = ((d[:, :, None] - rd[:, None, :]).abs() <= eps).any(dim=2)
        match = match | tie
    return float(match.to(torch.float32).mean())
