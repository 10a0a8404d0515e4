"""Nearest row under squared L2: counterpart of
``raft_tpu/distance/fused_l2_nn.py`` (``fused_l2_nn_argmin``).

The JAX version is an XLA scan, not a Pallas kernel, so this port is
plain PyTorch: ``torch.matmul`` in full float32 plus a row minimum, over
row chunks of ``x`` so the (chunk, n) block stays within a workspace.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..core.errors import expects

__all__ = ["fused_l2_nn_argmin"]

_WORKSPACE_BYTES = 256 << 20   # bound on one (chunk, n) distance block


def fused_l2_nn_argmin(x: torch.Tensor, y: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of ``x`` (m, d): index and squared distance of the
    nearest row of ``y`` (n, d). Returns (int64 indices (m,), float32
    distances (m,)); ties resolve to the smaller index."""
    expects(x.dim() == 2 and y.dim() == 2 and x.shape[1] == y.shape[1],
            "bad shapes %s %s", tuple(x.shape), tuple(y.shape))
    x = x.to(torch.float32)
    y = y.to(torch.float32)
    m, n = x.shape[0], y.shape[0]
    y2 = (y * y).sum(dim=1)
    chunk = int(max(1, min(m, _WORKSPACE_BYTES // max(n * 4, 1))))
    idx = torch.empty((m,), dtype=torch.int64, device=x.device)
    val = torch.empty((m,), dtype=torch.float32, device=x.device)
    for s0 in range(0, m, chunk):
        xc = x[s0 : s0 + chunk]
        x2 = (xc * xc).sum(dim=1)
        dist = torch.clamp_min(x2[:, None] + y2[None, :] - 2.0 * (xc @ y.T),
                               0.0)
        v, i = torch.min(dist, dim=1)
        val[s0 : s0 + chunk] = v
        idx[s0 : s0 + chunk] = i
    return idx, val
