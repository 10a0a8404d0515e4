"""Per-row storage coding: counterpart of ``raft_tpu/ops/quant.py``
(``quantize_rows`` / ``dequantize_rows``), float32 storage only. The
bf16/int8/uint8/int4 rungs of the JAX package are not ported yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.errors import expects

__all__ = ["quantize_rows", "dequantize_rows"]


def quantize_rows(dataset: torch.Tensor, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 rows → (stored rows, per-row scales | None)."""
    expects(dtype in (torch.float32, "float32"),
            "only float32 storage is ported, got %s", dtype)
    return dataset.to(torch.float32), None


def dequantize_rows(rows: torch.Tensor,
                    scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Stored rows → f32, applying per-row scales when present."""
    out = rows.to(torch.float32)
    if scales is not None:
        out = out * scales[..., None]
    return out
