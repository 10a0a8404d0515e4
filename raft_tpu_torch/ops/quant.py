"""Per-row storage coding: counterpart of ``raft_tpu/ops/quant.py``
(``quantize_rows`` / ``dequantize_rows``) for the float32, bfloat16 and
int8 rungs. int8 is symmetric per row: ``scale = max(absmax, 1e-30) /
127`` and ``clip(round(x / scale), -127, 127)``, with ``torch.round``
rounding half to even as ``jnp.round`` does, so the codes and scales are
the JAX package's bit for bit. The uint8 and int4 rungs are not ported
yet."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.errors import expects

__all__ = ["quantize_rows", "dequantize_rows"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}


def quantize_rows(dataset: torch.Tensor, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 rows → (stored rows, per-row scales | None). ``dtype``: a
    torch dtype or its name (float32, bfloat16, int8); only int8 carries
    scales."""
    dtype = _DTYPES.get(dtype, dtype)
    expects(dtype in (torch.float32, torch.bfloat16, torch.int8),
            "store dtype must be float32/bfloat16/int8 (uint8 and int4 "
            "are not ported yet), got %s", dtype)
    dataset = dataset.to(torch.float32)
    if dtype != torch.int8:
        return dataset.to(dtype), None
    amax = dataset.abs().amax(dim=1)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(dataset / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(rows: torch.Tensor,
                    scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Stored rows → f32, applying per-row scales when present."""
    out = rows.to(torch.float32)
    if scales is not None:
        out = out * scales[..., None]
    return out
