"""Per-row storage coding: counterpart of ``raft_tpu/ops/quant.py``
(``quantize_rows`` / ``dequantize_rows``, the int4 codec, the health
report's scale summary) for the float32, bfloat16, int8, uint8 and int4
rungs. The codes and scales are the JAX package's bit for bit:

* int8 is symmetric per row: ``scale = max(absmax, 1e-30) / 127`` and
  ``clip(round(x / scale), -127, 127)``, with ``torch.round`` rounding
  half to even as ``jnp.round`` does;
* uint8 stores byte-valued rows exactly (``clip(round(x), 0, 255)``, no
  scales) and refuses data that is not integral in [0, 255];
* int4 packs value ``j`` of a row in the low nibble of byte ``j`` and
  value ``j + half_p`` in its high nibble (split-half layout, ``half_p =``
  :func:`int4_half_width`), with ``scale = max(absmax, 1e-30) / 7`` and
  codes in [-7, 7]; the bytes are packed in int32 and reinterpreted, as
  JAX's ``astype(uint8).astype(int8)``, and unpacked by arithmetic
  shifts (:func:`int4_nibbles`).

The PQ row codecs are not ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import expects
from ..utils import cdiv, round_up_to

__all__ = ["STORES", "store_dtype", "quantize_rows", "dequantize_rows",
           "int8_scale_report", "int4_half_width", "quantize_int4",
           "int4_nibbles", "dequantize_int4", "dequantize_store"]

# store name -> the stored tensor's dtype (int4 bytes are int8)
STORES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "uint8": torch.uint8, "int4": torch.int8}


def store_dtype(dtype) -> str:
    """The store name of ``dtype``: a name of :data:`STORES` (``"i4"``
    too) or a torch dtype."""
    if dtype == "i4":
        return "int4"
    if isinstance(dtype, str):
        expects(dtype in STORES, "store dtype must be float32/bfloat16/"
                "int8/uint8/int4, got %s", dtype)
        return dtype
    names = {v: k for k, v in STORES.items() if k != "int4"}
    expects(dtype in names, "store dtype must be float32/bfloat16/int8/"
            "uint8/int4, got %s", dtype)
    return names[dtype]


def quantize_rows(dataset: torch.Tensor, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 rows → (stored rows, per-row scales | None). ``dtype``: a
    torch dtype or a store name (float32, bfloat16, int8, uint8, int4);
    int8 and int4 carry scales, int4 rows are ``(n, half_p)`` packed
    bytes (:func:`quantize_int4`)."""
    store = store_dtype(dtype)
    dataset = dataset.to(torch.float32)
    if store == "int4":
        return quantize_int4(dataset)
    if store in ("float32", "bfloat16"):
        return dataset.to(STORES[store]), None
    if store == "uint8":
        q = torch.clamp(torch.round(dataset), 0, 255)
        # clamping float data silently would collapse recall; scaled
        # float data belongs in int8
        expects(bool(((dataset - q).abs() < 1e-3).all()),
                "uint8 storage expects byte-valued data (integral in "
                "[0, 255]); use dtype='int8' for scaled float data")
        return q.to(torch.uint8), None
    amax = dataset.abs().amax(dim=1)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(dataset / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(rows: torch.Tensor,
                    scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Stored rows (not int4-packed) → f32, applying per-row scales when
    present."""
    out = rows.to(torch.float32)
    if scales is not None:
        out = out * scales[..., None]
    return out


def int8_scale_report(scales) -> dict:
    """Sampled per-row scale stats for a health report: the quantization
    step bound ``max_scale / 2`` per component (the f32 originals are not
    kept), as the JAX package reports it."""
    sc = np.asarray(torch.as_tensor(scales).cpu(), np.float64)
    return {"int8": {
        "mean_scale": round(float(sc.mean()), 6),
        "max_scale": round(float(sc.max()), 6),
        "max_abs_err_bound": round(float(sc.max()) / 2.0, 6)}}


def int4_half_width(dim: int) -> int:
    """Packed byte width of a ``dim``-wide int4 row: ``ceil(dim / 2)``
    rounded up to a multiple of 64, so the query split into its (low,
    high) halves is ``2·half_p`` wide, a multiple of 128."""
    return round_up_to(cdiv(dim, 2), 64)


def quantize_int4(dataset: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rows → (packed (n, half_p) int8, per-row scales (n,) f32), the
    split-half layout of the module docstring (missing tail components
    are zero)."""
    dataset = dataset.to(torch.float32)
    n, dim = dataset.shape
    half = int4_half_width(dim)
    amax = dataset.abs().amax(dim=1)
    scale = torch.clamp_min(amax, 1e-30) / 7.0
    q = torch.clamp(torch.round(dataset / scale[:, None]), -7, 7)
    q = torch.nn.functional.pad(q, (0, 2 * half - dim)).to(torch.int32)
    packed = (q[:, :half] & 0xF) | ((q[:, half:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def int4_nibbles(packed: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int4 bytes → (low, high) f32 nibble planes, sign-extended:
    ``(w << 28) >> 28`` and ``(w << 24) >> 28`` on the bytes widened to
    int32 (arithmetic shifts)."""
    w = packed.to(torch.int32)
    low = ((w << 28) >> 28).to(torch.float32)
    high = ((w << 24) >> 28).to(torch.float32)
    return low, high


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Packed (n, half_p) int4 rows → (n, dim) f32."""
    low, high = int4_nibbles(packed)
    full = torch.cat([low, high], dim=-1)[..., :dim]
    return full * scales[..., None]


def dequantize_store(rows: torch.Tensor, scales: Optional[torch.Tensor],
                     logical_dim: Optional[int] = None) -> torch.Tensor:
    """Any store's rows → f32: int4-packed rows when ``logical_dim`` is
    given, else :func:`dequantize_rows`."""
    if logical_dim is not None:
        return dequantize_int4(rows, scales, logical_dim)
    return dequantize_rows(rows, scales)
