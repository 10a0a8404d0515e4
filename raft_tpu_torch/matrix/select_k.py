"""Batched top-k selection: counterpart of ``raft_tpu/matrix/select_k.py``.

Returns the k smallest (or largest) entries of each row, best first, with
ties going to the lowest column — the order of the JAX package's
``lax.top_k`` and of its Pallas k-pass kernel. Two engines:

* ``KPASS`` — kernel K1 (``csrc/select_k.cu``), the port of the Pallas
  ``_kpass_2d``. :func:`kpass_select_k` launches it for a CUDA tensor and
  takes the plain version for a CPU tensor.
* ``TOPK`` — the plain version, :func:`select_k_plain`: a stable sort and
  a slice (``torch.topk`` is not used: its tie order is unspecified).

``AUTO`` is the kernel on CUDA and the plain version on the CPU. The JAX
package's ``RADIX`` alias of ``TOPK`` is not carried over.
"""
from __future__ import annotations

import enum
from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..ops import _cuda

__all__ = ["SelectAlgo", "select_k", "select_k_plain", "kpass_select_k"]

launches = 0   # K1 launches since the last reset


class SelectAlgo(enum.Enum):
    """Mirror of raft/matrix/select_k_types.hpp:36."""

    AUTO = "auto"
    TOPK = "topk"        # plain stable sort
    KPASS = "kpass"      # kernel K1 on CUDA


def select_k_plain(values: torch.Tensor, k: int, select_min: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K1: stable sort of each row, first k columns."""
    v = values if select_min else -values
    sv, si = torch.sort(v, dim=-1, stable=True)
    sv = sv[..., :k]
    return (sv if select_min else -sv), si[..., :k].to(torch.int32)


def kpass_select_k(values: torch.Tensor, k: int, select_min: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K1 on a (rows, n) float32 tensor → (values, int32 columns)
    (rows, k). A CPU tensor takes the plain version."""
    global launches
    if values.device.type == "cpu":
        return select_k_plain(values, k, select_min)
    expects(values.is_cuda, "select_k kernel needs a CUDA tensor, got %s",
            values.device)
    expects(values.dtype == torch.float32 and values.dim() == 2
            and values.is_contiguous(),
            "select_k kernel takes a contiguous 2-D float32 tensor, got "
            "%s %s", values.dtype, tuple(values.shape))
    rows, n = values.shape
    expects(0 < k <= n, "k=%d out of range for row length %d", k, n)
    ov = torch.empty((rows, k), dtype=torch.float32, device=values.device)
    oi = torch.empty((rows, k), dtype=torch.int32, device=values.device)
    if rows == 0:
        return ov, oi
    lib = _cuda.library("select_k")
    status = lib.raft_select_k(values.data_ptr(), rows, n, k,
                               int(select_min), ov.data_ptr(), oi.data_ptr(),
                               _cuda.stream_of(values))
    _cuda.check(status, "select_k")
    launches += 1
    return ov, oi


def select_k(values: torch.Tensor, k: int, select_min: bool = True,
             indices: Optional[torch.Tensor] = None,
             algo: SelectAlgo | str = SelectAlgo.AUTO
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row k smallest (or largest) of ``values`` (..., n).

    Returns (values (..., k), int32 indices (..., k)), sorted best first.
    ``indices`` optionally maps positions to global ids."""
    algo = SelectAlgo(algo) if not isinstance(algo, SelectAlgo) else algo
    n = values.shape[-1]
    expects(0 < k <= n, "k=%d out of range for row length %d", k, n)
    if algo is SelectAlgo.AUTO or algo is SelectAlgo.KPASS:
        lead = values.shape[:-1]
        flat = values.reshape(-1, n).to(torch.float32).contiguous()
        vals, idxs = kpass_select_k(flat, k, select_min)
        vals = vals.reshape(*lead, k).to(values.dtype)
        idxs = idxs.reshape(*lead, k)
    else:
        vals, idxs = select_k_plain(values, k, select_min)
    if indices is not None:
        idxs = torch.gather(indices, -1, idxs.long()).to(torch.int32)
    return vals, idxs
