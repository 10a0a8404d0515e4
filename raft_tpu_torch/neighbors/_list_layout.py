"""Inverted-list layout: counterpart of
``raft_tpu/neighbors/_list_layout.py`` (``count_sizes``, ``plan_offsets``,
``_dest_rows``, ``scatter_build``, ``list_skew``).

Lists are contiguous row ranges of one dense array, each list's start
aligned to 8 rows. Inside a list, rows keep their input order (a stable
sort by label), the order the JAX package gives them: the scan kernel
breaks distance ties by row, so the order is part of the result.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

__all__ = ["count_sizes", "plan_offsets", "scatter_build", "list_skew"]

_ALIGN = 8


def count_sizes(labels: torch.Tensor, n_lists: int) -> np.ndarray:
    """Per-list row counts, on the host."""
    return torch.bincount(labels, minlength=n_lists).cpu().numpy().astype(
        np.int64)


def plan_offsets(sizes: np.ndarray) -> np.ndarray:
    """(n_lists+1,) offsets, each list's capacity its size rounded up to
    the alignment."""
    caps = (sizes.astype(np.int64) + _ALIGN - 1) // _ALIGN * _ALIGN
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(caps, out=offsets[1:])
    return offsets


def _dest_rows(labels: torch.Tensor, sizes: np.ndarray,
               offsets: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, dest): input rows in list order, and the destination row of
    each: offset[l] + rank within l."""
    dev = labels.device
    order = torch.argsort(labels, stable=True)
    lsort = labels[order]
    starts = np.zeros(len(sizes), np.int64)
    if len(sizes) > 1:
        np.cumsum(sizes[:-1], out=starts[1:])
    rank = (torch.arange(labels.shape[0], dtype=torch.int64, device=dev)
            - torch.as_tensor(starts, device=dev)[lsort])
    dest = torch.as_tensor(offsets[:-1], device=dev)[lsort] + rank
    return order, dest


def scatter_build(labels: torch.Tensor, arrays: Sequence[torch.Tensor],
                  fills: Sequence, n_lists: int
                  ) -> Tuple[list, np.ndarray, np.ndarray]:
    """Cluster-sort ``arrays`` into a fresh layout → ([arrays
    (cap_total, ...)], offsets (n_lists+1,), sizes (n_lists,))."""
    sizes = count_sizes(labels, n_lists)
    offsets = plan_offsets(sizes)
    order, dest = _dest_rows(labels, sizes, offsets)
    cap_total = int(offsets[-1])
    out = []
    for arr, fill in zip(arrays, fills):
        buf = torch.full((cap_total,) + tuple(arr.shape[1:]), fill,
                         dtype=arr.dtype, device=arr.device)
        buf[dest] = arr[order]
        out.append(buf)
    return out, offsets, sizes


def list_skew(sizes: np.ndarray) -> dict:
    """List-size skew for the IVF health reports: the row count, min,
    mean, p99 and max list size, their coefficient of variation, max over
    mean, and the empty lists."""
    s = np.asarray(sizes, np.float64)
    if s.size == 0 or s.sum() == 0:
        return {"n_lists": int(s.size), "rows": 0,
                "empty_lists": int(s.size)}
    mean = float(s.mean())
    return {
        "n_lists": int(s.size),
        "rows": int(s.sum()),
        "min": int(s.min()),
        "mean": round(mean, 1),
        "p99": int(np.percentile(s, 99)),
        "max": int(s.max()),
        "cv": round(float(s.std() / max(mean, 1e-30)), 4),
        "max_over_mean": round(float(s.max() / max(mean, 1e-30)), 2),
        "empty_lists": int((s == 0).sum()),
    }
