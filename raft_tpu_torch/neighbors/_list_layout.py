"""Inverted-list layout: counterpart of
``raft_tpu/neighbors/_list_layout.py`` (``count_sizes``, ``plan_offsets``,
``_dest_rows``, ``scatter_build``, ``scatter_extend``, ``gather_dense``,
``streaming_build``, ``list_skew``; ``dense_offsets`` and
``span_labels`` are the port's own).

Lists are contiguous row ranges of one dense array, each list's start
aligned to 8 rows, with optional *capacity slack*: a list's capacity is
``align(max(size, ceil(size·growth)))``, so that an ``extend`` whose rows
fit in the slack is one scatter of the new rows. Rows in [offset + size,
offset + capacity) are slack; the scans mask by true size and never read
them. Inside a list, rows keep their input order (a stable sort by label;
an extend appends after the rows already there), the order the JAX
package gives them: the scan kernel breaks distance ties by row, so the
order is part of the result.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.errors import expects

__all__ = ["count_sizes", "plan_offsets", "scatter_build", "scatter_extend",
           "gather_dense", "dense_offsets", "span_labels",
           "streaming_build", "list_skew"]

_ALIGN = 8


def count_sizes(labels: torch.Tensor, n_lists: int) -> np.ndarray:
    """Per-list row counts, on the host."""
    return torch.bincount(labels, minlength=n_lists).cpu().numpy().astype(
        np.int64)


def plan_offsets(sizes: np.ndarray, growth: float = 1.0) -> np.ndarray:
    """(n_lists+1,) offsets with capacity ``align(max(size, ceil(size ·
    growth)))``: ``growth`` 1.0 packs the lists (aligned), more leaves
    slack for later extends."""
    caps = np.maximum(sizes, np.ceil(sizes * growth)).astype(np.int64)
    caps = (caps + _ALIGN - 1) // _ALIGN * _ALIGN
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(caps, out=offsets[1:])
    return offsets


def _dest_rows(labels: torch.Tensor, sizes: np.ndarray,
               offsets: np.ndarray, base_sizes: np.ndarray | None = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(order, dest): input rows in list order, and the destination row of
    each: offset[l] + base[l] + rank within l (``base_sizes``: the rows a
    list holds already, none by default)."""
    dev = labels.device
    order = torch.argsort(labels, stable=True)
    lsort = labels[order]
    starts = np.zeros(len(sizes), np.int64)
    if len(sizes) > 1:
        np.cumsum(sizes[:-1], out=starts[1:])
    rank = (torch.arange(labels.shape[0], dtype=torch.int64, device=dev)
            - torch.as_tensor(starts, device=dev)[lsort])
    base = np.asarray(offsets[:-1], np.int64)
    if base_sizes is not None:
        base = base + base_sizes
    dest = torch.as_tensor(base, device=dev)[lsort] + rank
    return order, dest


def scatter_build(labels: torch.Tensor, arrays: Sequence[torch.Tensor],
                  fills: Sequence, n_lists: int, growth: float = 1.0
                  ) -> Tuple[list, np.ndarray, np.ndarray]:
    """Cluster-sort ``arrays`` into a fresh layout with ``growth`` slack
    (holes hold ``fills``) → ([arrays (cap_total, ...)], offsets
    (n_lists+1,), sizes (n_lists,))."""
    sizes = count_sizes(labels, n_lists)
    offsets = plan_offsets(sizes, growth)
    order, dest = _dest_rows(labels, sizes, offsets)
    cap_total = int(offsets[-1])
    out = []
    for arr, fill in zip(arrays, fills):
        buf = torch.full((cap_total,) + tuple(arr.shape[1:]), fill,
                         dtype=arr.dtype, device=arr.device)
        buf[dest] = arr[order]
        out.append(buf)
    return out, offsets, sizes


def scatter_extend(labels: torch.Tensor, new_arrays: Sequence[torch.Tensor],
                   old_arrays: Sequence[torch.Tensor], fills: Sequence,
                   offsets: np.ndarray, old_sizes: np.ndarray,
                   growth: float = 1.0
                   ) -> Tuple[list, np.ndarray, np.ndarray]:
    """Append a batch to a layout, an empty one included (its lists have
    no room, so the batch is laid out afresh). When every list has room,
    one scatter of the new rows into a copy of each array, after the rows
    a list holds; when any list overflows, the old rows packed (list by
    list) and then the new ones are laid out afresh with ``growth``
    slack, so each list keeps its old rows first."""
    n_lists = len(old_sizes)
    add = count_sizes(labels, n_lists)
    if (old_sizes + add <= np.diff(offsets)).all():
        order, dest = _dest_rows(labels, add, offsets, base_sizes=old_sizes)
        out = []
        for old, new in zip(old_arrays, new_arrays):
            buf = old.clone()
            buf[dest] = new[order]
            out.append(buf)
        return out, offsets, old_sizes + add
    old_dense = gather_dense(old_arrays, offsets, old_sizes)
    merged = [torch.cat([o, n]) for o, n in zip(old_dense, new_arrays)]
    all_labels = torch.cat([span_labels(old_sizes, labels.device),
                            labels.to(torch.int64)])
    return scatter_build(all_labels, merged, fills, n_lists, growth)


def dense_offsets(sizes: np.ndarray) -> np.ndarray:
    """(n_lists+1,) offsets of the lists packed with no slack."""
    offsets = np.zeros(len(sizes) + 1, np.int64)
    np.cumsum(sizes, out=offsets[1:])
    return offsets


def gather_dense(arrays: Sequence[torch.Tensor], offsets: np.ndarray,
                 sizes: np.ndarray) -> list:
    """The valid rows of a layout, packed list by list with no slack
    (rows at :func:`dense_offsets`); views of the arrays when the layout
    has no slack."""
    dense = dense_offsets(sizes)
    if np.array_equal(np.asarray(offsets, np.int64), dense):
        return [a[: int(dense[-1])] for a in arrays]
    rows = (np.repeat(np.asarray(offsets[:-1], np.int64) - dense[:-1],
                      sizes) + np.arange(int(dense[-1])))
    idx = torch.as_tensor(rows, device=arrays[0].device)
    return [a[idx] for a in arrays]


def span_labels(spans: np.ndarray, device) -> torch.Tensor:
    """(sum(spans),) int64 list of each row when list l holds ``spans[l]``
    consecutive rows: the sizes for the rows :func:`gather_dense` returns,
    ``np.diff(offsets)`` for every row of a layout, slack included."""
    return torch.repeat_interleave(
        torch.arange(len(spans), device=device),
        torch.as_tensor(np.asarray(spans, np.int64), device=device))


def streaming_build(batches, params, build_fn, extend_fn, trainset=None):
    """The IVF families' streaming build: train the quantizers on
    ``trainset`` (or on the first batch when there is none), then extend
    batch by batch, so the host holds one batch at a time. Slack is
    floored at ``list_growth`` 1.2, so most extends are one scatter.
    ``build_fn(data, params)`` and ``extend_fn(index, batch)`` are the
    family's; ``params`` is its ``IndexParams`` dataclass."""
    p = dataclasses.replace(params, add_data_on_build=False,
                            list_growth=max(1.2, params.list_growth))
    it = iter(batches)
    first = next(it, None)
    expects(first is not None, "streaming build got an empty batch iterable")
    index = build_fn(first if trainset is None else trainset, p)
    index = extend_fn(index, first)
    for b in it:
        index = extend_fn(index, b)
    return index


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
