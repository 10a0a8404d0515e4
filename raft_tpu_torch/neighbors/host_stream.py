"""Host-RAM cold tier for IVF lists: counterpart of
``raft_tpu/neighbors/host_stream.py`` (``budget_bytes``,
``probe_frequency``, ``plan_hot_cold``, ``HostTier``, ``build_tier``).

An IVF index larger than its device budget (``budget_gb``, else
``RAFT_TPU_HBM_BUDGET_GB``) keeps its hottest lists on the device —
ranked by probe frequency over a query sample, list size standing in
without one — and the rest in host memory, cut into fixed-shape chunks
(at most ``chunk_rows`` rows and ``chunk_lists`` lists each, plus one
dead slot of size 0 where probes outside the chunk land). A search
copies only the chunks its queries probe to the device and scans each
with the same kernel as the resident lists (``ivf_flat`` K3, ``ivf_pq``
K4), then merges the parts with ``brute_force.knn_merge_parts``.

The plan (``plan_hot_cold``'s stable order, the greedy chunk cut, the
routing tables ``chunk_of`` / ``local_of``) equals the JAX package's.
The chunks' arrays are what the resident arrays hold — the store, the
row width, no padding: the kernels mask each list's rows themselves —
where the JAX package pads dimensions to 128 lanes and adds a DMA tail.

On a CUDA index the chunks live in pinned host tensors (a failure to
pin raises; nothing is served from pageable memory). :meth:`HostTier.
stream` keeps two device buffers of the chunk shape: while chunk i is
scanned, chunk i + 1 is copied into the other buffer with
``non_blocking=True`` on a copy stream; the search's stream waits on
the copy's event, and a copy into a buffer waits on the event recorded
after the last scan that read it. On a CPU index the same code copies
into the buffers with no copy stream. A search reads the probed lists
on the host once a query chunk, to know which chunks it touches.
"""
from __future__ import annotations

import dataclasses
import os
import threading
import warnings
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.errors import RaftError
from ..utils import env_float

__all__ = ["HostTier", "budget_bytes", "plan_hot_cold", "build_tier",
           "probe_frequency", "host_full"]


_armed_lock = threading.Lock()
_armed_seen: set = set()      # budgets that recorded host_tier_armed


def budget_bytes(budget_gb: Optional[float] = None) -> int:
    """The device budget of one index's list data in bytes: ``budget_gb``
    GiB, else ``RAFT_TPU_HBM_BUDGET_GB``, else 0 (no tier). A value of the
    variable that is not a float warns and gives 0: a typo must not
    leave a user believing a tier is armed. Each distinct budget > 0
    records one ``host_tier_armed`` event."""
    source = "arg"
    if budget_gb is None:
        source = "env"
        raw = os.environ.get("RAFT_TPU_HBM_BUDGET_GB", "")
        if not raw:
            return 0
        try:
            float(raw)
        except ValueError:
            warnings.warn(
                f"malformed RAFT_TPU_HBM_BUDGET_GB={raw!r} (not a float): "
                "HBM budget DISABLED, no host tier will be armed",
                RuntimeWarning, stacklevel=2)
            return 0
        budget_gb = env_float("RAFT_TPU_HBM_BUDGET_GB", 0.0)
    b = int(float(budget_gb) * (1 << 30))
    with _armed_lock:
        first = b > 0 and b not in _armed_seen
        _armed_seen.add(b)
    if first:
        try:
            from ..core import events

            events.record("host_tier_armed", "host_stream.budget",
                          budget_gb=float(budget_gb), budget_bytes=b,
                          source=source)
        except Exception:  # noqa: BLE001 - telemetry must not fail a plan
            pass
    return b


def probe_frequency(probed: np.ndarray, n_lists: int) -> np.ndarray:
    """(m, p) probed list ids of a query sample → (n_lists,) int64 probe
    counts."""
    flat = np.asarray(probed).reshape(-1)
    return np.bincount(flat[(flat >= 0) & (flat < n_lists)],
                       minlength=n_lists).astype(np.int64)


def plan_hot_cold(list_sizes: np.ndarray, row_bytes: float,
                  budget: int, probe_freq: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """(n_lists,) bool hot mask: lists admitted by probes per byte (a
    stable order, so ties keep list order) while the budget lasts; empty
    lists always stay. The frequency defaults to the list size."""
    sizes = np.asarray(list_sizes, np.int64)
    freq = (sizes.astype(np.float64) if probe_freq is None
            else np.asarray(probe_freq, np.float64))
    bytes_per = np.maximum(sizes * row_bytes, 1.0)
    order = np.argsort(-(freq / bytes_per), kind="stable")
    hot = np.zeros(len(sizes), bool)
    spent = 0
    for li in order:
        b = int(sizes[li] * row_bytes)
        if spent + b <= budget or sizes[li] == 0:
            hot[li] = True
            spent += b
    return hot


@dataclasses.dataclass
class _Chunk:
    lists: np.ndarray        # global list ids of the chunk
    offsets: np.ndarray      # (chunk_lists,) chunk-local row offsets
    sizes: np.ndarray        # (chunk_lists,) sizes (0 on the pad slots)
    arrays: Dict[str, torch.Tensor]   # host rows, chunk-local, padded


def host_full(shape, fill, dtype, pin: bool) -> torch.Tensor:
    """A host tensor of ``fill``, pinned when ``pin``; a pin that fails
    raises."""
    try:
        return torch.full(shape, fill, dtype=dtype, pin_memory=pin)
    except RuntimeError as e:
        raise RaftError(f"host tier: cannot pin {shape} {dtype} in host "
                        f"memory ({e}); the tier is never served from "
                        "pageable memory") from e


class HostTier:
    """The cold lists' host chunks and the routing from global list ids
    to chunk-local ones (``chunk_of``: the chunk of each list, -1 for a
    resident one; ``local_of``: its slot in the chunk).
    ``extras[ci]``: per-chunk side arrays a family uploads with the rows
    (IVF-PQ's chunk-local rotated centers). ``passes``: how many times
    :meth:`stream` copies and scans each touched chunk in a row (1; more
    re-copies each chunk into the other buffer and rescans it, a check of
    the double buffer: the last pass's result is returned)."""

    def __init__(self, chunks: List[_Chunk], chunk_of: np.ndarray,
                 local_of: np.ndarray, lmax: int, chunk_rows: int,
                 chunk_lists: int, cold_rows: int, host_bytes: int,
                 device_bytes_saved: int, device=None, pinned: bool = False):
        self.chunks = chunks
        self.chunk_of = chunk_of
        self.local_of = local_of
        self.lmax = int(lmax)
        self.chunk_rows = int(chunk_rows)
        self.chunk_lists = int(chunk_lists)
        self.cold_rows = int(cold_rows)
        self.host_bytes = int(host_bytes)
        self.device_bytes_saved = int(device_bytes_saved)
        self.probe_counts = np.zeros(len(chunk_of), np.int64)
        self.streamed_chunks = 0
        self.streamed_bytes = 0
        self.extras: List[Dict[str, torch.Tensor]] = [{} for _ in chunks]
        self.device = torch.device("cpu" if device is None else device)
        self.pinned = bool(pinned)
        self.passes = 1
        # the cold rows' source ids and global lists, on the device, for
        # a filter's survivors a list over the whole index
        self.cold_ids: Optional[torch.Tensor] = None
        self.cold_lists: Optional[torch.Tensor] = None
        self._chunk_of_dev = torch.as_tensor(chunk_of, dtype=torch.int64,
                                             device=self.device)
        self._local_of_dev = torch.as_tensor(local_of, dtype=torch.int64,
                                             device=self.device)
        self._bufs: List[Optional[Dict[str, torch.Tensor]]] = [None, None]
        self._ready: List[Optional[torch.cuda.Event]] = [None, None]
        self._free: List[Optional[torch.cuda.Event]] = [None, None]
        self._copy_stream = None
        self._lock = threading.Lock()

    @property
    def n_cold_lists(self) -> int:
        return int((self.chunk_of >= 0).sum())

    def cold_probed(self, probed: np.ndarray) -> np.ndarray:
        """The chunk ids a batch's (m, p) probes touch, ascending."""
        probed = np.asarray(probed)
        self.probe_counts += probe_frequency(probed, len(self.chunk_of))
        cids = self.chunk_of[probed.reshape(-1)]
        return np.unique(cids[cids >= 0])

    def local_probed(self, probed, ci: int):
        """(m, p) global probed ids → chunk-local ids, probes outside
        chunk ``ci`` on the dead slot (size 0: the scan reads no row for
        them). A numpy array gives numpy; a tensor, an int32 tensor on
        its device."""
        if isinstance(probed, torch.Tensor):
            p = probed.long()
            return torch.where(self._chunk_of_dev[p] == ci,
                               self._local_of_dev[p],
                               self.chunk_lists - 1).to(torch.int32)
        in_chunk = self.chunk_of[probed] == ci
        return np.where(in_chunk, self.local_of[probed],
                        self.chunk_lists - 1).astype(np.int32)

    def survivors(self, filter, n_lists: int) -> torch.Tensor:  # noqa: A002
        """(n_lists,) int64 survivors of ``filter`` a list among the cold
        rows, on the device."""
        return filter.to(self.device).count_by_segments(
            self.cold_ids, self.cold_lists, n_lists)

    def _upload(self, ci: int) -> Dict[str, torch.Tensor]:
        return {**self.chunks[ci].arrays, **self.extras[ci]}

    def _put(self, slot: int, ci: int) -> None:
        """Start the copy of chunk ``ci`` into buffer ``slot``."""
        src = self._upload(ci)
        if self._bufs[slot] is None:
            self._bufs[slot] = {k: torch.empty(v.shape, dtype=v.dtype,
                                               device=self.device)
                                for k, v in src.items()}
        buf = self._bufs[slot]
        if self.device.type != "cuda":
            for k, v in src.items():
                buf[k].copy_(v)
            return
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        cs = self._copy_stream
        with torch.cuda.stream(cs):
            if self._free[slot] is not None:
                cs.wait_event(self._free[slot])   # its last scan is done
            for k, v in src.items():
                buf[k].copy_(v, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(cs)
        self._ready[slot] = ev

    def stream(self, probed,
               run: Callable[[int, Dict[str, torch.Tensor], torch.Tensor],
                             Tuple[torch.Tensor, torch.Tensor]]
               ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """``run(chunk id, device arrays, chunk-local probes)`` over every
        chunk the (m, p) ``probed`` lists touch (one host read of
        ``probed``), the next chunk's copy in flight while the current
        one is scanned → the runs' results in chunk order. The device
        arrays are the chunk's rows and extras and its int32 ``offsets``
        and ``sizes``; they are overwritten after ``run`` returns, so
        ``run`` returns new tensors."""
        host = (probed.cpu().numpy() if isinstance(probed, torch.Tensor)
                else np.asarray(probed))
        touched = self.cold_probed(host)
        if touched.size == 0:
            return []
        dev_probed = torch.as_tensor(probed).to(self.device)
        order = np.repeat(touched, max(1, int(self.passes)))
        results = []
        with self._lock:
            self._put(0, int(order[0]))
            for i, ci in enumerate(order.tolist()):
                slot = i % 2
                if i + 1 < len(order):
                    self._put(1 - slot, int(order[i + 1]))
                if self.device.type == "cuda":
                    compute = torch.cuda.current_stream(self.device)
                    compute.wait_event(self._ready[slot])
                self.streamed_chunks += 1
                self.streamed_bytes += sum(
                    v.numel() * v.element_size()
                    for v in self._upload(ci).values())
                out = run(ci, self._bufs[slot],
                          self.local_probed(dev_probed, ci))
                if self.device.type == "cuda":
                    ev = torch.cuda.Event()
                    ev.record(compute)
                    self._free[slot] = ev
                if i + 1 == len(order) or order[i + 1] != ci:
                    results.append(out)
        return results

    def snapshot(self) -> dict:
        """The tier's stats as plain JSON values."""
        return {
            "cold_lists": self.n_cold_lists,
            "cold_rows": self.cold_rows,
            "host_bytes": self.host_bytes,
            "device_bytes_saved": self.device_bytes_saved,
            "chunks": len(self.chunks),
            "chunk_rows": self.chunk_rows,
            "streamed_chunks": int(self.streamed_chunks),
            "streamed_bytes": int(self.streamed_bytes),
            "pinned": self.pinned,
        }


def _spans(offsets: np.ndarray, sizes: np.ndarray, lists) -> np.ndarray:
    """The rows of ``lists`` back to back, each list's in order."""
    lists = np.asarray(lists, np.int64)
    s = sizes[lists]
    total = int(s.sum())
    if total == 0:
        return np.zeros(0, np.int64)
    starts = offsets[lists] - (np.cumsum(s) - s)
    return np.repeat(starts, s) + np.arange(total, dtype=np.int64)


def build_tier(arrays: Dict[str, torch.Tensor], list_offsets: np.ndarray,
               list_sizes: np.ndarray, hot: np.ndarray,
               chunk_rows: int, pad_tail: int = 0,
               fills: Optional[Dict[str, float]] = None,
               chunk_shape: Optional[Tuple[int, int, int]] = None
               ) -> Tuple[HostTier, Dict[str, torch.Tensor], np.ndarray,
                          np.ndarray]:
    """Split the cluster-sorted ``arrays`` (rows on axis 0, on the index's
    device) into a packed resident copy (cold lists of size 0) and a
    :class:`HostTier` of fixed-shape cold chunks, pinned when the arrays
    are on a CUDA device.

    ``chunk_rows``: rows a chunk (at least the longest cold list);
    ``pad_tail``: extra pad rows on each chunk; ``fills``: each array's
    pad value (0 by default); ``chunk_shape``: ``(chunk_rows,
    chunk_lists, lmax)`` pinned for every tier built with it, else the
    shape shrinks to the fullest chunk planned. The cold rows of the
    source ids (``arrays["ids"]``) and their lists stay on the device, for
    a filter's survivors. → ``(tier, hot_arrays, hot_offsets,
    hot_sizes)``."""
    fills = fills or {}
    n_lists = len(list_sizes)
    sizes = np.asarray(list_sizes, np.int64)
    offsets = np.asarray(list_offsets, np.int64)
    cold_ids = np.flatnonzero(~np.asarray(hot))
    cold_sizes = sizes[cold_ids]
    lmax = int(cold_sizes.max()) if cold_ids.size else 0
    if chunk_shape is not None:
        pin_rows, pin_lists, pin_lmax = (int(v) for v in chunk_shape)
        lmax = max(lmax, pin_lmax)
        chunk_rows = max(pin_rows, lmax, 1)
    else:
        chunk_rows = max(int(chunk_rows), lmax, 1)

    # the greedy fixed-shape plan over the cold lists, one dead slot a
    # chunk for the probes outside it
    plans: List[List[int]] = []
    cur: List[int] = []
    cur_rows = 0
    for li in cold_ids:
        s = int(sizes[li])
        if cur and cur_rows + s > chunk_rows:
            plans.append(cur)
            cur, cur_rows = [], 0
        cur.append(int(li))
        cur_rows += s
    if cur:
        plans.append(cur)
    if chunk_shape is None:
        chunk_rows = max((int(sizes[p].sum()) for p in plans), default=1)
        chunk_lists = max((len(p) for p in plans), default=0) + 1
    else:
        chunk_lists = max(pin_lists,
                          max((len(p) for p in plans), default=0) + 1)

    dev = next(iter(arrays.values())).device
    pin = dev.type == "cuda"
    chunk_of = np.full(n_lists, -1, np.int32)
    local_of = np.zeros(n_lists, np.int32)
    chunks: List[_Chunk] = []
    host_bytes = 0
    total = chunk_rows + pad_tail
    for ci, lists in enumerate(plans):
        offs = np.zeros(chunk_lists, np.int64)
        szs = np.zeros(chunk_lists, np.int64)
        row0 = 0
        for sl, li in enumerate(lists):
            chunk_of[li] = ci
            local_of[li] = sl
            offs[sl] = row0
            szs[sl] = sizes[li]
            row0 += int(sizes[li])
        rows = torch.as_tensor(_spans(offsets, sizes, lists), device=dev)
        ch_arrays: Dict[str, torch.Tensor] = {}
        for name, arr in arrays.items():
            out = host_full((total,) + tuple(arr.shape[1:]),
                             fills.get(name, 0), arr.dtype, pin)
            out[:row0] = arr[rows].cpu()
            ch_arrays[name] = out
            host_bytes += out.numel() * out.element_size()
        for name, a in (("offsets", offs), ("sizes", szs)):
            t = host_full((chunk_lists,), 0, torch.int32, pin)
            t.copy_(torch.from_numpy(a.astype(np.int32)))
            ch_arrays[name] = t
        chunks.append(_Chunk(np.asarray(lists, np.int64), offs, szs,
                             ch_arrays))

    # the packed resident copy: hot lists keep their rows and order,
    # cold lists shrink to size 0
    hot_offsets = np.zeros(n_lists + 1, np.int64)
    hot_sizes = sizes.copy()
    hot_sizes[cold_ids] = 0
    np.cumsum(hot_sizes, out=hot_offsets[1:])
    hot_rows = torch.as_tensor(
        _spans(offsets, sizes, np.flatnonzero(hot_sizes > 0)), device=dev)
    hot_arrays: Dict[str, torch.Tensor] = {}
    saved = 0
    for name, arr in arrays.items():
        out = arr[hot_rows].contiguous()
        hot_arrays[name] = out
        saved += (arr.numel() - out.numel()) * arr.element_size()

    tier = HostTier(chunks, chunk_of, local_of, lmax, chunk_rows,
                    chunk_lists, int(cold_sizes.sum()), host_bytes, saved,
                    dev, pin)
    if "ids" in arrays:
        cold_rows = torch.as_tensor(_spans(offsets, sizes, cold_ids),
                                    device=dev)
        tier.cold_ids = arrays["ids"][cold_rows].to(torch.int32)
        tier.cold_lists = torch.as_tensor(
            np.repeat(cold_ids, cold_sizes).astype(np.int32), device=dev)
    return tier, hot_arrays, hot_offsets, hot_sizes
