"""Selectivity-adaptive filtered search: counterpart of
``raft_tpu/ops/filter_policy.py`` (``LEVELS``, ``FilterDecision``,
``suspended``, ``adaptive_off``, ``list_survivors``,
``selectivity_bucket``, ``crossover_key``, ``decide_ivf``,
``decide_graph``, ``survivor_ids``, ``survivor_brute_ivf``,
``survivor_brute_dense``, ``tune_crossover``; ``plan_ivf`` is the
port's own).

One cheap measurement, the filter's survivors (per IVF list through
:meth:`raft_tpu_torch.core.bitset.Bitset.count_by_segments`, or in all),
read on the host once a search, gives three decisions:

* **prune**: lists with no survivor drop out of the probe (their scan
  size is 0, so the scan reads none of their rows);
* **widen**: ``n_probes`` (IVF) or ``itopk`` (CAGRA) grows along
  :data:`LEVELS` (x1 / x2 / x4 / x8): IVF to the smallest level whose
  probed survivors reach the unfiltered probe's candidate mass, CAGRA by
  decades of selectivity;
* **crossover**: when few rows survive (at most
  ``RAFT_TPU_FILTER_BRUTE_MAX``, default 8,192, or as a recorded
  :func:`tune_crossover` verdict says), the survivors are gathered and
  searched exactly by brute force (kernel K2 on CUDA), their ids mapped
  back and the rows past the survivors padded with (+inf, -1), or
  (-inf, -1) for inner product.

``RAFT_TPU_FILTER_WIDEN_MAX`` caps the ladder. The settings keep the JAX
package's names. Inside :func:`suspended` a search keeps only the prune.

Where the port differs from the JAX package: a crossover runs the brute
pass and a failure there raises (JAX guards it with a fallback to the
widened scan, ``guarded_call("filter.survivor_brute", ...)``, and a
re-entry flag; no fallback may hide a kernel here); the telemetry hooks
(the selectivity gauge, the crossover event) wait for the serving layer;
the caches on an index (list labels, the inverse of its source ids) and
on a bitset (its survivor ids) are keyed to the tensors they came from
and their in-place versions, so an extend (a new index) or an edit in
place never meets a stale one; the crossover of an index that keeps row
norms (brute force, IVF-Flat) gathers the survivors' norms instead of
summing them again, and runs in the search's query chunks.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from ..distance.distance_types import DistanceType
from ..neighbors._list_layout import span_labels
from . import autotune
from .quant import dequantize_rows

__all__ = ["FilterDecision", "LEVELS", "list_survivors", "decide_ivf",
           "decide_graph", "plan_ivf", "crossover_key",
           "selectivity_bucket", "survivor_ids", "survivor_brute_ivf",
           "survivor_brute_dense", "tune_crossover", "suspended",
           "adaptive_off"]

# the widen ladder: each level multiplies n_probes / itopk
LEVELS: Tuple[int, ...] = (1, 2, 4, 8)

_local = threading.local()


@contextlib.contextmanager
def suspended():
    """Turn the adaptive policy (widen and crossover) off on this thread;
    the zero-survivor prune stays. For filters whose caller needs the
    search's plain filtered semantics."""
    prev = getattr(_local, "off", False)
    _local.off = True
    try:
        yield
    finally:
        _local.off = prev


def adaptive_off() -> bool:
    """True inside :func:`suspended` on this thread."""
    return getattr(_local, "off", False)


@dataclasses.dataclass(frozen=True)
class FilterDecision:
    """One filtered search's measured selectivity and the verdict."""

    selectivity: float            # surviving fraction of the filter's bits
    survivors: int                # surviving rows
    level: int                    # widen multiplier, one of LEVELS
    n_probes: int                 # widened probe count (IVF; 0 otherwise)
    lists_pruned: int             # lists with no survivor (IVF)
    use_brute: bool               # cross over to the compacted brute pass
    surv_dev: Optional[torch.Tensor] = None   # survivors a list (IVF)


def _env_int(name: str, default: int) -> int:
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def _widen_max() -> int:
    return max(1, _env_int("RAFT_TPU_FILTER_WIDEN_MAX", LEVELS[-1]))


def _brute_max() -> int:
    return _env_int("RAFT_TPU_FILTER_BRUTE_MAX", 8192)


def _keyed(owner, attr: str, key: tuple, make: Callable):
    """``make()``, cached on ``owner`` under ``attr`` while ``key`` (its
    first item a tensor, compared by identity, then plain values) holds."""
    hit = getattr(owner, attr, None)
    if (hit is not None and hit[0][0] is key[0]
            and hit[0][1:] == key[1:]):
        return hit[1]
    value = make()
    setattr(owner, attr, (key, value))
    return value


def _list_labels(index) -> torch.Tensor:
    """(cap_total,) int64 list of each storage row, slack included, on the
    index's device; cached on the index for its offsets."""
    offsets = np.asarray(index.list_offsets, np.int64)
    return _keyed(index, "_filter_list_labels",
                  (index.source_ids, offsets.tobytes()),
                  lambda: span_labels(np.diff(offsets), index.device))


def list_survivors(index, filter) -> torch.Tensor:  # noqa: A002
    """(n_lists,) int64 survivors a list of an IVF index, on its device:
    one pass over the storage rows. Slack rows (source id -1) never
    count."""
    return filter.to(index.device).count_by_segments(
        index.source_ids, _list_labels(index), int(index.n_lists))


def selectivity_bucket(selectivity: float) -> str:
    """Decades of the surviving fraction for verdict keys: "e0" (about
    all survive) ... "e6", "none" when nothing survives."""
    if selectivity <= 0.0:
        return "none"
    return f"e{min(6, max(0, int(-math.log10(min(selectivity, 1.0)))))}"


def crossover_key(family: str, n: int, d: int, k: int, selectivity: float,
                  device) -> str:
    """The verdict key of the brute-against-scan race on ``device`` (the
    card's name is in it), by selectivity decade."""
    return autotune.shape_bucket("filter_brute", device, fam=family,
                                 n=int(n), d=int(d), k=int(k),
                                 sel=selectivity_bucket(selectivity))


def _want_brute(family: str, n: int, d: int, k: int, survivors: int,
                selectivity: float, device) -> bool:
    """A recorded verdict for the key when there is one, else the
    survivor threshold."""
    verdict = autotune.lookup(crossover_key(family, n, d, k, selectivity,
                                            device))
    if verdict == "brute":
        return survivors > 0
    if verdict == "scan":
        return False
    return 0 < survivors <= _brute_max()


def _level_cap() -> int:
    widen_max = _widen_max()
    return max(lv for lv in LEVELS if lv <= widen_max)


def decide_ivf(index, filter, n_probes: int, k: int,  # noqa: A002
               family: str) -> FilterDecision:
    """Measure and decide for an IVF search (one host read: the survivors
    a list). The unfiltered probe covers T = the ``n_probes`` largest
    lists' rows; the level is the smallest whose ``n_probes · level``
    lists with the most survivors hold min(T, all survivors) of them."""
    surv_dev = list_survivors(index, filter)
    surv = surv_dev.cpu().numpy()
    total = int(surv.sum())
    selectivity = total / max(int(filter.n_bits), 1)
    sizes = np.asarray(index.list_sizes, np.int64)
    n_lists = int(index.n_lists)
    target = min(int(np.sort(sizes)[::-1][:n_probes].sum()), total)
    cum = np.cumsum(np.sort(surv)[::-1])
    level = _level_cap()
    for lv in LEVELS:
        if lv > level:
            break
        p = min(n_probes * lv, n_lists)
        if total == 0 or cum[p - 1] >= target:
            level = lv
            break
    use_brute = _want_brute(family, index.size, index.dim, k, total,
                            selectivity, index.device)
    return FilterDecision(selectivity, total, level,
                          min(n_probes * level, n_lists),
                          int((surv == 0).sum()), use_brute, surv_dev)


def plan_ivf(index, filter, n_probes: int, k: int,  # noqa: A002
             family: str):
    """A filtered IVF search's plan, made once before its query chunks: →
    (decision or None, n_probes, (n_lists,) survivors a list). Inside
    :func:`suspended` the decision is None and only the prune applies;
    else :func:`decide_ivf` widens ``n_probes`` (its ``use_brute``: the
    crossover)."""
    if adaptive_off():
        return None, n_probes, list_survivors(index, filter)
    fd = decide_ivf(index, filter, n_probes, k, family)
    return fd, fd.n_probes, fd.surv_dev


def decide_graph(filter, n: int, d: int, k: int,  # noqa: A002
                 family: str = "cagra", device=None) -> FilterDecision:
    """Measure and decide for a graph or dense search (one host read: the
    survivor count): the widen level by decade of selectivity (>= 0.5:
    1, >= 0.1: 2, >= 0.01: 4, else 8, within the cap) and the crossover.
    ``device``: the search's (the filter's by default), for the verdict
    key."""
    total = int(filter.count())
    selectivity = total / max(int(filter.n_bits), 1)
    if selectivity >= 0.5:
        level = 1
    elif selectivity >= 0.1:
        level = 2
    elif selectivity >= 0.01:
        level = 4
    else:
        level = LEVELS[-1]
    level = min(level, _level_cap())
    dev = filter.words.device if device is None else device
    use_brute = _want_brute(family, n, d, k, total, selectivity, dev)
    return FilterDecision(selectivity, total, level, 0, 0, use_brute)


def survivor_ids(filter) -> torch.Tensor:  # noqa: A002
    """(survivors,) int64 positions of the set bits, ascending, on the
    filter's device; cached on the bitset for its words."""
    return _keyed(filter, "_survivor_ids",
                  (filter.words, filter.words._version, filter.n_bits),
                  lambda: torch.nonzero(filter.to_mask()).reshape(-1))


def _physical_rows(index, src: torch.Tensor) -> torch.Tensor:
    """Source ids → storage rows through the inverse of
    ``index.source_ids`` (-1 where no row holds the id; slack rows never
    enter it), cached on the index for its source ids."""
    sid = index.source_ids

    def inverse():
        s = sid.to(torch.int64)
        inv = torch.full((int(index.size),), -1, dtype=torch.int64,
                         device=sid.device)
        pos = torch.nonzero((s >= 0) & (s < index.size)).reshape(-1)
        inv[s[pos]] = pos
        return inv

    inv = _keyed(index, "_source_inverse",
                 (sid, sid._version, int(index.size)), inverse)
    return inv[src]


def _brute_over(vecs, metric: DistanceType, queries, k: int,
                src: torch.Tensor, metric_arg: float = 2.0, norms=None,
                query_chunk: int = 0, res=None):
    """Exact brute force over the compacted survivor rows ``vecs`` (their
    squared ``norms`` when given, else summed here), ids mapped back
    through ``src``, padded to ``k`` with (+inf, -1), or (-inf, -1) for
    inner product."""
    from ..neighbors import brute_force

    bad = (-float("inf") if metric is DistanceType.InnerProduct
           else float("inf"))
    q = queries
    m = q.shape[0]
    n_surv = 0 if vecs is None else int(vecs.shape[0])
    out_d = torch.full((m, k), bad, dtype=torch.float32, device=q.device)
    out_i = torch.full((m, k), -1, dtype=torch.int32, device=q.device)
    if n_surv == 0:
        return out_d, out_i
    if norms is None or metric not in brute_force._NORM_METRICS:
        sub = brute_force.build(vecs, metric, device=vecs.device,
                                metric_arg=metric_arg)
    else:
        sub = brute_force.Index(vecs.contiguous(), norms, metric,
                                metric_arg=float(metric_arg))
    kk = min(k, n_surv)
    d, i = brute_force.search(sub, q, kk, query_chunk=query_chunk, res=res)
    out_d[:, :kk] = d
    out_i[:, :kk] = torch.where(i >= 0, src[i.clamp_min(0).long()],
                                -1).to(torch.int32)
    return out_d, out_i


def survivor_brute_ivf(index, reconstruct_fn, queries, k: int,
                       filter, norms=None, query_chunk: int = 0,  # noqa: A002
                       res=None):
    """The IVF crossover: the survivors' stored rows (``reconstruct_fn(
    index, rows)``: exact for IVF-Flat, decoded and rotated back for
    IVF-PQ; ``norms``, the index's squared row norms where it keeps them)
    searched exactly by brute force. Survivor bits with no stored row,
    and ids at or past ``index.size``, are skipped, as the JAX package
    skips them."""
    src = survivor_ids(filter).to(index.device)
    src = src[src < int(index.size)]
    rows = _physical_rows(index, src)
    keep = rows >= 0
    src, rows = src[keep], rows[keep]
    vecs = reconstruct_fn(index, rows) if rows.numel() else None
    return _brute_over(vecs, index.metric, queries, k, src,
                       norms=None if norms is None else norms[rows],
                       query_chunk=query_chunk, res=res)


def survivor_brute_dense(dataset: torch.Tensor, metric: DistanceType,
                         queries, k: int, filter,  # noqa: A002
                         scales=None, metric_arg: float = 2.0, norms=None,
                         query_chunk: int = 0, res=None):
    """The crossover for row-id-is-sample-id stores (brute force, CAGRA):
    the survivors' rows dequantized (``scales``: an int8 store's) and
    searched exactly by brute force; ``norms``, the store's squared row
    norms where it keeps them."""
    src = survivor_ids(filter).to(dataset.device)
    src = src[src < dataset.shape[0]]
    vecs = None
    if src.numel():
        vecs = dequantize_rows(dataset[src],
                               None if scales is None else scales[src])
    return _brute_over(vecs, metric, queries, k, src, metric_arg,
                       None if norms is None else norms[src],
                       query_chunk, res)


def tune_crossover(family: str, n: int, d: int, k: int, selectivity: float,
                   scan_fn: Callable, brute_fn: Callable, *args,
                   reps: int = 3, device=None):
    """Race the widened scan (``scan_fn``) against the compacted brute
    pass (``brute_fn``), both taking ``*args``, under the selectivity
    decade's key, and record the winner, which every later filtered
    search in the decade follows. → (key, winner, {name: seconds}). For
    warm-up and the bench, never the hot path."""
    dev = device
    if dev is None:
        dev = next((a.device for a in args if isinstance(a, torch.Tensor)),
                   "cpu")
    key = crossover_key(family, n, d, k, selectivity, dev)
    winner, timings = autotune.tune_best(
        key, {"scan": scan_fn, "brute": brute_fn}, *args, reps=reps,
        force=True, value_read=True)
    return key, winner, timings
