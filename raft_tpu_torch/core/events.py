"""Flight recorder: counterpart of ``raft_tpu/core/events.py`` (``record``,
``recent``, ``counts``, ``to_jsonl``, ``export_jsonl``, ``drain_new``,
``attach_sink``, ``detach_sink``, ``set_capacity``, ``clear``).

A bounded ring of structured operational events (fault fires, deadline
sheds, dispatch errors, brownout steps, swaps, mutable-index writes and
merges, ...), each stamped with the trace IDs bound on the recording
thread (:func:`raft_tpu_torch.core.tracing.bind_trace`; the serving
batcher binds the requests it dispatches), so "which requests got slow,
and why" has an answer after the fact.

* **bounded**: a deque ring (default 512 events);
* **cheap**: plain dicts under one lock, recordable from any layer;
* **exportable**: :func:`to_jsonl` / :func:`export_jsonl` dump the ring
  as JSON lines; :mod:`raft_tpu_torch.serve.debugz` folds the tail into
  its snapshot; :func:`attach_sink` streams every event to a file.

Event shape: ``{"seq", "ts", "kind", "site", "trace_id", ...details}``.
``trace_id`` is a string when one trace was bound, a list when a batch
of requests was in flight, None outside any binding. The kinds are the
JAX package's (:data:`WELL_KNOWN_KINDS`, an open set: emitters define
their meaning).

Details are scrubbed JSON-safe at record time: non-finite floats become
None, numpy scalars and small arrays Python values and lists (large
arrays a shape summary), a 0-d ``torch.Tensor`` its number and a larger
one its shape, exceptions ``"Type: message"`` strings, unknown objects
their repr.
"""
from __future__ import annotations

import collections
import json
import math
import threading
import time
from typing import List, Optional

import torch

__all__ = ["record", "recent", "counts", "to_jsonl", "export_jsonl",
           "drain_new", "attach_sink", "detach_sink",
           "set_capacity", "clear", "DEFAULT_CAPACITY",
           "WELL_KNOWN_KINDS"]

DEFAULT_CAPACITY = 512

# the JAX package's registered vocabulary (an operator greps by kind)
WELL_KNOWN_KINDS = frozenset({
    "guarded_demotion", "fault_injected", "deadline_shed",
    "deadline_exceeded", "dispatch_error", "shard_marked",
    "autotune_verdict", "xla_compile", "corrupt_index",
    "recall_regression", "slo_breach",
    "breaker_open", "breaker_probe", "breaker_close", "shard_restored",
    "brownout", "fault_scenario",
    "upsert", "delete", "merge_started", "merge_committed",
    "merge_abandoned", "wal_recovered",
    "tenant_shed", "tenant_swap", "qcache_stale",
    "hook_error", "soak_phase",
    "host_lost", "host_restored", "fleet_build",
    "host_tier_armed", "fleet_tier_step",
    "filter_crossover",
    # the port's counterpart of xla_compile: a counted first call (a
    # kernel library loaded, an engine race) on a serving dispatch
    "first_call",
})

# arrays above this many elements are summarized, not inlined
_ARRAY_INLINE_MAX = 32

_lock = threading.Lock()
_ring: collections.deque = collections.deque(maxlen=DEFAULT_CAPACITY)
_seq = 0
_sink = None          # open JSONL file object (attach_sink), or None


def _json_safe(v, depth: int = 0):
    """Best-effort JSON-safe scrub. Never raises — worst case is a repr
    string."""
    try:
        if v is None or isinstance(v, (bool, int, str)):
            return v
        if isinstance(v, float):
            return v if math.isfinite(v) else None
        if isinstance(v, BaseException):
            return f"{type(v).__name__}: {v}"
        if depth >= 6:
            return repr(v)
        if isinstance(v, dict):
            return {str(k): _json_safe(x, depth + 1) for k, x in v.items()}
        if isinstance(v, (list, tuple, set, frozenset)):
            return [_json_safe(x, depth + 1) for x in v]
        if isinstance(v, torch.Tensor):
            if v.dim() == 0:
                return _json_safe(v.item(), depth + 1)
            return f"tensor(shape={tuple(v.shape)}, dtype={v.dtype})"
        # numpy arrays: small ones inline as (scrubbed) lists, large ones
        # as a shape summary
        if hasattr(v, "dtype") and hasattr(v, "shape"):
            if getattr(v, "size", _ARRAY_INLINE_MAX + 1) <= _ARRAY_INLINE_MAX:
                return _json_safe(v.tolist(), depth + 1)
            return f"array(shape={tuple(v.shape)}, dtype={v.dtype})"
        if hasattr(v, "item"):            # numpy scalar
            return _json_safe(v.item(), depth + 1)
        return repr(v)
    except Exception:  # noqa: BLE001 - scrub must never raise
        try:
            return repr(v)
        except Exception:  # noqa: BLE001
            return "<unprintable>"


def record(kind: str, site: str, trace_id=None, **details) -> dict:
    """Append one event. ``trace_id=None`` stamps the trace IDs bound on
    this thread; pass an explicit ID when the originating request is known
    (e.g. a shed, which happens outside the dispatch binding)."""
    global _seq
    if trace_id is None:
        from . import tracing

        ids = tracing.current_traces()
        trace_id = ids[0] if len(ids) == 1 else (list(ids) if ids else None)
    e = {"ts": time.time(), "kind": kind, "site": site,
         "trace_id": _json_safe(trace_id)}
    if details:
        e.update({k: _json_safe(v) for k, v in details.items()})
    with _lock:
        _seq += 1
        e["seq"] = _seq
        _ring.append(e)
        if _sink is not None:
            try:
                _sink.write(json.dumps(e, sort_keys=True, default=repr)
                            + "\n")
            except Exception:  # noqa: BLE001 - a dead sink must never
                pass           # break the recording path
    return e


def recent(n: Optional[int] = None, kind: Optional[str] = None) -> List[dict]:
    """Most recent events, oldest first; ``kind`` filters. ``n=None``
    returns everything in the ring, ``n=0`` nothing."""
    with _lock:
        items = list(_ring)
    if kind is not None:
        items = [e for e in items if e["kind"] == kind]
    if n is None:
        return items
    return items[-n:] if n > 0 else []


def counts() -> dict:
    """Events per kind currently in the ring (not lifetime totals: the
    ring is bounded; lifetime counts live in the metrics registry)."""
    out: dict = {}
    with _lock:
        for e in _ring:
            out[e["kind"]] = out.get(e["kind"], 0) + 1
    return out


def to_jsonl(n: Optional[int] = None, kind: Optional[str] = None) -> str:
    """The ring (tail ``n``, optionally filtered) as JSON lines."""
    items = recent(n, kind)
    return "\n".join(json.dumps(e, sort_keys=True, default=repr)
                     for e in items) + ("\n" if items else "")


def export_jsonl(path: str, n: Optional[int] = None) -> int:
    """Write the ring to ``path`` as JSON lines; returns the event count."""
    items = recent(n)
    with open(path, "w") as f:
        for e in items:
            f.write(json.dumps(e, sort_keys=True, default=repr) + "\n")
    return len(items)


def drain_new(cursor: int = 0):
    """Incremental read: ``events, cursor = drain_new(cursor)`` returns
    every event still in the ring with ``seq > cursor`` and the cursor to
    pass next time. Events that aged out between polls are gone (the
    first returned ``seq`` then jumps past ``cursor + 1``)."""
    cursor = int(cursor)
    with _lock:
        items = [e for e in _ring if e["seq"] > cursor]
        new_cursor = _seq
    return items, new_cursor


def attach_sink(path: str, include_ring: bool = False) -> str:
    """Stream every future event to ``path`` as JSON lines (append mode,
    line-buffered), beside the ring; ``include_ring=True`` writes the
    current ring first. Re-attaching closes the previous sink."""
    global _sink
    f = open(path, "a", buffering=1)
    with _lock:
        old, _sink = _sink, f
        prologue = list(_ring) if include_ring else []
        for e in prologue:
            f.write(json.dumps(e, sort_keys=True, default=repr) + "\n")
    if old is not None:
        try:
            old.close()
        except Exception:  # noqa: BLE001
            pass
    return path


def detach_sink() -> None:
    """Stop streaming and close the sink file (no-op when detached)."""
    global _sink
    with _lock:
        old, _sink = _sink, None
    if old is not None:
        try:
            old.close()
        except Exception:  # noqa: BLE001
            pass


def set_capacity(n: int) -> None:
    """Resize the ring (keeps the newest events)."""
    global _ring
    with _lock:
        _ring = collections.deque(_ring, maxlen=int(n))


def clear() -> None:
    with _lock:
        _ring.clear()
