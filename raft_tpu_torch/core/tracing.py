"""Tracing ranges, trace IDs and the sampled span log: counterpart of
``raft_tpu/core/tracing.py`` (``range``, ``annotate``, ``set_timer``,
``new_trace_id``, ``bind_trace``, ``current_trace(s)``, ``child_span``,
``sample_rate``, ``log_spans``, ``recent_spans``).

Ranges are the reference's NVTX layer (``raft::common::nvtx::range``).
With tracing on (``RAFT_TPU_TRACE=1`` or :func:`enable`) each range is a
``torch.profiler.record_function`` (so ``torch.profiler`` traces show
it) and, where a CUDA card is present, an NVTX range pushed and popped
around it (so Nsight Systems shows it); on a CPU-only torch no NVTX call
is reached. Off (the default), a range costs one check.

A span *timer* (:func:`set_timer`; ``serve.metrics.enable_span_metrics``
installs one) reports every range's and annotated call's host wall
duration under its span name, independent of the profiler switch.

Request lifecycle: the serving runtime stamps each request with a trace
ID (:func:`new_trace_id`) and binds the active IDs around dispatch
(:func:`bind_trace`), so events recorded mid-dispatch
(:mod:`raft_tpu_torch.core.events`) carry the requests they hit.
:func:`child_span` times one stage; sampled requests log their stage
decomposition into a bounded span log (:func:`log_spans`). Sampling is
``RAFT_TPU_TRACE_SAMPLE`` (:func:`sample_rate`: a float in [0, 1],
default 0 = off).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import math
import os
import threading
import time
import uuid
from typing import Callable, Dict, Iterator, List, Optional

import torch

__all__ = ["enabled", "enable", "disable", "range", "annotate", "set_timer",
           "new_trace_id", "bind_trace", "current_traces", "current_trace",
           "child_span", "sample_rate", "log_spans", "recent_spans",
           "clear_span_log", "set_span_log_capacity"]

_enabled = os.environ.get("RAFT_TPU_TRACE", "0") not in ("0", "", "false")

# (span_name, seconds) observer; None = timing off (the default)
_timer: Optional[Callable[[str, float], None]] = None


def set_timer(fn: Optional[Callable[[str, float], None]]) -> None:
    """Install (or clear with None) the span-duration observer. Spans
    report host wall time between entry and exit."""
    global _timer
    _timer = fn


def enabled() -> bool:
    return _enabled


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


@contextlib.contextmanager
def _annotation(name: str) -> Iterator[None]:
    """The profiler's view of one range: ``record_function``, plus an
    NVTX range where a card is present (never reached on a CPU-only
    torch)."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


@contextlib.contextmanager
def range(name: str) -> Iterator[None]:  # noqa: A001 - mirrors nvtx::range
    """Context-managed trace range (analog of ``raft::common::nvtx::range``)."""
    timer = _timer
    if timer is None and not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        if _enabled:
            with _annotation(name):
                yield
        else:
            yield
    finally:
        if timer is not None:
            timer(name, time.perf_counter() - t0)


def annotate(name: str | None = None):
    """Decorator form: wrap a public entry point in a trace range. The
    wrapper carries ``__raft_traced__ = True``."""

    def deco(fn):
        label = name or f"raft_tpu::{fn.__qualname__}"

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            timer = _timer
            if timer is None and not _enabled:
                return fn(*args, **kwargs)
            t0 = time.perf_counter()
            try:
                if _enabled:
                    with _annotation(label):
                        return fn(*args, **kwargs)
                return fn(*args, **kwargs)
            finally:
                if timer is not None:
                    timer(label, time.perf_counter() - t0)

        wrapper.__raft_traced__ = True
        return wrapper

    return deco


# -- trace IDs -------------------------------------------------------------
# Thread-local: the serving worker binds a batch's IDs on its own thread,
# and the probes that record events run on that same thread.
_trace = threading.local()

# process-random prefix + counter: unique without a syscall a request
_id_prefix = uuid.uuid4().hex[:8]
_id_counter = itertools.count(1)


def new_trace_id() -> str:
    """A fresh 16-hex trace ID (one per request entering the serving
    pipeline)."""
    return f"{_id_prefix}{next(_id_counter) & 0xFFFFFFFF:08x}"


@contextlib.contextmanager
def bind_trace(*trace_ids: str) -> Iterator[None]:
    """Bind the active trace IDs for the extent of the block; events
    recorded inside with ``trace_id=None`` are stamped with them. Nests:
    the previous binding is restored."""
    prev = getattr(_trace, "ids", ())
    _trace.ids = tuple(trace_ids)
    try:
        yield
    finally:
        _trace.ids = prev


def current_traces() -> tuple:
    """The trace IDs bound on this thread (empty tuple when none)."""
    return getattr(_trace, "ids", ())


def current_trace() -> Optional[str]:
    """First bound trace ID, or None."""
    ids = getattr(_trace, "ids", ())
    return ids[0] if ids else None


# -- child spans -----------------------------------------------------------
@contextlib.contextmanager
def child_span(name: str, out: Optional[Dict[str, float]] = None
               ) -> Iterator[None]:
    """Timed child span for one stage of a request: the duration is
    always measured (callers gate the call site), lands in ``out[name]``
    when given, feeds the installed timer, and nests under the profiler
    range when tracing is on."""
    t0 = time.perf_counter()
    try:
        if _enabled:
            with _annotation(name):
                yield
        else:
            yield
    finally:
        dt = time.perf_counter() - t0
        if out is not None:
            out[name] = dt
        timer = _timer
        if timer is not None:
            timer(name, dt)


# -- sampling knob ---------------------------------------------------------
def sample_rate(value=None, env: str = "RAFT_TPU_TRACE_SAMPLE",
                name: str = "trace_sample") -> float:
    """Resolve and validate a sampling rate: ``value=None`` reads ``env``
    (default ``RAFT_TPU_TRACE_SAMPLE``; ``0`` = off), an explicit value
    (float or string) bypasses it. Anything but a float in [0, 1] raises
    ValueError naming its source."""
    src = env if value is None else name
    raw = os.environ.get(env, "0") if value is None else value
    try:
        r = float(raw)
    except (TypeError, ValueError):
        raise ValueError(
            f"{src} must be a float in [0, 1], got {raw!r}")
    if math.isnan(r) or not 0.0 <= r <= 1.0:
        raise ValueError(
            f"{src} must be in [0, 1], got {raw!r}")
    return r


# -- sampled per-request span log ------------------------------------------
_span_lock = threading.Lock()
_span_log: collections.deque = collections.deque(maxlen=256)


def log_spans(trace_id: str, stages: Dict[str, float], **meta) -> dict:
    """Append one sampled request's stage decomposition (stage name ->
    seconds) to the span log; ``meta`` is free-form context."""
    entry = {"ts": time.time(), "trace_id": trace_id, "stages": dict(stages)}
    if meta:
        entry.update(meta)
    with _span_lock:
        _span_log.append(entry)
    return entry


def recent_spans(n: Optional[int] = None) -> List[dict]:
    """Most recent sampled span records, oldest first (``n=None`` = all,
    ``n=0`` = none)."""
    with _span_lock:
        items = list(_span_log)
    if n is None:
        return items
    return items[-n:] if n > 0 else []


def clear_span_log() -> None:
    with _span_lock:
        _span_log.clear()


def set_span_log_capacity(n: int) -> None:
    """Resize the span log (keeps the newest records)."""
    global _span_log
    with _span_lock:
        _span_log = collections.deque(_span_log, maxlen=int(n))
