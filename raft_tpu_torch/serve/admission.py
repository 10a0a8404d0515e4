"""Admission control for the serving runtime: counterpart of
``raft_tpu/serve/admission.py`` (``AdmissionQueue``, ``Request``,
``SearchResult``, ``QueueFullError``), with its shedding rules and
backpressure:

* **Backpressure, not buffering**: :meth:`AdmissionQueue.submit` raises
  :class:`QueueFullError` once ``max_depth`` requests wait, counted under
  ``<prefix>.rejected``.
* **Shedding over zombie work**: a request whose
  :class:`~raft_tpu_torch.core.deadline.Deadline` is spent is never
  dispatched: it completes with
  :class:`~raft_tpu_torch.core.deadline.DeadlineExceeded` (``partial=None``)
  at pop time, counted under ``<prefix>.shed``, one ``deadline_shed``
  event each. Expiry mid-dispatch is the batcher's half of the contract.
* **Coalescing pops**: :meth:`AdmissionQueue.pop_batch` blocks for the
  first admissible request, then drains until a request or row cap, or
  until ``max_wait_s`` has passed since the first pop.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, List, NamedTuple, Optional, Tuple

from ..core import events, tracing
from ..core.deadline import Deadline, DeadlineExceeded
from ..core.errors import RaftError

__all__ = ["QueueFullError", "SearchResult", "Request", "AdmissionQueue"]


class QueueFullError(RaftError):
    """Raised by ``submit`` when the admission queue is at ``max_depth``
    (backpressure: the caller must retry or deflect)."""


class SearchResult(NamedTuple):
    """One request's demultiplexed answer: host tensors (distances
    (m, k), indices (m, k)). ``shards_ok`` is the per-shard health vector
    when the backing searcher ran a degraded sharded merge
    (``allow_partial=True``), else None."""

    distances: object
    indices: object
    shards_ok: object = None


class Request:
    """One in-flight query request: the payload plus a one-shot future.

    ``queries`` is a host (m, d) float32 tensor; ``k`` the requested
    neighbor count; ``deadline`` an optional
    :class:`~raft_tpu_torch.core.deadline.Deadline` enforced at admission pop,
    pre-dispatch and between search chunks. Every request carries a
    ``trace_id`` (generated when not supplied) that stage decompositions
    and flight-recorder events are stamped with; ``dequeued_at`` is
    stamped by the batcher worker when stage telemetry is enabled
    (queue-wait measurement).
    """

    __slots__ = ("queries", "k", "deadline", "enqueued_at", "trace_id",
                 "dequeued_at", "_event", "_result", "_error")

    def __init__(self, queries, k: int, deadline: Optional[Deadline] = None,
                 enqueued_at: float = 0.0, trace_id: Optional[str] = None):
        self.queries = queries
        self.k = int(k)
        self.deadline = deadline
        self.enqueued_at = enqueued_at
        self.trace_id = trace_id or tracing.new_trace_id()
        self.dequeued_at = 0.0
        self._event = threading.Event()
        self._result: Optional[SearchResult] = None
        self._error: Optional[BaseException] = None

    @property
    def rows(self) -> int:
        return self.queries.shape[0]

    def done(self) -> bool:
        return self._event.is_set()

    def set_result(self, result: SearchResult) -> None:
        self._result = result
        self._event.set()

    def set_exception(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> SearchResult:
        """Block for completion; re-raises the stored exception (e.g.
        DeadlineExceeded with this request's partial slice attached)."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request not completed within {timeout}s (batcher not "
                "started, or the worker died)")
        if self._error is not None:
            raise self._error
        return self._result


class AdmissionQueue:
    """Bounded FIFO of :class:`Request` with coalescing pops and deadline
    shedding. Metrics (``<prefix>.queue_depth`` / ``.queue_depth_peak``
    gauges, ``.shed`` / ``.rejected`` counters) land in ``registry``
    (default process registry when None)."""

    # pop_batch wakes at least this often so close() is always responsive
    _WAIT_SLICE_S = 0.05

    def __init__(self, max_depth: int = 256, registry=None,
                 prefix: str = "serve",
                 clock: Callable[[], float] = time.monotonic):
        from . import metrics as _metrics

        reg = registry or _metrics.default_registry
        self.max_depth = int(max_depth)
        self._prefix = prefix
        self._clock = clock
        self._items: deque = deque()
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._closed = False
        self._depth = reg.gauge(f"{prefix}.queue_depth")
        self._depth_peak = reg.gauge(f"{prefix}.queue_depth_peak")
        self._shed_n = reg.counter(f"{prefix}.shed")
        self._rejected = reg.counter(f"{prefix}.rejected")

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def submit(self, req: Request) -> None:
        """Enqueue or raise :class:`QueueFullError` (backpressure)."""
        with self._cond:
            if self._closed:
                raise RaftError("admission queue is closed")
            if len(self._items) >= self.max_depth:
                self._rejected.inc()
                raise QueueFullError(
                    f"admission queue full ({self.max_depth} requests "
                    "waiting); retry after backoff")
            self._items.append(req)
            self._depth.set(len(self._items))
            self._depth_peak.set_max(len(self._items))
            self._cond.notify()

    def shed(self, req: Request) -> None:
        """Complete ``req`` exceptionally as shed (deadline spent before
        its dispatch) and count it. The shed lands in the flight recorder
        stamped with the request's trace ID — a shed request produced no
        work, so the recorder is its only footprint."""
        self._shed_n.inc()
        spent = req.deadline.seconds if req.deadline is not None else 0.0
        try:
            events.record("deadline_shed", f"{self._prefix}.shed",
                          trace_id=req.trace_id, budget_s=spent,
                          rows=req.rows, k=req.k)
        except Exception:  # noqa: BLE001 - telemetry must not strand
            pass           # the future
        req.set_exception(DeadlineExceeded(
            f"raft_tpu_torch serve: request shed (deadline of {spent:.4g}s "
            "spent before dispatch); partial results empty", partial=None))

    def _drain_locked(self, batch: List[Request], rows: int,
                      max_requests: int,
                      max_rows: Optional[int]) -> Tuple[int, bool]:
        """Caller holds the lock: pop admissible requests into
        ``batch`` (shedding expired ones) until the request/row caps;
        the first request always pops regardless of ``max_rows``.
        Returns ``(rows, rows_full)`` — ONE admissibility loop shared
        by the blocking coalescing pop and the fabric's non-blocking
        drain, so shed semantics and the row-cap boundary can never
        diverge between them."""
        rows_full = False
        while self._items and len(batch) < max_requests:
            nxt = self._items[0]
            if nxt.deadline is not None and nxt.deadline.expired():
                self._items.popleft()
                self.shed(nxt)
                continue
            if (max_rows is not None and batch
                    and rows + nxt.rows > max_rows):
                rows_full = True
                break
            self._items.popleft()
            batch.append(nxt)
            rows += nxt.rows
        self._depth.set(len(self._items))
        return rows, rows_full

    def pop_batch(self, max_requests: int, max_wait_s: float,
                  max_rows: Optional[int] = None) -> List[Request]:
        """Blocking coalescing pop (see module docstring). Returns [] only
        once the queue is closed and drained; expired requests are shed
        here and never returned."""
        batch: List[Request] = []
        rows = 0
        window_end = None     # clock() bound set by the first pop
        with self._cond:
            while True:
                rows, rows_full = self._drain_locked(
                    batch, rows, max_requests, max_rows)
                if batch and window_end is None:
                    window_end = self._clock() + max_wait_s
                if batch and (self._closed or rows_full
                              or len(batch) >= max_requests
                              or self._clock() >= window_end):
                    return batch
                if self._closed and not self._items:
                    return batch
                remaining = (self._WAIT_SLICE_S if window_end is None
                             else max(0.0, window_end - self._clock()))
                self._cond.wait(min(remaining, self._WAIT_SLICE_S))

    def pop_nowait(self, max_requests: int,
                   max_rows: Optional[int] = None) -> List[Request]:
        """Non-blocking drain: whatever is admissible right now, up to
        the request/row caps, shedding expired requests on the way —
        the multi-tenant fabric's weighted-round-robin primitive
        (:mod:`raft_tpu_torch.serve.tenancy` visits many queues per round and
        must never park on an empty one)."""
        batch: List[Request] = []
        with self._cond:
            self._drain_locked(batch, 0, max_requests, max_rows)
        return batch

    def close(self) -> None:
        """Stop admitting; pop_batch drains what is queued, then returns
        empty batches."""
        with self._cond:
            self._closed = True
            self._cond.notify_all()
