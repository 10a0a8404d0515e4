"""Shape-bucketed micro-batching: counterpart of ``raft_tpu/serve/batcher.py``
(``BucketLadder``, ``coalesce_block``, ``triage_partial``,
``MicroBatcher``).

Many callers, each with 1 to a few hundred queries, its own k and its
own deadline, go through one front end:

* **Coalesce**: requests drain from an :class:`~.admission.AdmissionQueue`
  under a max-wait / max-batch policy and are concatenated row-wise.
* **Bucket**: the block is padded with zero rows up to a fixed
  :class:`BucketLadder` of (query rows x k) shapes, and k is rounded up a
  bucket; both are sliced away at demux (top-k lists are sorted, and a
  row's answer does not depend on the other rows of its batch). After
  :meth:`MicroBatcher.warmup` has dispatched every shape once, traffic of
  any mix pays no first call (``serve/warmup.py``).
* **Dispatch** through a ``search_fn(queries, k, res=None)`` closure: the
  families' ``make_searcher`` or ``parallel.sharded_ann.make_searcher``
  (with ``allow_partial=True`` it returns ``shards_ok``, which each
  response carries and the metrics count).
* **Deadlines end to end**: a request's deadline is enforced at
  admission pop and again before dispatch (shed, ``<name>.shed``); the
  tightest live deadline rides into the search as ``res``, so an expiry
  mid-batch raises between query chunks and the finished rows are still
  delivered: requests inside them succeed, requests whose own deadline
  is spent fail with their slice attached, the rest are dispatched again.

On the card, a batch's block is built in pinned host memory and copied
to the device with ``non_blocking=True``; after the search is queued,
its results are copied into pinned host buffers with ``non_blocking=True``
and a ``torch.cuda.Event`` is recorded behind the copies. Demux waits on
that event alone (never ``torch.cuda.synchronize``, which would empty
the pipeline) — so while batch N's results are sliced on the host, batch
N+1 is already dispatched: double buffering, depth two, and an idle
queue demuxes at once. The worker queues its work on the current stream
of its device (the default stream). With ``device="cpu"`` the same
worker runs the searches on CPU tensors.

Stage telemetry: with ``trace_sample > 0`` (or ``RAFT_TPU_TRACE_SAMPLE``)
sampled batches record five stages a request — ``queue_wait``,
``bucket_pad``, ``dispatch`` (host wall of the search call), ``device``
(the wait on the batch's event), ``demux`` (slicing and delivery) — into
``<name>.stage.*_s`` histograms and the span log. The worker binds the
batch's trace IDs around dispatch, so events recorded mid-batch carry
the requests they hit. A kernel failure in a batch reaches its requests
as their error, counted under ``<name>.errors``; nothing is run again on
another engine.

Like the JAX package's, a filter policy ``suspended()`` block is
thread-local (``ops/filter_policy.py``): one in a caller does not reach
the worker thread that runs the search.
"""
from __future__ import annotations

import math
import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import events, faults, logging as rlog, tracing
from ..core.deadline import Deadline, DeadlineExceeded
from ..core.errors import expects
from ..utils import resolve_device
from . import warmup as _warmup
from .admission import AdmissionQueue, Request, SearchResult

__all__ = ["BucketLadder", "MicroBatcher", "coalesce_block",
           "triage_partial", "host_queries", "STAGES"]

# the five per-request stages
STAGES = ("queue_wait", "bucket_pad", "dispatch", "device", "demux")


def host_queries(queries, dim: int) -> torch.Tensor:
    """A request's query rows as a contiguous host (m, ``dim``) float32
    tensor (a numpy array or tensor in; a 1-d row becomes (1, dim))."""
    q = torch.as_tensor(queries).detach()
    q = q.to(device="cpu", dtype=torch.float32)
    if q.dim() == 1:
        q = q[None, :]
    expects(q.dim() == 2 and q.shape[1] == dim,
            "queries must be (m, %d), got %s", dim, tuple(q.shape))
    return q.contiguous()


def _host(t):
    return None if t is None else torch.as_tensor(t).detach().cpu()


def triage_partial(live: Sequence, offs: Sequence[int],
                   e: DeadlineExceeded):
    """Classify every request of a mid-batch deadline expiry: returns
    ``(served, expired, retry)`` — ``served`` ``[(request,
    SearchResult)]`` for requests whose rows all lie inside the delivered
    partial, ``expired`` ``[(request, covered_rows, own_partial)]`` for
    requests whose own deadline is spent (``own_partial`` their slice or
    None), ``retry`` the co-batched requests to dispatch again. Shared by
    :class:`MicroBatcher` and the fabric; every retry drops the expired
    owners, so the retried group's tightest deadline is strictly looser."""
    if e.partial is not None:
        pd, pi = _host(e.partial[0]), _host(e.partial[1])
        done = pd.shape[0]
    else:
        pd = pi = None
        done = 0
    served, expired, retry = [], [], []
    for r, o in zip(live, offs):
        if o + r.rows <= done:
            served.append((r, SearchResult(pd[o:o + r.rows, :r.k],
                                           pi[o:o + r.rows, :r.k], None)))
            continue
        if r.deadline is None or not r.deadline.expired():
            retry.append(r)
            continue
        own = None
        if done > o:
            own = (pd[o:done, :r.k], pi[o:done, :r.k])
        expired.append((r, max(0, done - o), own))
    return served, expired, retry


def coalesce_block(live: Sequence, mb: int, dim: int, pin: bool = False):
    """Concatenate the live requests' query rows into one zero-padded
    (mb, dim) float32 host tensor (in pinned memory when ``pin``);
    returns ``(block, offsets)`` with each request's row offset."""
    block = torch.zeros((mb, dim), dtype=torch.float32, pin_memory=pin)
    offs: List[int] = []
    off = 0
    for r in live:
        block[off:off + r.rows] = r.queries
        offs.append(off)
        off += r.rows
    return block, offs


def _queue_host_copies(out):
    """Queue the device→host copies of a search's output into pinned
    buffers behind its launches and record one event after them; returns
    ``((distances, indices, shards_ok), event)`` (event None on the
    CPU)."""
    shards_ok = None
    if isinstance(out, tuple) and len(out) == 3:
        d, i, shards_ok = out
    else:
        d, i = out
    if shards_ok is not None:
        shards_ok = np.asarray(_host(shards_ok) if isinstance(
            shards_ok, torch.Tensor) else shards_ok, bool)
    if not d.is_cuda:
        return (d, i, shards_ok), None
    stream = torch.cuda.current_stream(d.device)
    host = []
    for t in (d, i):
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t, non_blocking=True)
        host.append(h)
    ev = torch.cuda.Event()
    ev.record(stream)
    return (host[0], host[1], shards_ok), ev


class BucketLadder:
    """The fixed set of dispatch shapes: ascending query-row buckets x
    ascending k buckets. ``bucket_queries`` / ``bucket_k`` round a request
    up to the smallest covering bucket; anything beyond the largest is a
    submit-time error."""

    def __init__(self,
                 query_buckets: Sequence[int] = (8, 32, 128, 512),
                 k_buckets: Sequence[int] = (16, 64, 128)):
        self.query_buckets = tuple(int(b) for b in query_buckets)
        self.k_buckets = tuple(int(b) for b in k_buckets)
        for name, bs in (("query_buckets", self.query_buckets),
                         ("k_buckets", self.k_buckets)):
            expects(len(bs) > 0, "%s must be non-empty", name)
            expects(all(b > 0 for b in bs), "%s must be positive", name)
            expects(tuple(sorted(set(bs))) == bs,
                    "%s must be ascending and unique, got %s", name, bs)

    @property
    def max_queries(self) -> int:
        return self.query_buckets[-1]

    @property
    def max_k(self) -> int:
        return self.k_buckets[-1]

    def bucket_queries(self, m: int) -> int:
        expects(1 <= m <= self.max_queries,
                "request of %d query rows outside ladder (max bucket %d)",
                m, self.max_queries)
        return next(b for b in self.query_buckets if b >= m)

    def bucket_k(self, k: int) -> int:
        expects(1 <= k <= self.max_k,
                "k=%d outside ladder (max k bucket %d)", k, self.max_k)
        return next(b for b in self.k_buckets if b >= k)

    def shapes(self) -> List[Tuple[int, int]]:
        """Every (query_bucket, k_bucket) pair — the warmup set."""
        return [(mb, kb) for mb in self.query_buckets
                for kb in self.k_buckets]


class MicroBatcher:
    """Micro-batching front end over one index's search closure.

    ``search_fn(queries, k, res=None) -> (distances, indices)`` (or a
    3-tuple ending in ``shards_ok``) must take every ladder shape; ``dim``
    is the query width. ``device``: where the closure's index lives (the
    card unless ``"cpu"``; with no card and no ``device`` this raises).
    ``autostart=False`` lets a caller enqueue a backlog before the worker
    drains it. ``trace_sample``: the stage-telemetry rate (None reads
    ``RAFT_TPU_TRACE_SAMPLE``; 0 off). ``sentinel``: a
    :class:`~raft_tpu_torch.serve.quality.RecallSentinel` offered each
    served request after delivery. ``degrade``: a
    :class:`~raft_tpu_torch.serve.degrade.BrownoutController` whose level
    scales the coalescing max-wait (pair it with ``make_searcher(...,
    degrade=...)``).
    """

    def __init__(self, search_fn: Callable, dim: int, *,
                 ladder: Optional[BucketLadder] = None,
                 max_wait_s: float = 0.002,
                 max_batch_requests: int = 64,
                 queue_depth: int = 256,
                 registry=None,
                 name: str = "serve",
                 autostart: bool = True,
                 trace_sample: Optional[float] = None,
                 sentinel=None,
                 degrade=None,
                 clock: Callable[[], float] = time.monotonic,
                 device=None):
        from . import metrics as _metrics

        self._search = search_fn
        self._dim = int(dim)
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.ladder = ladder or BucketLadder()
        self._max_wait_s = float(max_wait_s)
        self._max_batch = int(max_batch_requests)
        self._name = name
        self._clock = clock
        self._reg = registry or _metrics.default_registry
        self._sentinel = sentinel
        self._degrade = degrade
        rate = tracing.sample_rate(trace_sample)
        # every ceil(1/rate)-th batch tells the full five-stage story
        self._probe_every = math.ceil(1.0 / rate) if rate > 0 else 0
        self._probe_tick = 0
        self._stages = None
        if self._probe_every:
            self._stages = {s: self._reg.histogram(f"{name}.stage.{s}_s")
                            for s in STAGES}
        # always-on first-call watch: a first call after warmup shows in
        # serve.recompiles and as a first_call event with this batcher's
        # dispatch bucket
        _warmup.install_recompile_watch()
        self.queue = AdmissionQueue(queue_depth, registry=self._reg,
                                    prefix=name, clock=clock)
        r = self._reg
        self._requests = r.counter(f"{name}.requests")
        self._served = r.counter(f"{name}.served")
        self._batches = r.counter(f"{name}.batches")
        self._errors = r.counter(f"{name}.errors")
        self._dlx = r.counter(f"{name}.deadline_exceeded")
        self._degraded = r.counter(f"{name}.degraded_batches")
        self._healthy = r.gauge(f"{name}.healthy_shards")
        self._latency = r.histogram(f"{name}.latency_s")
        self._batch_latency = r.histogram(f"{name}.batch_latency_s")
        self._fill = r.histogram(f"{name}.batch_fill",
                                 _metrics.RATIO_BUCKETS)
        self._padding = r.histogram(f"{name}.padding_waste",
                                    _metrics.RATIO_BUCKETS)
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"{self._name}-batcher", daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting, drain what is queued, stop the worker."""
        self.queue.close()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self) -> "MicroBatcher":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- client API -------------------------------------------------------
    def submit(self, queries, k: int,
               deadline: Optional[Deadline] = None) -> Request:
        """Enqueue a request; returns its future. Raises
        :class:`~.admission.QueueFullError` under backpressure and
        ``RaftError`` for off-ladder shapes."""
        q = host_queries(queries, self._dim)
        self.ladder.bucket_queries(q.shape[0])   # validate against ladder
        self.ladder.bucket_k(k)
        req = Request(q, k, deadline, enqueued_at=self._clock())
        self.queue.submit(req)
        self._requests.inc()
        return req

    def search(self, queries, k: int, deadline: Optional[Deadline] = None,
               timeout: Optional[float] = None) -> SearchResult:
        """Synchronous convenience: submit + wait for the result."""
        return self.submit(queries, k, deadline).result(timeout)

    def warmup(self) -> int:
        """Dispatch every ladder shape once through the live search path;
        returns the counted first calls (see
        :func:`raft_tpu_torch.serve.warmup.warmup`)."""
        return _warmup.warmup(self._search, self.ladder, self._dim,
                              registry=self._reg, name=self._name)

    # -- worker -----------------------------------------------------------
    def _run(self) -> None:
        # double buffering: `pending` is a dispatched group not yet
        # demuxed; group N+1 is dispatched before N is demuxed, and an
        # idle queue demuxes at once
        pending = None
        while True:
            wait = self._max_wait_s
            if self._degrade is not None:
                try:
                    wait *= self._degrade.max_wait_scale()
                except Exception:  # noqa: BLE001 - a broken controller
                    pass           # must not stall the worker
            if pending is not None and len(self.queue) == 0:
                pending = self._safe_demux(pending)
            # with a group pending, take only what is admissible now: a
            # queue whose requests were all shed must not hold the
            # pending group's delivery until the next arrival (JAX's
            # blocking pop, with no wait window, does)
            if pending is not None:
                batch = self.queue.pop_nowait(
                    self._max_batch, max_rows=self.ladder.max_queries)
            else:
                batch = self.queue.pop_batch(
                    self._max_batch, wait, max_rows=self.ladder.max_queries)
            if not batch:
                if pending is not None:
                    pending = self._safe_demux(pending)
                    continue
                if self.queue.closed:
                    return
                continue
            # operator knob: a stalled worker
            # (RAFT_TPU_FAULTS='slow_dispatch@<name>.batch=0.1')
            faults.sleep_if(f"{self._name}.batch")
            if self._stages is not None:
                now = self._clock()
                for r in batch:
                    r.dequeued_at = now
            groups: dict = {}
            for r in batch:
                groups.setdefault(self.ladder.bucket_k(r.k), []).append(r)
            for kb in sorted(groups):
                reqs = groups[kb]
                # a deadline-carrying group runs the chunked loop, which
                # checks the host clock between chunks: deliver the
                # pending batch before entering it
                if pending is not None and any(r.deadline is not None
                                               for r in reqs):
                    pending = self._safe_demux(pending)
                cur = None
                try:
                    cur = self._dispatch_phase(kb, reqs)
                except Exception as e:  # noqa: BLE001 - worker must survive
                    self._errors.inc()
                    rlog.log_warn(
                        "serve %s: batch dispatch failed (%s: %s)",
                        self._name, type(e).__name__, e)
                    try:
                        events.record(
                            "dispatch_error", f"{self._name}.batch",
                            trace_id=[r.trace_id for r in reqs],
                            error=f"{type(e).__name__}: {e}")
                    except Exception:  # noqa: BLE001 - a record failure
                        pass           # must not strand the futures
                    for r in reqs:
                        if not r.done():
                            r.set_exception(e)
                if pending is not None:
                    pending = self._safe_demux(pending)
                pending = cur

    def _safe_demux(self, pend) -> None:
        """Demux a dispatched group; a failure (an asynchronous kernel
        error surfacing at the event) fails that group's futures, never
        the worker. Returns None (the cleared pending slot)."""
        try:
            self._demux_phase(pend)
        except Exception as e:  # noqa: BLE001 - worker must survive
            self._errors.inc()
            rlog.log_warn("serve %s: batch demux failed (%s: %s)",
                          self._name, type(e).__name__, e)
            for r in pend["live"]:
                if not r.done():
                    r.set_exception(e)
        return None

    def _tightest_deadline(self, reqs: List[Request]) -> Optional[Deadline]:
        carried = [r.deadline for r in reqs if r.deadline is not None]
        if not carried:
            return None
        return min(carried, key=lambda d: d.remaining())

    def _dispatch_group(self, kb: int, reqs: List[Request]) -> None:
        """Dispatch + demux in one step (the re-dispatch after a mid-batch
        deadline expiry)."""
        pend = self._dispatch_phase(kb, reqs)
        if pend is not None:
            self._demux_phase(pend)

    def _dispatch_phase(self, kb: int, reqs: List[Request]):
        """Coalesce + pad + queue the search and its result copies.
        Returns the pending-demux state, or None when nothing was
        dispatched (all shed, or a deadline expired mid-dispatch and the
        partials were delivered)."""
        live = []
        for r in reqs:
            if r.deadline is not None and r.deadline.expired():
                self.queue.shed(r)
            else:
                live.append(r)
        if not live:
            return None
        probe = False
        if self._stages is not None:
            self._probe_tick += 1
            probe = (self._probe_tick - 1) % self._probe_every == 0
        rows = sum(r.rows for r in live)
        mb = self.ladder.bucket_queries(rows)
        t_pad = self._clock() if probe else 0.0
        block, offs = coalesce_block(live, mb, self._dim, pin=self._pin)
        q = block.to(self.device, non_blocking=True) if self._pin else block
        pad_dt = self._clock() - t_pad if probe else 0.0
        t0 = self._clock()
        try:
            with tracing.bind_trace(*(r.trace_id for r in live)), \
                    _warmup.compile_context(f"{self._name}:{mb}x{kb}"):
                out = self._search(q, kb,
                                   res=self._tightest_deadline(live))
                host, ev = _queue_host_copies(out)
        except DeadlineExceeded as e:
            self._deliver_partial(kb, live, offs, e)
            return None
        dt = self._clock() - t0
        return {"kb": kb, "live": live, "offs": offs, "host": host,
                "event": ev, "probe": probe, "pad_dt": pad_dt, "dt": dt,
                "mb": mb, "rows": rows}

    def _demux_phase(self, pend) -> None:
        """Wait on the group's event, slice its results back to the
        requests, deliver, and record the stage telemetry. Runs after the
        next group's dispatch is queued (the double buffer)."""
        kb, live, offs = pend["kb"], pend["live"], pend["offs"]
        probe, pad_dt, dt, mb, rows = (pend["probe"], pend["pad_dt"],
                                       pend["dt"], pend["mb"],
                                       pend["rows"])
        d, i, shards_ok = pend["host"]
        t_dev = self._clock() if probe else 0.0
        if pend["event"] is not None:
            pend["event"].synchronize()
        device_dt = self._clock() - t_dev if probe else 0.0
        t_dmx = self._clock() if probe else 0.0
        if shards_ok is not None:
            self._healthy.set(int(shards_ok.sum()))
            if not shards_ok.all():
                self._degraded.inc()
        results = [SearchResult(d[o:o + r.rows, :r.k],
                                i[o:o + r.rows, :r.k], shards_ok)
                   for r, o in zip(live, offs)]
        demux_dt = self._clock() - t_dmx if probe else 0.0
        now = self._clock()
        for r, res_r in zip(live, results):
            r.set_result(res_r)
            self._latency.observe(now - r.enqueued_at)
        if self._sentinel is not None:
            # after delivery, and guarded: telemetry must not break serving
            try:
                for r, res_r in zip(live, results):
                    self._sentinel.offer(
                        r.queries, r.k, res_r.distances, res_r.indices,
                        trace_id=r.trace_id)
            except Exception:  # noqa: BLE001
                pass
        if probe:
            try:
                tel = self._stages
                bucket = f"{mb}x{kb}"
                for r in live:
                    stages = {"queue_wait": max(0.0, r.dequeued_at
                                                - r.enqueued_at),
                              "bucket_pad": pad_dt, "dispatch": dt,
                              "device": device_dt, "demux": demux_dt}
                    for s, v in stages.items():
                        tel[s].observe(v)
                    tracing.log_spans(r.trace_id, stages, rows=r.rows,
                                      k=r.k, bucket=bucket)
            except Exception:  # noqa: BLE001 - telemetry must not
                pass           # break serving
        self._served.inc(len(live))
        self._batches.inc()
        self._reg.counter(f"{self._name}.dispatch.{mb}x{kb}").inc()
        self._batch_latency.observe(dt)
        self._fill.observe(rows / mb)
        self._padding.observe((mb - rows) / mb)

    def _deliver_partial(self, kb: int, live: List[Request],
                         offs: List[int], e: DeadlineExceeded) -> None:
        """Mid-batch deadline expiry (:func:`triage_partial`): requests
        inside the finished rows succeed, requests whose own deadline is
        spent fail with their slice attached, the rest are dispatched
        again — a request without a budget never fails on another's."""
        served, expired, retry = triage_partial(live, offs, e)
        now = self._clock()
        for r, res_r in served:
            r.set_result(res_r)
            self._latency.observe(now - r.enqueued_at)
            self._served.inc()
        for r, covered, own in expired:
            self._dlx.inc()
            try:
                events.record("deadline_exceeded", f"{self._name}.dispatch",
                              trace_id=r.trace_id, rows=r.rows,
                              covered_rows=covered)
            except Exception:  # noqa: BLE001 - telemetry must not strand
                pass           # the future
            r.set_exception(DeadlineExceeded(
                f"raft_tpu_torch serve: deadline exceeded mid-batch; "
                f"{covered} of {r.rows} query rows completed "
                f"({'attached' if own is not None else 'empty'})",
                partial=own))
        if retry:
            self._reg.counter(f"{self._name}.redispatched").inc(len(retry))
            self._dispatch_group(kb, retry)
