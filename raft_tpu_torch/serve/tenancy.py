"""Multi-tenant serving fabric: counterpart of ``raft_tpu/serve/tenancy.py``
(``TokenBucket``, ``Tenant`` with ``swap`` / ``retire``, ``ServeFabric``,
``RateLimitedError``, ``install``).

A :class:`ServeFabric` owns named :class:`Tenant`\\ s, each binding an
index (any family, the mutable index and the sharded IVF families among
them) through its family's ``make_searcher``, its own metrics
:class:`~raft_tpu_torch.serve.metrics.Registry`, and optionally its own
:class:`~raft_tpu_torch.serve.slo.SLOEngine` and
:class:`~raft_tpu_torch.serve.degrade.BrownoutController`:

* **Weighted-fair admission**: per-tenant bounded queues drained by one
  worker in deficit-weighted round robin (each round credits ``weight x
  RAFT_TPU_TENANT_QUANTUM`` query rows a tenant). Drained requests
  co-batch across tenants that share a searcher closure, and every
  dispatch pads to the one shared ladder.
* **Token-bucket self-shedding**: a tenant with a ``rate`` sheds its own
  over-rate submits (``RateLimitedError``, ``<tenant>.shed``, one
  ``tenant_shed`` event each).
* **Repeat-traffic cache**: an optional
  :class:`~raft_tpu_torch.serve.qcache.QueryCache` answers byte-identical
  repeats without a dispatch; keys fold in the tenant's swap generation
  (and a mutable index's merge generation); sampled hits go to the
  tenant's recall sentinel under the ``qcache`` family.
* **Zero-downtime swap**: :meth:`Tenant.swap` warms the replacement's
  searcher at the shapes the tenant has served, then flips it in under
  the tenant lock; a dispatch in flight finishes on the old closure,
  queued requests run on the new one, one ``tenant_swap`` event. The old
  index is released at the next :meth:`ServeFabric.tick`.

A dispatch runs on the fabric's ``device`` (the card unless ``"cpu"``):
the block is copied from pinned memory with ``non_blocking=True``, the
results into pinned buffers behind the launches, and the worker waits on
one CUDA event before slicing them (no double buffering here, as in the
JAX package's fabric).

Knobs: ``RAFT_TPU_TENANT_QUANTUM`` (default 64), ``RAFT_TPU_TENANT_RATE``
/ ``RAFT_TPU_TENANT_BURST`` (default rate / burst; rate 0 = unlimited),
and the ``RAFT_TPU_QCACHE_*`` cache knobs.
"""
from __future__ import annotations

import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from ..core import events, tracing
from ..core.deadline import DeadlineExceeded
from ..core.errors import expects
from ..utils import env_float, env_int, resolve_device
from . import warmup as _warmup
from .admission import AdmissionQueue, QueueFullError, Request, SearchResult
from .batcher import (BucketLadder, _queue_host_copies, coalesce_block,
                      host_queries, triage_partial)

__all__ = ["ServeFabric", "Tenant", "TokenBucket", "RateLimitedError",
           "install", "installed", "uninstall"]


class RateLimitedError(QueueFullError):
    """Raised by ``submit`` when the tenant's token bucket is empty —
    the tenant exceeded ITS OWN admission rate (backpressure scoped to
    one tenant; the others are unaffected)."""


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.
    One token per request; ``try_take`` never blocks."""

    def __init__(self, rate: float, burst: Optional[float] = None,
                 clock: Callable[[], float] = time.monotonic):
        self.rate = float(rate)
        self.burst = float(burst if burst is not None else max(rate, 1.0))
        self._clock = clock
        self._lock = threading.Lock()
        self._tokens = self.burst
        self._last = clock()

    def try_take(self, n: float = 1.0) -> bool:
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            if self._tokens >= n:
                self._tokens -= n
                return True
            return False

    def level(self) -> float:
        """Current token level (refreshed, not consumed)."""
        with self._lock:
            now = self._clock()
            self._tokens = min(self.burst,
                               self._tokens + (now - self._last) * self.rate)
            self._last = now
            return self._tokens


class _TenantRequest(Request):
    """A :class:`~raft_tpu_torch.serve.admission.Request` plus its tenant
    back-reference and (optional) cache key — what the fabric worker
    needs at demux to credit the right registry and populate the
    cache."""

    __slots__ = ("tenant", "cache_key")

    def __init__(self, tenant: "Tenant", queries, k, deadline=None,
                 enqueued_at: float = 0.0):
        super().__init__(queries, k, deadline, enqueued_at=enqueued_at)
        self.tenant = tenant
        self.cache_key = None


def _build_searcher(index, params, opts: dict) -> Callable:
    """Family dispatch onto the ``make_searcher`` hooks: sharded first
    (duck-typed), then mutable, then the single-device families."""
    if hasattr(index, "shards_ok") and hasattr(index, "family"):
        from ..parallel import sharded_ann

        return sharded_ann.make_searcher(index, params, **opts)
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq, mutable

    if isinstance(index, mutable.MutableIndex):
        return mutable.make_searcher(index, params, **opts)
    for mod in (cagra, ivf_flat, ivf_pq, brute_force):
        if isinstance(index, mod.Index):
            return mod.make_searcher(index, params, **opts)
    raise TypeError(
        f"no make_searcher for index type {type(index).__name__}")


def _params_sig(params, opts: dict) -> str:
    """Stable cache-key component for a tenant's frozen search policy.

    Opt values that are bitsets (a per-tenant ``filter=``) sign by
    content digest, not ``repr``: a large tensor reprs truncated
    ("..."), so two different filters could collide on one signature.
    ``Bitset.fingerprint()`` is a blake2b over the packed words."""
    def _sig(v):
        if hasattr(v, "fingerprint") and hasattr(v, "n_bits"):
            return f"bitset:{v.fingerprint()}"
        return repr(v)

    sig_opts = [(name, _sig(v)) for name, v in sorted(opts.items())]
    return f"{params!r}|{sig_opts!r}"


class Tenant:
    """One named tenant inside a :class:`ServeFabric` (construct via
    :meth:`ServeFabric.add_tenant`). Public attributes: ``name``,
    ``weight``, ``registry`` (the tenant's private metrics registry),
    ``queue``, ``slo``, ``brownout``, ``sentinel``, ``bucket``."""

    def __init__(self, fabric: "ServeFabric", name: str, search_fn,
                 index=None, *, weight: float = 1.0, queue_depth: int = 256,
                 registry=None, slo=None, brownout=None, sentinel=None,
                 bucket: Optional[TokenBucket] = None,
                 params_sig: str = ""):
        from . import metrics as _metrics

        expects(weight > 0, "tenant weight must be positive, got %s", weight)
        self._fabric = weakref.proxy(fabric)
        self.name = str(name)
        self.weight = float(weight)
        self.registry = registry or _metrics.Registry()
        self.queue = AdmissionQueue(queue_depth, registry=self.registry,
                                    prefix=self.name, clock=fabric._clock)
        self.slo = slo
        self.brownout = brownout
        self.sentinel = sentinel
        self.bucket = bucket
        r = self.registry
        self._requests = r.counter(f"{self.name}.requests")
        self._served = r.counter(f"{self.name}.served")
        self._shed_n = r.counter(f"{self.name}.shed")
        self._batches = r.counter(f"{self.name}.batches")
        self._errors = r.counter(f"{self.name}.errors")
        self._dlx = r.counter(f"{self.name}.deadline_exceeded")
        self._latency = r.histogram(f"{self.name}.latency_s")
        self._hits = r.counter(f"{self.name}.qcache.hits")
        self._misses = r.counter(f"{self.name}.qcache.misses")
        # swap/search state under the tenant lock (the fabric worker
        # reads the closure per drain round via searcher())
        self._lock = threading.Lock()
        self._search = search_fn
        self._index = index
        self._gen = 0
        self._retired_refs: List[tuple] = []
        self._params_sig = params_sig
        # worker-thread-only state (never touched under a lock): WRR
        # deficit credit and the set of (rows, k) buckets this tenant
        # has actually been served at (the swap warm set)
        self._deficit = 0
        self._shapes: set = set()

    # -- hot-ish reads ----------------------------------------------------
    def searcher(self) -> Tuple[Callable, int]:
        """The current (closure, generation) pair, read atomically —
        the fabric worker calls this once per drain round, so a swap
        lands between rounds, never inside one."""
        with self._lock:
            return self._search, self._gen

    @property
    def generation(self) -> int:
        with self._lock:
            return self._gen

    def cache_params_key(self) -> str:
        """Cache-key component folding in the frozen search policy, the
        swap generation, and — for a mutable index — the merge
        generation, so a generation flip orphans every older entry."""
        with self._lock:
            gen, idx, sig = self._gen, self._index, self._params_sig
        mg = getattr(idx, "generation", None)
        key = f"{sig}|g{gen}"
        return key if mg is None else f"{key}|m{int(mg)}"

    # -- swap -------------------------------------------------------------
    def swap(self, new_index=None, *, search_fn=None, params=None,
             warm: bool = True, **opts) -> int:
        """Replace this tenant's index with zero downtime: build the
        replacement's searcher, pre-warm it at the shapes this tenant
        has served (full shared ladder before any traffic), then flip
        atomically under the tenant lock. Queued and future requests
        dispatch on the replacement; a dispatch already in flight
        finishes on the old closure (its results are still this
        tenant's — nothing is dropped or mis-routed). The old index is
        retained until the next :meth:`ServeFabric.tick` retires it.

        Returns the new generation. ``search_fn`` overrides the family
        ``make_searcher`` dispatch (stub closures, custom engines)."""
        expects(new_index is not None or search_fn is not None,
                "swap needs a new index or an explicit search_fn")
        fab = self._fabric
        fn = search_fn if search_fn is not None else _build_searcher(
            new_index, params, opts)
        # the worker mutates _shapes concurrently (set.add is atomic but
        # iterating a growing set can raise) — retry, the quality
        # ops_snapshot precedent
        served: list = []
        for _ in range(4):
            try:
                served = sorted(self._shapes)
                break
            except RuntimeError:
                continue
        if warm:
            # off the hot path: the worker keeps serving the old
            # generation while every served shape pays its first call
            # (warmup-labelled, so the first-call watch stays quiet)
            _warmup.warmup(fn, fab.ladder, fab._dim,
                           registry=self.registry,
                           name=f"{self.name}.swap",
                           shapes=served or None)
        with self._lock:
            old_index, old_fn = self._index, self._search
            self._search = fn
            if new_index is not None:
                # a search_fn-only swap keeps the index binding: the
                # closure changed, the backing (and its mutable merge
                # generation, which cache_params_key folds in) did not
                self._index = new_index
            self._gen += 1
            gen = self._gen
            self._params_sig = _params_sig(params, opts) \
                if search_fn is None else self._params_sig
            # hold the old pair until tick(): an in-flight dispatch may
            # still be computing on it
            self._retired_refs.append((old_index, old_fn, fab._clock()))
        cache = fab.cache
        if cache is not None:
            cache.invalidate_tenant(self.name)
        self.registry.counter(f"{self.name}.swaps").inc()
        try:
            events.record("tenant_swap", f"{self.name}.swap",
                          generation=gen,
                          warmed_shapes=[f"{m}x{k}" for m, k in served],
                          family=type(new_index).__module__.rsplit(
                              ".", 1)[-1] if new_index is not None else None)
        except Exception:  # noqa: BLE001 - telemetry must not fail a swap
            pass
        return gen

    def retire(self) -> int:
        """Release retired (index, searcher) pairs (maintenance-tick
        half of :meth:`swap`); returns how many were dropped."""
        with self._lock:
            dropped, self._retired_refs = self._retired_refs, []
        return len(dropped)

    # -- introspection ----------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe per-tenant view for the debugz ``tenants``
        section: queue state, weight, traffic counters, brownout level,
        SLO verdict, cache hit rate, swap generation."""
        with self._lock:
            gen = self._gen
            retired = len(self._retired_refs)
        # the worker mutates _shapes concurrently (same hazard as
        # swap's warm-set read) — retry the iteration
        shapes: list = []
        for _ in range(4):
            try:
                shapes = sorted(f"{m}x{k}" for m, k in self._shapes)
                break
            except RuntimeError:
                continue
        hits, misses = self._hits.value, self._misses.value
        out = {
            "weight": self.weight,
            "generation": gen,
            "retired_pending": retired,
            "queue_depth": len(self.queue),
            "queue_max_depth": self.queue.max_depth,
            "requests": int(self._requests.value),
            "served": int(self._served.value),
            "shed": int(self._shed_n.value),
            "errors": int(self._errors.value),
            "served_shapes": shapes,
            "qcache": {
                "hits": int(hits), "misses": int(misses),
                "hit_rate": round(hits / (hits + misses), 4)
                if (hits + misses) > 0 else None,
            },
        }
        if self.bucket is not None:
            out["tokens"] = round(self.bucket.level(), 2)
            out["rate"] = self.bucket.rate
        if self.brownout is not None:
            out["brownout_level"] = self.brownout.level
        if self.slo is not None:
            try:
                rep = self.slo.evaluate()
                out["slo"] = {"verdict": rep["verdict"],
                              "targets": rep["targets"]}
            except Exception as e:  # noqa: BLE001 - one broken engine
                out["slo"] = {"error": f"{type(e).__name__}: {e}"}
        return out


class ServeFabric:
    """The multi-tenant serving front end: per-tenant queues, one
    weighted-round-robin drain worker, co-batched dispatch at one shared
    :class:`~raft_tpu_torch.serve.batcher.BucketLadder`, an optional
    :class:`~raft_tpu_torch.serve.qcache.QueryCache`, and per-tenant
    SLO / brownout wiring (module docstring).

    ``dim`` is the query width every tenant serves. ``device``: where the
    tenants' indexes live (the card unless ``"cpu"``). ``cache=None``
    disables result caching. ``autostart=False`` lets a caller enqueue a
    backlog and drive :meth:`drain_once` by hand. ``clock`` is
    injectable."""

    _IDLE_WAIT_S = 0.02

    def __init__(self, dim: int, *, ladder: Optional[BucketLadder] = None,
                 name: str = "fabric", max_wait_s: float = 0.002,
                 max_batch_requests: int = 64, cache=None,
                 registry=None, quantum_rows: Optional[int] = None,
                 clock: Callable[[], float] = time.monotonic,
                 autostart: bool = True, device=None):
        from . import metrics as _metrics

        self._dim = int(dim)
        self.device = resolve_device(device)
        self._pin = self.device.type == "cuda"
        self.ladder = ladder or BucketLadder()
        self._name = name
        self._max_wait_s = float(max_wait_s)
        self._max_batch = int(max_batch_requests)
        self.cache = cache
        self._clock = clock
        self._reg = registry or _metrics.default_registry
        self._quantum = (env_int("RAFT_TPU_TENANT_QUANTUM", 64)
                         if quantum_rows is None else int(quantum_rows))
        expects(self._quantum > 0, "quantum_rows must be positive")
        self._batches = self._reg.counter(f"{name}.batches")
        self._errors = self._reg.counter(f"{name}.errors")
        self._cobatched = self._reg.counter(f"{name}.cobatched_dispatches")
        # fabric lock guards the tenant table + rotation order + closed
        # flag; the condition wakes the drain worker on submits
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._tenants: Dict[str, Tenant] = {}
        self._order: List[str] = []
        self._closed = False
        self._thread: Optional[threading.Thread] = None
        _warmup.install_recompile_watch()
        if autostart:
            self.start()

    # -- tenant management ------------------------------------------------
    def add_tenant(self, name: str, index=None, *, search_fn=None,
                   params=None, weight: float = 1.0, queue_depth: int = 256,
                   targets=None, slo=None, brownout=None, levels=None,
                   sentinel=None, rate: Optional[float] = None,
                   burst: Optional[float] = None, registry=None,
                   warm: bool = False, **opts) -> Tenant:
        """Bind one tenant: an index (dispatched through its family's
        ``make_searcher``; or an explicit ``search_fn``), a WRR
        ``weight``, an optional token-bucket ``rate``/``burst``
        (``None`` reads ``RAFT_TPU_TENANT_RATE``/``_BURST``; rate 0 =
        unlimited), optional ``targets`` (builds a per-tenant
        :class:`~raft_tpu_torch.serve.slo.SLOEngine` +
        :class:`~raft_tpu_torch.serve.degrade.BrownoutController` over the
        tenant's private registry; pass prebuilt ``slo``/``brownout``
        instances for injected clocks or custom windows, ``levels``
        for the controller ladder), and an optional per-tenant
        ``sentinel`` (its ``on_regression`` hook is wired to emit
        ``qcache_stale`` + invalidate the tenant's cache entries when
        the ``qcache`` family crosses the floor). ``warm=True`` sweeps
        the full shared ladder through the searcher before the tenant
        serves."""
        from . import degrade as _degrade
        from . import metrics as _metrics
        from . import slo as _slo

        expects(search_fn is not None or index is not None,
                "add_tenant needs an index or a search_fn")
        fn = search_fn if search_fn is not None else _build_searcher(
            index, params, opts)
        reg = registry or _metrics.Registry()
        if slo is None and targets is not None:
            slo = _slo.SLOEngine(targets, registry=reg, name=name)
        if brownout is None and slo is not None:
            brownout = _degrade.BrownoutController(
                levels, slo=slo, registry=reg, name=name)
        if rate is None:
            rate = env_float("RAFT_TPU_TENANT_RATE", 0.0)
        if burst is None:
            env_burst = env_float("RAFT_TPU_TENANT_BURST", 0.0)
            burst = env_burst if env_burst > 0 else None
        bucket = (TokenBucket(rate, burst, clock=self._clock)
                  if rate and rate > 0 else None)
        t = Tenant(self, name, fn, index, weight=weight,
                   queue_depth=queue_depth, registry=reg, slo=slo,
                   brownout=brownout, sentinel=sentinel, bucket=bucket,
                   params_sig=_params_sig(params, opts))
        if sentinel is not None and self.cache is not None \
                and sentinel.on_regression is None:
            sentinel.on_regression = self._stale_hook(t)
        with self._cond:
            expects(name not in self._tenants,
                    "tenant %r already exists", name)
            expects(not self._closed, "fabric is closed")
            self._tenants[name] = t
            self._order.append(name)
            self._cond.notify()
        if warm:
            _warmup.warmup(fn, self.ladder, self._dim, registry=reg,
                           name=f"{name}.warmup")
        return t

    def _stale_hook(self, tenant: Tenant) -> Callable:
        """on_regression hook for a tenant's sentinel: a ``qcache``
        family floor crossing means the cache served provably-degraded
        answers — flight-record it and eagerly drop the tenant's
        entries."""
        fab_ref = weakref.ref(self)
        t_name, t_reg = tenant.name, tenant.registry

        def _hook(family, estimate, samples, trace_id):
            if family != "qcache":
                return
            try:
                events.record("qcache_stale", f"{t_name}.qcache",
                              trace_id=trace_id,
                              estimate=round(float(estimate), 4),
                              samples=int(samples))
            except Exception:  # noqa: BLE001 - telemetry must not kill
                pass           # the sentinel worker
            t_reg.counter(f"{t_name}.qcache.stale").inc()
            fab = fab_ref()
            if fab is not None and fab.cache is not None:
                fab.cache.invalidate_tenant(t_name)

        return _hook

    def tenant(self, name: str) -> Tenant:
        with self._lock:
            t = self._tenants.get(name)
        expects(t is not None, "unknown tenant %r", name)
        return t

    def tenants(self) -> List[Tenant]:
        with self._lock:
            return [self._tenants[n] for n in self._order]

    # -- client API -------------------------------------------------------
    def submit(self, tenant: str, queries, k: int, deadline=None,
               cache: bool = True) -> Request:
        """Enqueue one request for ``tenant``; returns its future.
        Raises :class:`RateLimitedError` past the tenant's token bucket
        (the tenant shedding ITSELF), ``QueueFullError`` past its queue
        depth, and ValueError-family errors for off-ladder shapes. A
        cache hit completes the future immediately — no queue, no
        dispatch."""
        t = self.tenant(tenant)
        q = host_queries(queries, self._dim)
        self.ladder.bucket_queries(q.shape[0])
        self.ladder.bucket_k(k)
        t._requests.inc()
        req = _TenantRequest(t, q, k, deadline,
                             enqueued_at=self._clock())
        if t.bucket is not None and not t.bucket.try_take():
            # the token-bucket self-shed: the hot tenant pays with its
            # own error budget, nobody else's
            t._shed_n.inc()
            try:
                events.record("tenant_shed", f"{t.name}.admission",
                              trace_id=req.trace_id, reason="rate_limited",
                              rows=req.rows, k=req.k)
            except Exception:  # noqa: BLE001 - telemetry must not block
                pass           # admission
            raise RateLimitedError(
                f"tenant {t.name!r} over its admission rate "
                f"({t.bucket.rate:g}/s); retry after backoff")
        if self.cache is not None:
            if cache:
                ck = self.cache.key(t.name, q, k, t.cache_params_key())
                hit = self.cache.get(ck)
                if hit is not None:
                    t._hits.inc()
                    req.set_result(SearchResult(hit[0], hit[1], None))
                    t._served.inc()
                    t._latency.observe(self._clock() - req.enqueued_at)
                    if t.sentinel is not None:
                        # police the hit: a stale entry must surface as
                        # a qcache-family recall regression
                        try:
                            t.sentinel.offer(q, k, hit[0], hit[1],
                                             family="qcache",
                                             trace_id=req.trace_id)
                        except Exception:  # noqa: BLE001 - telemetry
                            pass           # must not break serving
                    return req
                if ck is not None:
                    t._misses.inc()
                req.cache_key = ck
            else:
                self.cache.bypass()
        t.queue.submit(req)
        with self._cond:
            self._cond.notify()
        return req

    def search(self, tenant: str, queries, k: int, deadline=None,
               timeout: Optional[float] = None,
               cache: bool = True) -> SearchResult:
        """Synchronous convenience: submit + block for the result."""
        return self.submit(tenant, queries, k, deadline,
                           cache=cache).result(timeout)

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name=f"{self._name}-fabric", daemon=True)
        self._thread.start()

    def close(self, timeout: float = 10.0) -> None:
        """Stop admitting on every tenant, drain what is queued, stop
        the worker."""
        for t in self.tenants():
            t.queue.close()
        with self._cond:
            self._closed = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self) -> "ServeFabric":
        self.start()
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- maintenance ------------------------------------------------------
    def tick(self) -> dict:
        """One maintenance round — the fabric's ``SnapshotWriter`` hook
        (``SnapshotWriter(hooks=[fabric.tick])``): poll every tenant's
        brownout controller (which evaluates its SLO engine), and
        release indexes retired by swaps. Returns per-tenant verdict
        levels (JSON-safe)."""
        out: dict = {}
        for t in self.tenants():
            rep: dict = {"retired": t.retire()}
            try:
                if t.brownout is not None:
                    poll = t.brownout.poll()
                    rep["brownout_level"] = poll.get("brownout_level")
                    rep["slo_verdict"] = poll.get("verdict")
                elif t.slo is not None:
                    rep["slo_verdict"] = t.slo.evaluate()["verdict"]
            except Exception as e:  # noqa: BLE001 - one broken engine must
                rep["error"] = f"{type(e).__name__}: {e}"  # not kill the tick
            out[t.name] = rep
        return out

    def snapshot(self) -> dict:
        """JSON-safe fabric view for the debugz ``tenants`` section."""
        with self._lock:
            names = list(self._order)
            closed = self._closed
        out = {
            "name": self._name,
            "closed": closed,
            "quantum_rows": self._quantum,
            "dim": self._dim,
            "ladder": {"query_buckets": list(self.ladder.query_buckets),
                       "k_buckets": list(self.ladder.k_buckets)},
            "batches": int(self._batches.value),
            "cobatched_dispatches": int(self._cobatched.value),
            "tenants": {},
        }
        for n in names:
            try:
                out["tenants"][n] = self.tenant(n).snapshot()
            except Exception as e:  # noqa: BLE001 - one broken tenant
                out["tenants"][n] = {                 # must not hide the rest
                    "error": f"{type(e).__name__}: {e}"}
        if self.cache is not None:
            out["qcache"] = self.cache.snapshot()
        return out

    # -- worker -----------------------------------------------------------
    def _run(self) -> None:
        while True:
            try:
                n = self.drain_once()
            except Exception:  # noqa: BLE001 - the worker must survive
                self._errors.inc()  # any single round going wrong
                n = 0
            if n:
                continue
            with self._cond:
                if self._closed and all(
                        len(self._tenants[x].queue) == 0
                        for x in self._order):
                    return
                self._cond.wait(self._IDLE_WAIT_S)
                has_work = any(len(self._tenants[x].queue)
                               for x in self._order)
            # leading-edge coalescing: when traffic arrives on an idle
            # fabric, give co-batchable arrivals one max-wait window
            # before the round (under sustained load the rounds are
            # back-to-back and this never runs)
            if has_work and self._max_wait_s > 0:
                time.sleep(self._max_wait_s)

    def drain_once(self) -> int:
        """One deficit-weighted-round-robin round: credit every tenant
        ``weight × quantum`` rows, pop what the credit covers, group
        the drained requests by (searcher, k-bucket) — co-batching
        tenants that share a closure — and dispatch each group at the
        shared ladder. Public so tests and single-threaded embeddings
        can drive the fabric deterministically (``autostart=False``).
        Returns the number of requests drained."""
        with self._lock:
            order = list(self._order)
            if order:
                # rotate the visit order so equal-weight tenants take
                # turns going first
                self._order.append(self._order.pop(0))
            tenants = [self._tenants[n] for n in order]
        groups: Dict[tuple, dict] = {}
        total = 0
        for t in tenants:
            t._deficit = min(
                t._deficit + max(1, int(round(t.weight * self._quantum))),
                4 * self._quantum * max(1, int(round(t.weight))))
            reqs = t.queue.pop_nowait(
                self._max_batch, max_rows=min(t._deficit,
                                              self.ladder.max_queries))
            if not reqs:
                # classic DRR: an empty queue forfeits its credit (a
                # silent tenant must not bank unbounded burst rights)
                t._deficit = 0
                continue
            popped_rows = sum(r.rows for r in reqs)
            t._deficit = max(0, t._deficit - popped_rows)
            total += len(reqs)
            fn, _gen = t.searcher()
            for r in reqs:
                kb = self.ladder.bucket_k(r.k)
                g = groups.setdefault((id(fn), kb),
                                      {"fn": fn, "kb": kb, "reqs": [],
                                       "tenants": set()})
                g["reqs"].append(r)
                g["tenants"].add(t.name)
        for g in groups.values():
            if len(g["tenants"]) > 1:
                self._cobatched.inc()
            # chunk so a co-batched group never exceeds the top bucket
            chunk: List[_TenantRequest] = []
            rows = 0
            for r in g["reqs"]:
                if chunk and rows + r.rows > self.ladder.max_queries:
                    self._dispatch(g["fn"], g["kb"], chunk)
                    chunk, rows = [], 0
                chunk.append(r)
                rows += r.rows
            if chunk:
                self._dispatch(g["fn"], g["kb"], chunk)
        return total

    # -- dispatch (the batcher's coalesce/pad/demux, tenant-aware) --------
    def _dispatch(self, fn: Callable, kb: int,
                  reqs: List[_TenantRequest]) -> None:
        live: List[_TenantRequest] = []
        for r in reqs:
            if r.deadline is not None and r.deadline.expired():
                r.tenant.queue.shed(r)
            else:
                live.append(r)
        if not live:
            return
        rows = sum(r.rows for r in live)
        mb = self.ladder.bucket_queries(rows)
        block, offs = coalesce_block(live, mb, self._dim, pin=self._pin)
        q = block.to(self.device, non_blocking=True) if self._pin else block
        carried = [r.deadline for r in live if r.deadline is not None]
        dl = min(carried, key=lambda d: d.remaining()) if carried else None
        try:
            with tracing.bind_trace(*(r.trace_id for r in live)), \
                    _warmup.compile_context(f"{self._name}:{mb}x{kb}"):
                host, ev = _queue_host_copies(fn(q, kb, res=dl))
                if ev is not None:
                    ev.synchronize()
        except DeadlineExceeded as e:
            self._deliver_partial(fn, kb, live, offs, e)
            return
        except Exception as e:  # noqa: BLE001 - the worker must survive
            self._errors.inc()
            try:
                events.record("dispatch_error", f"{self._name}.batch",
                              trace_id=[r.trace_id for r in live],
                              error=f"{type(e).__name__}: {e}")
            except Exception:  # noqa: BLE001 - a record failure must not
                pass           # strand the futures
            for r in live:
                r.tenant._errors.inc()
                if not r.done():
                    r.set_exception(e)
            return
        self._demux(live, offs, host, mb, kb)

    def _demux(self, live: List[_TenantRequest], offs: List[int], host,
               mb: int, kb: int) -> None:
        d, i, shards_ok = host
        now = self._clock()
        self._batches.inc()
        seen = set()
        for r, o in zip(live, offs):
            res_r = SearchResult(d[o:o + r.rows, :r.k],
                                 i[o:o + r.rows, :r.k], shards_ok)
            r.set_result(res_r)
            t = r.tenant
            t._served.inc()
            t._latency.observe(now - r.enqueued_at)
            t._shapes.add((mb, kb))
            if t.name not in seen:
                seen.add(t.name)
                t._batches.inc()
                t.registry.counter(f"{t.name}.dispatch.{mb}x{kb}").inc()
            if r.cache_key is not None and self.cache is not None and (
                    shards_ok is None or bool(shards_ok.all())):
                # never cache a DEGRADED sharded answer: a replayed hit
                # drops shards_ok, and the degradation would outlive
                # the shard's recovery (no generation flip defeats it)
                self.cache.put(r.cache_key, res_r.distances, res_r.indices)
            if t.sentinel is not None:
                try:
                    t.sentinel.offer(r.queries, r.k, res_r.distances,
                                     res_r.indices, trace_id=r.trace_id)
                except Exception:  # noqa: BLE001 - telemetry must not
                    pass           # break serving

    def _deliver_partial(self, fn: Callable, kb: int,
                         live: List[_TenantRequest], offs: List[int],
                         e: DeadlineExceeded) -> None:
        """Mid-batch deadline expiry — the batcher contract
        (:func:`raft_tpu_torch.serve.batcher.triage_partial` owns the
        slicing/triage and the termination argument), credited to each
        request's own tenant."""
        served, expired, retry = triage_partial(live, offs, e)
        now = self._clock()
        for r, res_r in served:
            r.set_result(res_r)
            r.tenant._served.inc()
            r.tenant._latency.observe(now - r.enqueued_at)
        for r, covered, own in expired:
            r.tenant._dlx.inc()
            try:
                events.record("deadline_exceeded",
                              f"{self._name}.dispatch",
                              trace_id=r.trace_id, rows=r.rows,
                              covered_rows=covered)
            except Exception:  # noqa: BLE001 - telemetry must not strand
                pass           # the future
            r.set_exception(DeadlineExceeded(
                f"raft_tpu_torch fabric: deadline exceeded mid-batch; "
                f"{covered} of {r.rows} query rows completed",
                partial=own))
        if retry:
            self._dispatch(fn, kb, retry)


# -- process slot for the debugz snapshot (mirrors serve/slo.py) -----------
_installed: Optional["weakref.ref"] = None


def install(fabric: ServeFabric) -> None:
    """Register ``fabric`` as the process's debugz tenants source
    (weak: dropping the fabric uninstalls it)."""
    global _installed
    _installed = weakref.ref(fabric)


def installed() -> Optional[ServeFabric]:
    return _installed() if _installed is not None else None


def uninstall() -> None:
    global _installed
    _installed = None
