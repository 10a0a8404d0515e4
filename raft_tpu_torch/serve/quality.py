"""Quality observability: counterpart of ``raft_tpu/serve/quality.py``
(``RecallSentinel``, ``make_reference``, ``health``, ``watch_index``,
``unwatch_index``, ``health_snapshot``, ``device_bytes``,
``memz_snapshot``, ``export_health_jsonl``, ``ops_snapshot``).

* :class:`RecallSentinel` samples a share of served requests
  (``RAFT_TPU_RECALL_SAMPLE``, the ceil cadence of
  ``tracing.sample_rate``), runs them again through an exact reference on
  a bounded background thread, scores them with
  :func:`raft_tpu_torch.stats.metrics.neighborhood_recall`, and publishes
  rolling ``<name>.recall.<family>`` gauges. A rolling estimate that
  crosses the floor records one ``recall_regression`` event. Disabled it
  costs one flag check; a full queue drops samples (counted), never
  blocking serving. :func:`make_reference` builds the port's brute force
  over the served rows on the caller's device: on the card its searches
  run K2 and K1, on the current stream of the sentinel's thread (the
  default stream, which the batcher's worker shares).
* :func:`health` dispatches a family's index health report;
  :func:`watch_index` registers an index for the debugz ``health`` and
  ``memz`` sections; :func:`device_bytes` splits an index's device bytes
  by component.
"""
from __future__ import annotations

import collections
import math
import threading
import weakref
from typing import Callable, Dict, Optional

import torch

from ..core import events, tracing

__all__ = ["RecallSentinel", "make_reference", "health", "watch_index",
           "unwatch_index", "health_snapshot", "export_health_jsonl",
           "ops_snapshot", "device_bytes", "memz_snapshot"]

# live sentinels (weak): debugz reports every sentinel the process runs
_SENTINELS: "weakref.WeakSet[RecallSentinel]" = weakref.WeakSet()

# name -> weakref to a watched index (the operator's opt-in health set)
_WATCHED: Dict[str, "weakref.ref"] = {}


def _host_copy(a, dtype=None) -> torch.Tensor:
    """A host copy of a tensor or array (never an alias)."""
    t = torch.as_tensor(a).detach()
    return t.to(device="cpu", dtype=dtype or t.dtype, copy=True)


class RecallSentinel:
    """Online recall estimation against an exact reference.

    ``reference_fn(queries, k) -> (distances, indices)`` must be the
    exact answer for the served corpus (build one with
    :func:`make_reference`, or pass any callable). ``sample``: sampling rate in [0, 1] (None reads
    ``RAFT_TPU_RECALL_SAMPLE``; 0 disables — no worker thread is ever
    started and :meth:`offer` is one flag check). ``floor``: rolling
    recall below this emits a ``recall_regression`` event (None reads
    ``RAFT_TPU_RECALL_FLOOR``; unset = never). ``window``: rolling
    sample count per family; ``min_samples`` gates the floor check (and
    the published estimate's trustworthiness). ``max_pending`` bounds
    the background queue — offers beyond it are DROPPED (counted under
    ``<name>.recall.dropped``), never queued unboundedly and never
    blocking dispatch.
    """

    def __init__(self, reference_fn: Callable, *,
                 sample: Optional[float] = None,
                 floor: Optional[float] = None,
                 window: int = 32, min_samples: int = 4,
                 max_pending: int = 8,
                 registry=None, name: str = "serve",
                 family: str = "default", engine: str = "-",
                 eps: float = 1e-4, autostart: bool = True):
        import os

        from . import metrics as _metrics

        self._ref = reference_fn
        rate = tracing.sample_rate(sample, env="RAFT_TPU_RECALL_SAMPLE",
                                   name="recall sample")
        # ceil-cadence (the tracing.sample_rate contract): every
        # ceil(1/rate)-th offer is sampled, so the configured rate is an
        # upper bound on reference work, never exceeded
        self._every = math.ceil(1.0 / rate) if rate > 0 else 0
        self._tick = 0
        if floor is None:
            raw = os.environ.get("RAFT_TPU_RECALL_FLOOR", "")
            floor = float(raw) if raw else None
        if floor is not None and not 0.0 <= float(floor) <= 1.0:
            raise ValueError(
                f"recall floor must be in [0, 1], got {floor!r}")
        self.floor = None if floor is None else float(floor)
        self.window = int(window)
        self.min_samples = int(min_samples)
        self.max_pending = int(max_pending)
        self._eps = float(eps)
        self._name = name
        self._family = family
        self._engine = engine
        self._reg = registry or _metrics.default_registry
        self._sampled = self._reg.counter(f"{name}.recall.sampled")
        self._dropped = self._reg.counter(f"{name}.recall.dropped")
        self._scored = self._reg.counter(f"{name}.recall.scored")
        self._errors = self._reg.counter(f"{name}.recall.errors")
        self._regressions = self._reg.counter(f"{name}.recall.regressions")
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._pending: collections.deque = collections.deque()
        self._inflight = 0
        # per-family rolling windows + per-(family, engine) splits
        self._windows: Dict[str, collections.deque] = {}
        self._engine_windows: Dict[tuple, collections.deque] = {}
        # floor-crossing state per family: one event per crossing, not
        # one per sample below the floor; re-arms on recovery
        self._below: Dict[str, bool] = {}
        # optional floor-crossing hook, called (guarded) AFTER the
        # recall_regression event with (family, estimate, samples,
        # trace_id) — the multi-tenant fabric wires it to turn a
        # ``qcache``-family regression into a ``qcache_stale`` event +
        # eager cache invalidation (serve/tenancy.py); settable
        # post-construction (one consumer per sentinel, like the
        # tracing timer slot)
        self.on_regression: Optional[Callable] = None
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        _SENTINELS.add(self)
        if autostart and self._every:
            self.start()

    # -- lifecycle --------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return bool(self._every)

    def start(self) -> "RecallSentinel":
        if self._thread is None and self._every:
            with self._cond:
                self._stop = False
            self._thread = threading.Thread(
                target=self._run, name=f"{self._name}-recall-sentinel",
                daemon=True)
            self._thread.start()
        return self

    def close(self, timeout: float = 10.0) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            self._thread = None

    def __enter__(self) -> "RecallSentinel":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close()

    # -- hot-path probe ---------------------------------------------------
    def offer(self, queries, k: int, distances, indices, *,
              family: Optional[str] = None, engine: Optional[str] = None,
              trace_id: Optional[str] = None) -> bool:
        """Offer one served request for recall sampling. Returns True
        when the request was enqueued for scoring.

        Never blocks and never raises into serving: disabled = one flag
        check; unsampled tick = one increment; a full queue drops the
        sample (counted). The tick race under concurrent callers is
        benign — cadence skews, the rate bound holds."""
        if not self._every:
            return False
        self._tick += 1
        if (self._tick - 1) % self._every:
            return False
        # GIL-atomic flag peek on the serving hot path; the locked
        # re-check below stays authoritative.
        # lint: waive(unlocked-attr): hot-path peek, locked re-check below
        if self._stop:
            return False
        # pre-copy check: when the queue is already saturated, the
        # dispatch thread must not pay the host copies just to drop
        # them (the locked re-check below stays authoritative — this
        # unlocked read only saves work, never admits past the bound)
        # lint: waive(unlocked-attr): hot-path peek, locked re-check below
        if len(self._pending) >= self.max_pending:
            self._dropped.inc()
            return False
        try:
            item = {
                # host copies: the sample must not pin device memory
                # nor see later in-place mutation
                "queries": _host_copy(queries, torch.float32),
                "k": int(k),
                "distances": None if distances is None
                else _host_copy(distances),
                "indices": _host_copy(indices),
                "family": family or self._family,
                "engine": engine or self._engine,
                "trace_id": trace_id,
            }
        except Exception:  # noqa: BLE001 - a hostile payload must not
            self._errors.inc()   # break serving
            return False
        with self._cond:
            if self._stop:
                # stopped is not pressure: counting these as drops would
                # read as a saturated worker on the dashboard forever
                return False
            if len(self._pending) >= self.max_pending:
                self._dropped.inc()
                return False
            self._pending.append(item)
            self._cond.notify()
        self._sampled.inc()
        return True

    # -- background worker ------------------------------------------------
    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._pending and not self._stop:
                    self._cond.wait(0.1)
                if self._stop and not self._pending:
                    return
                item = self._pending.popleft()
                self._inflight += 1
            try:
                self._score(item)
            except Exception:  # noqa: BLE001 - a reference failure must
                self._errors.inc()  # not kill the sentinel
            finally:
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _score(self, item: dict) -> None:
        from ..stats import metrics as stats_metrics

        rd, ri = self._ref(item["queries"], item["k"])
        rec = float(stats_metrics.neighborhood_recall(
            item["indices"], _host_copy(ri),
            item["distances"],
            None if item["distances"] is None else _host_copy(rd),
            eps=self._eps))
        self._scored.inc()
        fam, eng = item["family"], item["engine"]
        with self._lock:
            win = self._windows.setdefault(
                fam, collections.deque(maxlen=self.window))
            win.append(rec)
            ewin = self._engine_windows.setdefault(
                (fam, eng), collections.deque(maxlen=self.window))
            ewin.append(rec)
            est = sum(win) / len(win)
            n_samples = len(win)
            eest = sum(ewin) / len(ewin)
        self._reg.gauge(f"{self._name}.recall.{fam}").set(est)
        self._reg.gauge(f"{self._name}.recall.{fam}.samples").set(n_samples)
        self._reg.gauge(f"{self._name}.recall.{fam}.{eng}").set(eest)
        self._check_floor(fam, est, n_samples, item["trace_id"])

    def _check_floor(self, fam: str, est: float, n_samples: int,
                     trace_id) -> None:
        if self.floor is None or n_samples < self.min_samples:
            return
        below = est < self.floor
        if below and not self._below.get(fam):
            self._regressions.inc()
            try:
                # stamped with the sample that crossed the floor — the
                # post-mortem starts from a concrete degraded request
                events.record(
                    "recall_regression", f"{self._name}.recall.{fam}",
                    trace_id=trace_id, estimate=round(est, 4),
                    floor=self.floor, samples=n_samples)
            except Exception:  # noqa: BLE001 - telemetry must not kill
                pass           # the worker
            hook = self.on_regression
            if hook is not None:
                try:
                    hook(fam, est, n_samples, trace_id)
                except Exception:  # noqa: BLE001 - a hostile hook must
                    pass           # not kill the scoring worker
        self._below[fam] = below

    # -- introspection ----------------------------------------------------
    def estimate(self, family: Optional[str] = None) -> Optional[float]:
        """Rolling recall estimate for ``family`` (ctor default when
        None); None until a sample has been scored."""
        with self._lock:
            win = self._windows.get(family or self._family)
            return sum(win) / len(win) if win else None

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every enqueued sample has been scored (tests,
        bench lanes). Returns False on timeout or when disabled with
        work pending."""
        import time as _time

        end = _time.monotonic() + timeout
        with self._cond:
            while self._pending or self._inflight:
                left = end - _time.monotonic()
                if left <= 0 or (self._thread is None and not self._stop):
                    return not (self._pending or self._inflight)
                self._cond.wait(min(left, 0.1))
        return True

    def snapshot(self) -> dict:
        """JSON-safe view for the debugz ``quality`` section."""
        with self._lock:
            fams = {
                fam: {
                    "estimate": round(sum(w) / len(w), 4) if w else None,
                    "samples": len(w),
                    "below_floor": bool(self._below.get(fam, False)),
                    "engines": {
                        e: round(sum(ew) / len(ew), 4)
                        for (f, e), ew in self._engine_windows.items()
                        if f == fam and ew},
                } for fam, w in self._windows.items()}
            pending = len(self._pending)
        return {
            "name": self._name,
            "enabled": self.enabled,
            "sample_every": self._every,
            "floor": self.floor,
            "window": self.window,
            "families": fams,
            "pending": pending,
            "sampled": int(self._sampled.value),
            "scored": int(self._scored.value),
            "dropped": int(self._dropped.value),
            "errors": int(self._errors.value),
        }


def make_reference(dataset, metric="sqeuclidean", device=None) -> Callable:
    """Exact brute-force reference closure over ``dataset`` for
    :class:`RecallSentinel`: ``ref(queries, k) -> (distances, indices)``
    host tensors, searched on ``device`` (the card unless ``"cpu"``)."""
    from ..neighbors import brute_force

    idx = brute_force.build(torch.as_tensor(dataset, dtype=torch.float32),
                            metric, device=device)

    def ref(queries, k):
        d, i = brute_force.search(idx, torch.as_tensor(queries), k)
        return d.cpu(), i.cpu()

    return ref


# -- index health introspection --------------------------------------------
def health(index, sample: int = 256) -> dict:
    """Per-family index health report (dispatches on the index type).
    Sharded indexes have no health report in the port yet."""
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq, mutable

    if isinstance(index, mutable.MutableIndex):
        return mutable.health(index, sample=sample)
    for mod in (cagra, ivf_flat, ivf_pq, brute_force):
        if isinstance(index, mod.Index):
            return mod.health(index, sample=sample)
    raise TypeError(
        f"no health report for index type {type(index).__name__}")


def watch_index(name: str, index) -> None:
    """Register ``index`` under ``name`` for the debugz ``health`` and
    ``memz`` sections (weakly: dropping the index drops the watch)."""
    _WATCHED[name] = weakref.ref(index)


def unwatch_index(name: str) -> None:
    _WATCHED.pop(name, None)


def _each_watched(report) -> dict:
    """``report(index)`` for every live watched index; a failing report
    becomes an ``{"error": ...}`` entry (one bad index must not take down
    the ops surface)."""
    out: dict = {}
    for name, ref in list(_WATCHED.items()):
        idx = ref()
        if idx is None:
            _WATCHED.pop(name, None)
            continue
        try:
            out[name] = report(idx)
        except Exception as e:  # noqa: BLE001
            out[name] = {"error": f"{type(e).__name__}: {e}"}
    return out


def health_snapshot(sample: int = 256) -> dict:
    """Health reports for every live watched index (debugz ``health``)."""
    return _each_watched(lambda idx: health(idx, sample=sample))


def _nbytes(*tensors) -> int:
    """Bytes of the tensors given; None and non-tensors count 0."""
    return int(sum(t.numel() * t.element_size() for t in tensors
                   if isinstance(t, torch.Tensor)))


def device_bytes(index) -> dict:
    """Per-component device byte decomposition of one index (the debugz
    ``memz`` section). Components: ``dataset`` (the row store with its
    norms, ids and scales; for IVF-PQ the ids, centers, codebooks and
    rotation), ``pq_codes``, ``edge_store`` (CAGRA's traversal store,
    ``pq_codes`` for its pq form), ``score_cache`` (CAGRA's candidate-dtype
    copies), ``delta_tier`` (a mutable index's unmerged rows, host-resident
    until merged, reported so the footprint is whole).
    ``bytes_per_vector`` divides the device total by every row the index
    answers for, host-streamed cold rows included; an attached host tier
    reports its own ``host_stream`` block."""
    from ..neighbors import brute_force, cagra, ivf_flat, ivf_pq, mutable

    comp: dict = {}
    if isinstance(index, mutable.MutableIndex):
        rep = {"family": "mutable"}
        sealed = index.sealed_index
        if sealed is not None:
            rep["sealed"] = device_bytes(sealed)
        delta = sum(int(a.nbytes) for a in
                    (index._d_vecs, index._d_ids, index._d_alive))
        cache = index._delta_cache
        if cache is not None:
            delta += _nbytes(*cache)
        rep["components"] = {"delta_tier": delta}
        rep["total_device_bytes"] = (
            rep.get("sealed", {}).get("total_device_bytes", 0) + delta)
        rep["n"] = int(index.size)
        return rep
    if isinstance(index, cagra.Index):
        family = "cagra"
        comp["dataset"] = _nbytes(index.dataset, index.graph,
                                  index.seed_nodes)
        es = index.edge_store
        if es is not None:
            comp["pq_codes" if es.mode == "pq" else "edge_store"] = _nbytes(
                es.vecs, es.aux, es.gp, es.cb, es.cb_scale)
        sc = _nbytes(index.score_bf16, *(index.score_i8 or ()))
        if sc:
            comp["score_cache"] = sc
    elif isinstance(index, brute_force.Index):
        family = "brute_force"
        comp["dataset"] = _nbytes(index.dataset, index.norms, index.scales)
    elif isinstance(index, ivf_flat.Index):
        family = "ivf_flat"
        comp["dataset"] = _nbytes(index.data, index.data_norms,
                                  index.source_ids, index.scales)
    elif isinstance(index, ivf_pq.Index):
        family = "ivf_pq"
        comp["pq_codes"] = _nbytes(index.codes)
        comp["dataset"] = _nbytes(index.source_ids, index.centers_rot,
                                  index.codebooks, index.rotation,
                                  index.row_norms)
    else:
        raise TypeError(
            f"no memz report for index type {type(index).__name__}")
    n = int(index.size)
    total = int(sum(comp.values()))
    rep = {"family": family, "n": n, "components": comp,
           "total_device_bytes": total}
    tier = getattr(index, "host_tier", None)
    if tier is not None:
        rep["host_stream"] = tier.snapshot()
        n += int(tier.cold_rows)
        rep["n_total"] = n
    rep["bytes_per_vector"] = round(total / n, 2) if n else None
    return rep


def memz_snapshot() -> dict:
    """Device-memory decomposition for every live watched index (debugz
    ``memz``)."""
    return _each_watched(device_bytes)


def export_health_jsonl(path: str, sample: int = 256) -> int:
    """Write one JSON line per watched index's health report; returns
    the report count."""
    import json
    import time as _time

    snap = health_snapshot(sample=sample)
    with open(path, "w") as f:
        for name, report in sorted(snap.items()):
            f.write(json.dumps({"ts": _time.time(), "index": name,
                                **report}, sort_keys=True, default=repr)
                    + "\n")
    return len(snap)


def ops_snapshot() -> dict:
    """The quality ops surface read by debugz: every live sentinel's
    rolling estimates plus the watched-index health set."""
    sentinels = []
    # WeakSet iteration can race a concurrent construction: retry
    for _ in range(4):
        try:
            sentinels = [s.snapshot() for s in _SENTINELS]
            break
        except RuntimeError:
            continue
    return {"sentinels": sentinels, "health": health_snapshot()}
