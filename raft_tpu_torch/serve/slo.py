"""Declarative SLO engine over the serving metrics registry: counterpart
of ``raft_tpu/serve/slo.py`` (``Targets``, ``SLOEngine``, ``install``,
``installed``, ``uninstall``).

:meth:`SLOEngine.evaluate` judges a :class:`Targets` set — p99 latency,
recall floor, shed rate, demotion rate — over burn-rate windows: each
evaluation snapshots the registry into a bounded history ring and diffs
against the samples one fast and one slow window back, so a breach means
that the *recent* traffic violates the objective. Verdicts: ``ok``,
``warn`` (one window violated), ``breach`` (both). A target's move into
``breach`` records one ``slo_breach`` event (re-armed on recovery) and
counts under ``<name>.slo.breaches``. The recall target reads the
:class:`~raft_tpu_torch.serve.quality.RecallSentinel`'s rolling
``<name>.recall.<family>`` gauge, gated on its sample count. The clock is
injectable; ``install()`` registers the engine for the debugz snapshot.
The port has no guarded demotions (no fallback may hide a kernel), so
``guarded.demotions`` reads 0 and the demotion target never fires.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
import weakref
from typing import Callable, Dict, List, Optional, Tuple

from ..core import events

__all__ = ["Targets", "SLOEngine", "install", "installed", "uninstall"]

_VERDICT_RANK = {"ok": 0, "warn": 1, "breach": 2}


@dataclasses.dataclass(frozen=True)
class Targets:
    """Declarative serving objectives; None disables a target.

    ``max_shed_rate``/``max_demotion_rate`` are fractions (sheds per
    admitted request, guarded demotions per dispatched batch) over the
    evaluation window. ``recall_floor`` applies to the sentinel's
    rolling ``<name>.recall.<recall_family>`` estimate, gated on
    ``recall_min_samples``; ``recall_warn_margin`` arms the warn band
    above the floor."""

    p99_latency_s: Optional[float] = None
    recall_floor: Optional[float] = None
    max_shed_rate: Optional[float] = None
    max_demotion_rate: Optional[float] = None
    recall_family: str = "default"
    recall_warn_margin: float = 0.02
    recall_min_samples: int = 1


def _p_from_counts(bounds: Tuple[float, ...], counts: List[int], q: float,
                   hi_max: float) -> Optional[float]:
    """Percentile estimate from windowed (diffed) histogram bucket
    counts — the metrics.Histogram interpolation applied to a delta."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = (q / 100.0) * total
    cum = 0
    for i, c in enumerate(counts):
        if c and cum + c >= rank:
            lo = bounds[i - 1] if i > 0 else 0.0
            hi = bounds[i] if i < len(bounds) else hi_max
            if not math.isfinite(hi):
                return hi_max if math.isfinite(hi_max) else lo
            return lo + ((rank - cum) / c) * (hi - lo)
        cum += c
    return hi_max if math.isfinite(hi_max) else None


class SLOEngine:
    """Evaluate :class:`Targets` from a metrics registry over burn-rate
    windows. ``registry``: the serving registry (``<name>.*`` counters,
    latency histogram, recall gauges); ``guarded.demotions`` is read
    from the default process registry, as the JAX package's is. ``clock`` is injectable for
    deterministic tests."""

    def __init__(self, targets: Targets, registry=None, name: str = "serve",
                 fast_window_s: float = 60.0, slow_window_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic,
                 history: int = 256):
        from . import metrics as _metrics

        self.targets = targets
        self._name = name
        self._reg = registry or _metrics.default_registry
        self._default_reg = _metrics.default_registry
        self.fast_window_s = float(fast_window_s)
        self.slow_window_s = float(slow_window_s)
        self._clock = clock
        self._history: List[dict] = []
        self._history_cap = int(history)
        self._state: Dict[str, str] = {}
        self._breaches = self._reg.counter(f"{name}.slo.breaches")
        # one lock over history + transition state: a background
        # SnapshotWriter evaluating the installed engine must not race a
        # foreground debugz.snapshot into double-counting a breach
        # transition (the one-event-per-transition contract)
        self._lock = threading.Lock()

    # -- sampling ---------------------------------------------------------
    def _sample(self) -> dict:
        snap = self._reg.snapshot()
        cs, hs = snap["counters"], snap["histograms"]
        lat = hs.get(f"{self._name}.latency_s")
        demotions = self._default_reg.counter("guarded.demotions").value
        s = {
            "t": self._clock(),
            "shed": cs.get(f"{self._name}.shed", 0.0),
            "requests": cs.get(f"{self._name}.requests", 0.0),
            "demotions": demotions,
            "batches": cs.get(f"{self._name}.batches", 0.0),
            "lat_counts": None if lat is None
            else list(lat["buckets"].values()),
            "lat_bounds": None if lat is None
            else tuple(float(b) for b in list(lat["buckets"])[:-1]),
            "lat_max": (lat or {}).get("max"),
            "gauges": snap["gauges"],
        }
        return s

    def tick(self) -> None:
        """Record one history sample without evaluating (a background
        loop can tick finer than it alerts)."""
        s = self._sample()
        with self._lock:
            self._push_locked(s)

    def _push_locked(self, s: dict) -> None:
        self._history.append(s)
        if len(self._history) > self._history_cap:
            del self._history[: len(self._history) - self._history_cap]

    def _baseline_locked(self, now: float, window_s: float) -> dict:
        """Latest sample at least ``window_s`` old; oldest sample when
        history is younger than the window."""
        base = self._history[0]
        for s in self._history:
            if now - s["t"] >= window_s:
                base = s
            else:
                break
        return base

    # -- evaluation -------------------------------------------------------
    @staticmethod
    def _rate(cur: dict, base: dict, num: str, den: str) -> Optional[float]:
        dn = cur[den] - base[den]
        if dn <= 0:
            return None
        return max(0.0, cur[num] - base[num]) / dn

    @staticmethod
    def _win_p99(cur: dict, base: dict) -> Optional[float]:
        if cur["lat_counts"] is None:
            return None
        if base["lat_counts"] is None:
            diff = list(cur["lat_counts"])
        else:
            diff = [max(0, a - b) for a, b in
                    zip(cur["lat_counts"], base["lat_counts"])]
        hi = cur["lat_max"]
        return _p_from_counts(cur["lat_bounds"], diff, 99.0,
                              hi if hi is not None else math.inf)

    def _value_verdict(self, fast, slow, target) -> str:
        vf = fast is not None and fast > target
        vs = slow is not None and slow > target
        if vf and vs:
            return "breach"
        if vf or vs:
            return "warn"
        return "ok"

    def evaluate(self) -> dict:
        """Take a sample, judge every configured target, fire breach
        transitions, and return the JSON-safe verdict report (the
        debugz ``slo`` section). Thread-safe: concurrent evaluations
        (a background SnapshotWriter + a foreground snapshot) serialize,
        so a transition fires exactly one event."""
        cur = self._sample()
        with self._lock:
            return self._evaluate_locked(cur)

    def _evaluate_locked(self, cur: dict) -> dict:
        self._push_locked(cur)
        now = cur["t"]
        fast = self._baseline_locked(now, self.fast_window_s)
        slow = self._baseline_locked(now, self.slow_window_s)
        t = self.targets
        out: dict = {}
        if t.p99_latency_s is not None:
            vf, vs = self._win_p99(cur, fast), self._win_p99(cur, slow)
            out["p99_latency_s"] = {
                "target": t.p99_latency_s, "fast": vf, "slow": vs,
                "verdict": self._value_verdict(vf, vs, t.p99_latency_s)}
        if t.max_shed_rate is not None:
            vf = self._rate(cur, fast, "shed", "requests")
            vs = self._rate(cur, slow, "shed", "requests")
            out["shed_rate"] = {
                "target": t.max_shed_rate, "fast": vf, "slow": vs,
                "verdict": self._value_verdict(vf, vs, t.max_shed_rate)}
        if t.max_demotion_rate is not None:
            vf = self._rate(cur, fast, "demotions", "batches")
            vs = self._rate(cur, slow, "demotions", "batches")
            out["demotion_rate"] = {
                "target": t.max_demotion_rate, "fast": vf, "slow": vs,
                "verdict": self._value_verdict(vf, vs, t.max_demotion_rate)}
        if t.recall_floor is not None:
            g = cur["gauges"]
            est = g.get(f"{self._name}.recall.{t.recall_family}")
            n = g.get(f"{self._name}.recall.{t.recall_family}.samples", 0)
            rep = {"target": t.recall_floor, "value": est,
                   "samples": int(n), "family": t.recall_family}
            if est is None or n < t.recall_min_samples:
                rep["verdict"] = "ok"
                rep["note"] = "insufficient_samples"
            elif est < t.recall_floor:
                rep["verdict"] = "breach"
            elif est < t.recall_floor + t.recall_warn_margin:
                rep["verdict"] = "warn"
            else:
                rep["verdict"] = "ok"
            out["recall"] = rep
        overall = "ok"
        for key, rep in out.items():
            v = rep["verdict"]
            if _VERDICT_RANK[v] > _VERDICT_RANK[overall]:
                overall = v
            prev = self._state.get(key, "ok")
            if v == "breach" and prev != "breach":
                self._breaches.inc()
                try:
                    events.record(
                        "slo_breach", f"{self._name}.slo.{key}",
                        target=rep.get("target"),
                        value=rep.get("value", rep.get("fast")))
                except Exception:  # noqa: BLE001 - telemetry must not
                    pass           # fail the evaluation
            self._state[key] = v
        return {"verdict": overall, "targets": out,
                "windows": {"fast_s": self.fast_window_s,
                            "slow_s": self.slow_window_s},
                "samples": len(self._history)}

    def install(self) -> "SLOEngine":
        install(self)
        return self


# -- process slot for the debugz snapshot ----------------------------------
_installed: Optional["weakref.ref"] = None


def install(engine: SLOEngine) -> None:
    """Register ``engine`` as the process's debugz SLO source (weak:
    dropping the engine uninstalls it)."""
    global _installed
    _installed = weakref.ref(engine)


def installed() -> Optional[SLOEngine]:
    return _installed() if _installed is not None else None


def uninstall() -> None:
    global _installed
    _installed = None
