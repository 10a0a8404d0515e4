"""SLO-driven brownout: counterpart of ``raft_tpu/serve/degrade.py``
(``BrownoutController``, ``DEFAULT_LEVELS``, ``install``, ``installed``,
``uninstall``).

A :class:`BrownoutController` consumes
:class:`~raft_tpu_torch.serve.slo.SLOEngine` verdicts and walks a ladder
of cheaper serving configurations, trading a little recall for tail
latency, bounded by the recall floor the sentinel measures online:

* **step down** (level += 1) on a latency or shed-rate *breach*: smaller
  ``n_probes`` / ``itopk_size``, a wider batcher max-wait;
* **step up** (level -= 1) on a recall-floor breach (at once), or after
  the objectives have been green for ``up_after_s``;
* **never past the floor**: while the sentinel has samples and reports
  ``warn`` / ``breach``, further degradation is refused;
* **hysteresis**: at most one step per ``min_dwell_s``.

Levels are dicts of search-parameter overrides (applied by
``dataclasses.replace`` to whatever ``SearchParams`` the family uses;
unknown keys ignored) plus the key ``max_wait_scale``.
``make_searcher(..., degrade=ctl)`` on ivf_flat / ivf_pq / cagra applies
:meth:`BrownoutController.params` on every call, and
``MicroBatcher(..., degrade=ctl)`` scales its max-wait. Every step is a
``brownout`` event and moves the ``<name>.brownout.level`` gauge.

Knobs (the JAX package's names): ``RAFT_TPU_BROWNOUT_MIN_DWELL_S``
(default 5), ``RAFT_TPU_BROWNOUT_UP_AFTER_S`` (default 15),
``RAFT_TPU_BROWNOUT_MAX_LEVEL`` (default: every configured level).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
import weakref
from typing import Callable, Optional, Sequence

from ..core import events
from ..utils import env_float

__all__ = ["BrownoutController", "DEFAULT_LEVELS", "install", "installed",
           "uninstall"]

# a conservative generic ladder: level 0 is always baseline (no
# overrides); operators serving a specific family should write their own
# levels against its tuned params. Values here only bite where the field exists on the
# family's SearchParams.
DEFAULT_LEVELS: tuple = (
    {"max_wait_scale": 2.0},
    {"n_probes": 10, "itopk_size": 32, "max_wait_scale": 4.0},
)


class BrownoutController:
    """Walks a degradation ladder from SLO verdicts; see module
    docstring. ``levels``: the degraded steps (level 0 = baseline = no
    overrides is implicit). ``slo``: an engine for :meth:`poll` to
    evaluate (verdicts can also be fed directly via
    :meth:`on_report`). ``clock`` is injectable for deterministic
    tests."""

    def __init__(self, levels: Optional[Sequence[dict]] = None, *,
                 slo=None, min_dwell_s: Optional[float] = None,
                 up_after_s: Optional[float] = None,
                 registry=None, name: str = "serve",
                 clock: Callable[[], float] = time.monotonic):
        from . import metrics as _metrics

        self._ladder = [{}] + [dict(lv) for lv in
                               (DEFAULT_LEVELS if levels is None
                                else levels)]
        max_lv = int(env_float("RAFT_TPU_BROWNOUT_MAX_LEVEL",
                            len(self._ladder) - 1))
        self.max_level = max(0, min(max_lv, len(self._ladder) - 1))
        self.min_dwell_s = (
            env_float("RAFT_TPU_BROWNOUT_MIN_DWELL_S", 5.0)
            if min_dwell_s is None else float(min_dwell_s))
        self.up_after_s = (
            env_float("RAFT_TPU_BROWNOUT_UP_AFTER_S", 15.0)
            if up_after_s is None else float(up_after_s))
        self._slo = slo
        self._name = name
        self._clock = clock
        self._reg = registry or _metrics.default_registry
        self._gauge = self._reg.gauge(f"{name}.brownout.level")
        self._gauge.set(0)
        self._steps = self._reg.counter(f"{name}.brownout.transitions")
        self._lock = threading.Lock()
        self._level = 0
        self._last_step_at = -float("inf")
        self._green_since: Optional[float] = None
        # bounded transition log: the bench artifact and debugz read it
        self._transitions: collections.deque = collections.deque(maxlen=64)

    # -- hot-path reads ---------------------------------------------------
    # These three run per request/batch on the serving path and read the
    # current level lock-free by design: ``_level`` is a GIL-atomic int,
    # ``_ladder`` is frozen after __init__, and a one-step-stale level is
    # exactly as correct as a fresh one (the controller's own dwell is
    # seconds). Taking the lock here would serialize every dispatch
    # against the control loop for nothing.
    @property
    def level(self) -> int:
        # lint: waive(unlocked-attr): GIL-atomic int peek, hot path
        return self._level

    def params(self, base):
        """Apply the current level's overrides to a ``SearchParams``
        dataclass (fields the class doesn't have are ignored — one
        ladder can serve several families). Returns ``base`` unchanged
        at level 0."""
        # lint: waive(unlocked-attr): GIL-atomic int peek, hot path
        lv = self._ladder[self._level]
        if not lv or base is None:
            return base
        names = {f.name for f in dataclasses.fields(base)}
        over = {k: v for k, v in lv.items() if k in names}
        return dataclasses.replace(base, **over) if over else base

    def max_wait_scale(self) -> float:
        """Batch max-wait multiplier at the current level (>= 1.0):
        under brownout the batcher coalesces harder — bigger batches,
        fewer dispatches — at the cost of queue wait."""
        # lint: waive(unlocked-attr): GIL-atomic int peek, hot path
        return float(self._ladder[self._level].get("max_wait_scale", 1.0))

    # -- control loop -----------------------------------------------------
    def poll(self) -> dict:
        """Evaluate the attached SLO engine and act on its verdicts.
        Returns the engine report with ``brownout_level`` attached."""
        if self._slo is None:
            with self._lock:
                return {"brownout_level": self._level}
        report = self._slo.evaluate()
        # on_report returns the post-step level from under its own lock
        # hold — re-reading self._level here could see a racing step
        report["brownout_level"] = self.on_report(report)
        return report

    def on_report(self, report: dict) -> int:
        """Consume one SLO verdict report (``SLOEngine.evaluate()``
        shape) and maybe step the ladder; returns the level after."""
        t = report.get("targets", {})

        def verdict(key):
            return t.get(key, {}).get("verdict", "ok")

        lat_verdicts = (verdict("p99_latency_s"), verdict("shed_rate"))
        lat_breach = "breach" in lat_verdicts
        mem_breach = verdict("device_bytes") == "breach"
        rec = t.get("recall", {})
        rec_v = rec.get("verdict", "ok")
        rec_watched = (int(rec.get("samples", 0) or 0) > 0
                       and rec.get("note") != "insufficient_samples")
        with self._lock:
            now = self._clock()
            # the recovery timer requires GREEN, not merely not-breach:
            # a sustained latency "warn" (one window still violated)
            # accruing green time would step up straight back into the
            # breach — the flap the sustained-green rule exists to stop
            all_ok = (all(v == "ok" for v in lat_verdicts)
                      and rec_v == "ok" and not mem_breach)
            if not all_ok:
                self._green_since = None
            elif self._green_since is None:
                self._green_since = now
            if mem_breach:
                # the memory axis: a report of device bytes over their
                # budget steps DOWN the ladder instead of running out.
                # Memory outranks even the recall-floor refusal — a
                # floor defended into an OOM serves nothing — and skips
                # the dwell: the breach is measured headroom, not a
                # tail blip
                self._step_locked(+1, now, "memory", urgent=True)
            elif rec_v == "breach" and rec_watched:
                # quality floor wins over everything: climb back toward
                # baseline even while latency still burns — and without
                # waiting out the dwell (hysteresis exists to stop
                # flapping, not to hold serving below a measured floor)
                self._step_locked(-1, now, "recall_floor", urgent=True)
            elif lat_breach:
                if rec_watched and rec_v != "ok":
                    # the sentinel says recall is AT the floor: refuse
                    # to trade away quality we can see is already gone
                    pass
                else:
                    self._step_locked(+1, now, "latency")
            elif (all_ok and self._level > 0
                    and self._green_since is not None
                    and now - self._green_since >= self.up_after_s):
                self._step_locked(-1, now, "recovered")
            return self._level

    def _step_locked(self, delta: int, now: float, reason: str,
                     urgent: bool = False) -> None:
        if not urgent and now - self._last_step_at < self.min_dwell_s:
            return
        new = max(0, min(self._level + delta, self.max_level))
        if new == self._level:
            return
        old, self._level = self._level, new
        self._last_step_at = now
        tr = {"ts": time.time(), "from": old, "to": new, "reason": reason}
        self._transitions.append(tr)
        self._gauge.set(new)
        self._steps.inc()
        try:
            events.record("brownout", f"{self._name}.brownout",
                          level_from=old, level_to=new, reason=reason)
        except Exception:  # noqa: BLE001 - telemetry must not block
            pass           # the control loop

    # -- introspection ----------------------------------------------------
    def snapshot(self) -> dict:
        """JSON-safe view for the debugz ``brownout`` section and the
        bench artifact."""
        with self._lock:
            return {
                "level": self._level,
                "max_level": self.max_level,
                "min_dwell_s": self.min_dwell_s,
                "up_after_s": self.up_after_s,
                "ladder": [dict(lv) for lv in self._ladder],
                "transitions": [dict(tr) for tr in self._transitions],
            }

    def install(self) -> "BrownoutController":
        install(self)
        return self


# -- process slot for the debugz snapshot (mirrors serve/slo.py) -----------
_installed: Optional["weakref.ref"] = None


def install(controller: BrownoutController) -> None:
    """Register ``controller`` as the process's debugz brownout source
    (weak: dropping the controller uninstalls it)."""
    global _installed
    _installed = weakref.ref(controller)


def installed() -> Optional[BrownoutController]:
    return _installed() if _installed is not None else None


def uninstall() -> None:
    global _installed
    _installed = None
