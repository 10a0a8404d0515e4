"""Process-local serving metrics: counterpart of
``raft_tpu/serve/metrics.py`` (``Counter``, ``Gauge``, ``Histogram``,
``Registry``, the default registry and its shortcuts, ``snapshot``,
``render_text``, ``enable_span_metrics``).

The smallest registry that covers a serving runtime's signals (queue
depth, batch fill, padding waste, latency percentiles, shed and error
counters): plain Python, one lock an instrument, fixed-bucket histograms
(the JAX package's buckets, so a snapshot and a ``render_text`` export
are equal to its own for the same observations) with percentiles
interpolated inside the owning bucket and clamped to the observed
min/max. A default process registry, plus instances a caller creates:
the multi-tenant fabric gives each tenant its own.

:func:`enable_span_metrics` installs a :mod:`raft_tpu_torch.core.tracing`
timer, so every ``tracing.annotate`` / ``tracing.range`` span records a
``span.<name>`` duration histogram.
"""
from __future__ import annotations

import bisect
import math
import re
import threading
from typing import Callable, Dict, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "Registry", "default_registry",
    "registry", "counter", "gauge", "histogram", "snapshot",
    "render_text", "reset", "enable_span_metrics", "disable_span_metrics",
    "LATENCY_BUCKETS_S", "RATIO_BUCKETS", "MTTR_BUCKETS_S",
]

# Seconds-latency bounds, log-spaced from sub-ms dispatch to multi-second
# stragglers; the implicit final bucket is +inf.
LATENCY_BUCKETS_S: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0)

# Bounds for [0, 1] ratios (batch fill, padding waste).
RATIO_BUCKETS: Tuple[float, ...] = tuple(i / 8 for i in range(1, 9))

# Recovery-time bounds (``heal.mttr.<site>``, ``shard.mttr``): breaker
# probation alone is 30s by default and backoff caps at 600s, so MTTR
# lives in seconds-to-tens-of-minutes — far past LATENCY_BUCKETS_S'
# 10s ceiling, which would flatten every recovery into the +inf bucket.
MTTR_BUCKETS_S: Tuple[float, ...] = (
    0.1, 0.5, 1.0, 5.0, 15.0, 30.0, 60.0, 120.0, 300.0, 600.0,
    1800.0, 3600.0)


class Counter:
    """Monotonic count (requests served, batches shed, demotions)."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Gauge:
    """Last-write-wins level (queue depth, healthy shard count)."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def set_max(self, v: float) -> None:
        """Raise the gauge to ``v`` if higher (peak tracking)."""
        with self._lock:
            self._value = max(self._value, float(v))

    @property
    def value(self) -> float:
        with self._lock:
            return self._value


class Histogram:
    """Fixed-bucket histogram with count/sum/min/max and estimated
    percentiles. ``buckets`` are ascending upper bounds; values above the
    last bound land in an implicit +inf bucket whose percentile estimate
    is the observed max."""

    def __init__(self, name: str,
                 buckets: Tuple[float, ...] = LATENCY_BUCKETS_S):
        if not buckets:
            raise ValueError(f"histogram {name!r} needs at least one bucket")
        self.name = name
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts = [0] * (len(self.buckets) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self._counts[bisect.bisect_left(self.buckets, v)] += 1
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    def percentile(self, q: float) -> float:
        """Estimated q-th percentile (0..100): linear interpolation inside
        the owning bucket, clamped to the observed [min, max]. NaN when
        empty."""
        with self._lock:
            counts = list(self._counts)
            total, lo_seen, hi_seen = self._count, self._min, self._max
        if total == 0:
            return math.nan
        rank = (q / 100.0) * total
        cum = 0
        for i, c in enumerate(counts):
            if c and cum + c >= rank:
                lo = self.buckets[i - 1] if i > 0 else min(lo_seen, self.buckets[0])
                hi = self.buckets[i] if i < len(self.buckets) else hi_seen
                v = lo + ((rank - cum) / c) * (hi - lo)
                return min(max(v, lo_seen), hi_seen)
            cum += c
        return hi_seen

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            counts = list(self._counts)
            total, s = self._count, self._sum
            lo, hi = self._min, self._max
        return {
            "count": total,
            "sum": s,
            "min": lo if total else math.nan,
            "max": hi if total else math.nan,
            "p50": self.percentile(50),
            "p90": self.percentile(90),
            "p99": self.percentile(99),
            "buckets": {**{f"{b:g}": c for b, c in zip(self.buckets, counts)},
                        "+inf": counts[-1]},
        }


class Registry:
    """Named instrument registry. Instruments are get-or-create: the first
    caller fixes the type (and a histogram's buckets); a later request for
    the same name with a different type raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, factory: Callable[[], object]):
        with self._lock:
            m = self._metrics.get(name)
            if m is None:
                m = self._metrics[name] = factory()
            elif not isinstance(m, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(m).__name__}, requested {cls.__name__}")
            return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, lambda: Counter(name))

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, lambda: Gauge(name))

    def histogram(self, name: str,
                  buckets: Optional[Tuple[float, ...]] = None) -> Histogram:
        return self._get(
            name, Histogram,
            lambda: Histogram(name, buckets or LATENCY_BUCKETS_S))

    def snapshot(self) -> Dict[str, Dict[str, object]]:
        """Point-in-time plain-dict view (JSON-safe)."""
        with self._lock:
            items = sorted(self._metrics.items())
        out: Dict[str, Dict[str, object]] = {
            "counters": {}, "gauges": {}, "histograms": {}}
        for name, m in items:
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.snapshot()
        return out

    def render_text(self) -> str:
        """Prometheus-flavoured text export (counter/gauge/histogram with
        cumulative ``_bucket{le=...}`` lines)."""
        with self._lock:
            items = sorted(self._metrics.items())
        lines = []
        for name, m in items:
            n = _sanitize(name)
            if isinstance(m, Counter):
                lines += [f"# TYPE {n} counter", f"{n} {m.value:g}"]
            elif isinstance(m, Gauge):
                lines += [f"# TYPE {n} gauge", f"{n} {m.value:g}"]
            else:
                snap = m.snapshot()
                lines.append(f"# TYPE {n} histogram")
                cum = 0
                for b, c in snap["buckets"].items():
                    cum += c
                    le = b if b != "+inf" else "+Inf"
                    lines.append(f'{n}_bucket{{le="{le}"}} {cum}')
                lines += [f"{n}_sum {snap['sum']:g}",
                          f"{n}_count {snap['count']}"]
        return "\n".join(lines) + ("\n" if lines else "")

    def reset(self) -> None:
        with self._lock:
            self._metrics.clear()


def _sanitize(name: str) -> str:
    return re.sub(r"[^a-zA-Z0-9_]", "_", name)


# -- default process registry ---------------------------------------------
default_registry = Registry()


def registry() -> Registry:
    return default_registry


def counter(name: str) -> Counter:
    return default_registry.counter(name)


def gauge(name: str) -> Gauge:
    return default_registry.gauge(name)


def histogram(name: str, buckets=None) -> Histogram:
    return default_registry.histogram(name, buckets)


def snapshot() -> Dict[str, Dict[str, object]]:
    return default_registry.snapshot()


def render_text() -> str:
    return default_registry.render_text()


def reset() -> None:
    default_registry.reset()


# -- tracing integration ---------------------------------------------------
def enable_span_metrics(reg: Optional[Registry] = None) -> None:
    """Route :mod:`raft_tpu_torch.core.tracing` span durations into ``reg``
    (default registry when None): every annotate/range span observes a
    ``span.<name>`` latency histogram.

    One consumer per process: tracing has a single timer slot, so the
    last ``enable_span_metrics`` wins and ``disable_span_metrics``
    stops span metrics process-wide. Multi-tenant isolation applies to
    the serve runtime's own metrics (pass ``registry=`` to
    MicroBatcher), not to spans."""
    target = reg or default_registry
    from ..core import tracing

    tracing.set_timer(
        lambda name, seconds: target.histogram(f"span.{name}").observe(seconds))


def disable_span_metrics() -> None:
    from ..core import tracing

    tracing.set_timer(None)
