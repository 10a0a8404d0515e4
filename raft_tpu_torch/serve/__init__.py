"""The serving runtime: counterpart of ``raft_tpu/serve/`` — shape-bucketed
micro-batching over the families' ``make_searcher`` closures, admission
control, warmup, SLOs and brownout, the recall sentinel, the
multi-tenant fabric and its query cache, and a metrics registry.

- ``metrics``   counters / gauges / histograms, snapshot + text export,
                span timing
- ``admission`` bounded request queue, backpressure, deadline shedding
- ``batcher``   BucketLadder + MicroBatcher (coalesce / pad / dispatch /
                demux, double-buffered on the card)
- ``warmup``    ladder warmup, the first-call watch and count
- ``debugz``    the ops snapshot / text page + background writer
- ``quality``   online recall sentinel + index health and device bytes
- ``slo``       declarative SLO engine over the metrics registry
- ``degrade``   SLO-driven brownout ladder with hysteresis
- ``tenancy``   multi-tenant fabric: per-tenant queues, SLO / brownout,
                weighted-fair drain, token buckets, zero-downtime swap
- ``qcache``    exact-match bounded-LRU result cache

Submodules import lazily, so telemetry-only consumers (the filter
policy's gauge, the mutable index's counters) pull in none of the
scheduler.
"""
from __future__ import annotations

import importlib
from typing import Any

_SUBMODULES = ("admission", "batcher", "debugz", "degrade", "metrics",
               "qcache", "quality", "slo", "tenancy", "warmup")
_EXPORTS = {
    "MicroBatcher": "batcher",
    "BucketLadder": "batcher",
    "AdmissionQueue": "admission",
    "Request": "admission",
    "SearchResult": "admission",
    "QueueFullError": "admission",
    "count_compilations": "warmup",
    "SnapshotWriter": "debugz",
    "RecallSentinel": "quality",
    "SLOEngine": "slo",
    "Targets": "slo",
    "BrownoutController": "degrade",
    "ServeFabric": "tenancy",
    "Tenant": "tenancy",
    "RateLimitedError": "tenancy",
    "QueryCache": "qcache",
}

__all__ = list(_SUBMODULES) + list(_EXPORTS)


def __getattr__(name: str) -> Any:
    if name in _SUBMODULES:
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    if name in _EXPORTS:
        val = getattr(__getattr__(_EXPORTS[name]), name)
        globals()[name] = val
        return val
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
