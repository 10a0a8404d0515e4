"""The exportable ops surface: counterpart of ``raft_tpu/serve/debugz.py``
(``snapshot``, ``render_text``, ``write_snapshot``, ``SnapshotWriter``).

:func:`snapshot` assembles a strict-JSON dict of what the telemetry layer
knows — the metrics registry, the bucket ladder's occupancy, the
autotune verdicts, the flight-recorder tail, the sampled span log, armed
faults, the brownout controller, the mutable indexes, the recall
sentinels, the watched indexes' health and device bytes, the tenants and
the SLO verdicts — and :func:`render_text` renders the same as a page.
:class:`SnapshotWriter` writes snapshots on an interval (and runs its
maintenance hooks each tick). Its sections follow the JAX package's for
what the port has: the guarded-demotion and circuit-breaker sections are
left out (the port has no guards: no fallback may hide a kernel), and
the ``sharded`` and ``fleet`` sections say "not ported yet".
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Optional

from ..core import events, faults, tracing

__all__ = ["snapshot", "render_text", "write_snapshot", "SnapshotWriter"]

_NOT_PORTED = "not ported yet"


def _ladder_view(batcher, reg_snap: dict) -> dict:
    """Bucket-ladder occupancy: dispatch counts per (rows × k) shape plus
    live queue state (``reg_snap``: the snapshot already computed for the
    metrics key — one instant, not two, and no double percentile sort)."""
    prefix = f"{batcher._name}.dispatch."
    dispatch = {name[len(prefix):]: int(v)
                for name, v in reg_snap["counters"].items()
                if name.startswith(prefix)}
    return {
        "query_buckets": list(batcher.ladder.query_buckets),
        "k_buckets": list(batcher.ladder.k_buckets),
        "dispatches": {f"{mb}x{kb}": dispatch.get(f"{mb}x{kb}", 0)
                       for mb, kb in batcher.ladder.shapes()},
        "queue_depth": len(batcher.queue),
        "queue_max_depth": batcher.queue.max_depth,
        "queue_closed": batcher.queue.closed,
    }


def _json_safe(obj):
    """Strict-JSON scrub: non-finite floats (an empty histogram's
    min/max/percentiles are NaN) become None — a post-mortem snapshot
    must parse under every strict JSON reader (jq, JSON.parse), not only
    Python's lenient loads."""
    if isinstance(obj, float):
        return obj if math.isfinite(obj) else None
    if isinstance(obj, dict):
        return {k: _json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_json_safe(v) for v in obj]
    return obj


def snapshot(batcher=None, registry=None, events_n: int = 50,
             spans_n: int = 20, slo=None, fabric=None) -> dict:
    """Point-in-time ops snapshot (strict-JSON-safe: no NaN/Inf leaves).

    ``batcher``: include its bucket-ladder occupancy and queue state.
    ``registry``: metrics source. When None: the batcher's own registry,
    else the default process registry (home of ``serve.recompiles``).
    ``events_n`` / ``spans_n``: flight-recorder / span-log tail sizes
    (0 = omit the tail).
    ``slo``: a :class:`~raft_tpu_torch.serve.slo.SLOEngine` to evaluate into
    the ``slo`` section; None uses the process-installed engine
    (``slo.install``). The quality sections ride automatically: every
    live :class:`~raft_tpu_torch.serve.quality.RecallSentinel` reports under
    ``quality`` and every ``quality.watch_index``-registered index
    under ``health``.
    ``fabric``: a :class:`~raft_tpu_torch.serve.tenancy.ServeFabric` for the
    ``tenants`` section (per-tenant queue depth, weight, shed/served,
    brownout level, SLO verdict, cache hit rate, swap generation);
    None uses the process-installed fabric (``tenancy.install``).
    """
    from ..ops import autotune
    from . import metrics as _metrics

    if registry is None and batcher is not None:
        registry = batcher._reg
    reg = registry or _metrics.default_registry
    # SLO verdicts FIRST: an evaluation crossing into breach records an
    # slo_breach event, and this snapshot's flight-recorder tail (read
    # below) must already contain it
    slo_report = None
    try:
        from . import slo as _slo

        eng = slo if slo is not None else _slo.installed()
        if eng is not None:
            slo_report = eng.evaluate()
    except Exception:  # noqa: BLE001 - a broken engine must not take
        pass           # down the snapshot
    reg_snap = reg.snapshot()
    out = {
        "ts": time.time(),
        "metrics": reg_snap,
        "autotune": autotune.entries(),
        "events": events.recent(events_n),
        "event_counts": events.counts(),
        "spans": tracing.recent_spans(spans_n),
        "faults_armed": [
            {"kind": f.kind, "pattern": f.pattern, "count": f.count,
             "value": f.value, "fires": f.fires} for f in faults.active()],
    }
    # brownout controller (serve/degrade.py): current ladder level +
    # recent transitions
    try:
        from . import degrade as _degrade

        ctl = _degrade.installed()
        if ctl is None and batcher is not None:
            ctl = getattr(batcher, "_degrade", None)
        if ctl is not None:
            out["brownout"] = ctl.snapshot()
    except Exception:  # noqa: BLE001 - surface must render without degrade
        pass
    # sharded serving health and the multi-host fleet
    out["sharded"] = {"not_ported": _NOT_PORTED}
    out["fleet"] = {"not_ported": _NOT_PORTED}
    # mutable-tier state: per-index delta rows,
    # tombstone count, WAL bytes and the last merge verdict
    try:
        from ..neighbors import mutable as _mutable

        mu = _mutable.ops_snapshot()
        if mu["indexes"]:
            out["mutable"] = mu["indexes"]
    except Exception:  # noqa: BLE001 - surface must render without mutable
        pass
    # quality half of the ops surface: sentinel rolling-recall estimates
    # + watched-index health reports
    try:
        from . import quality as _quality

        q = _quality.ops_snapshot()
        if q["sentinels"]:
            out["quality"] = q["sentinels"]
        if q["health"]:
            out["health"] = q["health"]
        # memz: per-watched-index device bytes by component +
        # bytes_per_vector
        mz = _quality.memz_snapshot()
        if mz:
            out["memz"] = mz
    except Exception:  # noqa: BLE001 - surface must render without quality
        pass
    # multi-tenant fabric (serve/tenancy.py): per-tenant queue/SLO/
    # brownout/cache state + the shared qcache counters
    try:
        from . import tenancy as _tenancy

        fab = fabric if fabric is not None else _tenancy.installed()
        if fab is not None:
            out["tenants"] = fab.snapshot()
    except Exception:  # noqa: BLE001 - surface must render without
        pass           # the fabric
    if slo_report is not None:
        out["slo"] = slo_report
    if batcher is not None:
        out["ladder"] = _ladder_view(batcher, reg_snap)
    # scrub the WHOLE snapshot, not just the metrics sub-dict: an armed
    # fault's value or an event detail can carry inf/NaN too
    return _json_safe(out)


def _fmt_hist(name: str, h: dict) -> str:
    # unit by naming convention: only *_s histograms are seconds —
    # ratio histograms (batch_fill, padding_waste) render unitless
    u = "s" if name.endswith("_s") else ""
    return (f"  {name}: n={h['count']} p50={h['p50']:.4g}{u} "
            f"p90={h['p90']:.4g}{u} p99={h['p99']:.4g}{u} max={h['max']:.4g}{u}")


def render_text(batcher=None, registry=None, events_n: int = 20,
                spans_n: int = 5, slo=None, fabric=None) -> str:
    """Human-readable rendering of :func:`snapshot` (the text half of the
    text/JSON ops surface; the Prometheus export stays
    ``metrics.render_text``)."""
    s = snapshot(batcher, registry, events_n=events_n, spans_n=spans_n,
                 slo=slo, fabric=fabric)
    lines = [f"== raft_tpu_torch debugz @ "
             f"{time.strftime('%Y-%m-%dT%H:%M:%S')} =="]
    if "ladder" in s:
        lad = s["ladder"]
        lines += ["", "-- bucket ladder --",
                  f"  queue: {lad['queue_depth']}/{lad['queue_max_depth']}"
                  f"{' (closed)' if lad['queue_closed'] else ''}"]
        lines += [f"  {shape}: {n} dispatches"
                  for shape, n in lad["dispatches"].items()]
    m = s["metrics"]
    lines += ["", "-- counters --"]
    lines += [f"  {k}: {v:g}" for k, v in m["counters"].items()]
    lines += ["", "-- gauges --"]
    lines += [f"  {k}: {v:g}" for k, v in m["gauges"].items()]
    hists = m["histograms"]
    if hists:
        lines += ["", "-- histograms --"]
        lines += [_fmt_hist(k, h) for k, h in hists.items() if h["count"]]
    if s.get("tenants"):
        fb = s["tenants"]
        qc = fb.get("qcache") or {}
        lines += ["", f"-- tenants (fabric {fb.get('name', '?')}"
                  f"{' CLOSED' if fb.get('closed') else ''}) --"]
        if qc:
            hr = qc.get("hit_rate")
            lines.append(
                f"  qcache: {qc.get('entries', 0)}/{qc.get('capacity', 0)}"
                f" entries hit_rate="
                f"{'-' if hr is None else f'{hr:.2%}'}"
                f" hits={qc.get('hits', 0)} misses={qc.get('misses', 0)}"
                f" bypass={qc.get('bypass', 0)}"
                f" invalidated={qc.get('invalidated', 0)}")
        for tn, te in sorted((fb.get("tenants") or {}).items()):
            if "error" in te:
                lines.append(f"  {tn}: error {te['error']}")
                continue
            thr = (te.get("qcache") or {}).get("hit_rate")
            slo_v = (te.get("slo") or {}).get("verdict", "-")
            lines.append(
                f"  {tn}: w={te.get('weight', 1):g} gen="
                f"{te.get('generation', 0)} queue="
                f"{te.get('queue_depth', 0)}/{te.get('queue_max_depth', 0)}"
                f" served={te.get('served', 0)} shed={te.get('shed', 0)}"
                f" slo={slo_v}"
                + (f" brownout={te['brownout_level']}"
                   if "brownout_level" in te else "")
                + (f" tokens={te['tokens']:g}" if "tokens" in te else "")
                + (f" cache_hit="
                   f"{'-' if thr is None else f'{thr:.2%}'}"))
    if s.get("brownout"):
        bw = s["brownout"]
        lines += ["", f"-- brownout (level {bw['level']}/{bw['max_level']})"
                  " --"]
        for tr in bw.get("transitions", [])[-5:]:
            lines.append(f"  {tr['from']} -> {tr['to']} ({tr['reason']})")
    for sec in ("sharded", "fleet"):
        lines += ["", f"-- {sec}: {s[sec]['not_ported']} --"]
    if s.get("mutable"):
        lines += ["", "-- mutable indexes --"]
        for name, ent in sorted(s["mutable"].items()):
            if "error" in ent:
                lines.append(f"  {name}: error {ent['error']}")
                continue
            lm = ent.get("last_merge") or {}
            lines.append(
                f"  {name}: {ent['family']} gen={ent['generation']} "
                f"sealed={ent['sealed_rows']} delta={ent['delta_rows']} "
                f"tombstones={ent['tombstones']} "
                f"wal={ent['wal_bytes']}B"
                + (" MERGING" if ent.get("merging") else "")
                + (f" last_merge={lm.get('verdict')}"
                   f"({lm.get('reason', '')})" if lm else ""))
    if s.get("slo"):
        sv = s["slo"]
        lines += ["", f"-- slo ({sv['verdict']}) --"]
        for key, rep in sorted(sv["targets"].items()):
            vals = ", ".join(
                f"{f}={rep[f]:.4g}" for f in ("value", "fast", "slow")
                if isinstance(rep.get(f), (int, float)))
            lines.append(f"  {key}: {rep['verdict']} "
                         f"(target {rep['target']:g}"
                         + (f", {vals}" if vals else "") + ")")
    for q in s.get("quality") or []:
        lines += ["", f"-- recall sentinel ({q['name']}) --",
                  f"  sampled={q['sampled']} scored={q['scored']} "
                  f"dropped={q['dropped']} pending={q['pending']}"
                  + (f" floor={q['floor']:g}" if q.get("floor") is not None
                     else "")]
        for fam, ent in sorted(q["families"].items()):
            est = ent["estimate"]
            lines.append(
                f"  {fam}: recall={est if est is not None else '-'} "
                f"(n={ent['samples']})"
                + (" BELOW FLOOR" if ent.get("below_floor") else ""))
    if s.get("memz"):
        lines += ["", "-- memz (device bytes) --"]
        for name, rep in sorted(s["memz"].items()):
            if "error" in rep:
                lines.append(f"  {name}: error {rep['error']}")
                continue
            parts = " ".join(f"{c}={v}" for c, v in
                             sorted((rep.get("components") or {}).items()))
            bpv = rep.get("bytes_per_vector")
            lines.append(
                f"  {name}: {rep.get('family', '?')} "
                f"total={rep.get('total_device_bytes', 0)}B "
                f"b/vec={bpv if bpv is not None else '-'} {parts}")
            hsn = rep.get("host_stream")
            if hsn:
                lines.append(
                    f"    host tier: {hsn['cold_lists']} cold lists "
                    f"{hsn['host_bytes']}B host, saved "
                    f"{hsn['device_bytes_saved']}B device, streamed "
                    f"{hsn['streamed_chunks']} chunks")
    if s.get("health"):
        lines += ["", "-- index health --"]
        for name, rep in sorted(s["health"].items()):
            if "error" in rep:
                lines.append(f"  {name}: error {rep['error']}")
                continue
            bits = [rep.get("family", "?"), f"n={rep.get('n', rep.get('n_total', '?'))}"]
            if "unreachable_nodes" in rep:
                bits.append(f"unreachable={rep['unreachable_nodes']}")
            if "lists" in rep:
                bits.append(f"list_cv={rep['lists'].get('cv', '-')}")
            if "healthy_shards" in rep:
                bits.append(f"shards={rep['healthy_shards']}/{rep['n_shards']}")
            if "quant" in rep:
                bits.append(f"quant={','.join(sorted(rep['quant']))}")
            lines.append(f"  {name}: " + " ".join(str(b) for b in bits))
    if s["autotune"]:
        lines += ["", "-- autotune verdicts --"]
        lines += [f"  {k} -> {v}" for k, v in sorted(s["autotune"].items())]
    if s["faults_armed"]:
        lines += ["", "-- armed faults --"]
        lines += [f"  {f['kind']}@{f['pattern']} fires={f['fires']}"
                  for f in s["faults_armed"]]
    if s["events"]:
        lines += ["", f"-- flight recorder (last {len(s['events'])}) --"]
        for e in s["events"]:
            extra = {k: v for k, v in e.items()
                     if k not in ("seq", "ts", "kind", "site", "trace_id")}
            lines.append(
                f"  #{e['seq']} {e['kind']} @ {e['site']}"
                + (f" trace={e['trace_id']}" if e.get("trace_id") else "")
                + (f" {extra}" if extra else ""))
    if s["spans"]:
        lines += ["", f"-- sampled request spans (last {len(s['spans'])}) --"]
        for sp in s["spans"]:
            stages = " ".join(f"{k}={v * 1e3:.2f}ms"
                              for k, v in sp["stages"].items())
            lines.append(f"  {sp['trace_id']}: {stages}")
    return "\n".join(lines) + "\n"


def write_snapshot(path: str, batcher=None, registry=None, slo=None,
                   fabric=None) -> dict:
    """Write one JSON snapshot atomically (tmp + rename); returns it."""
    s = snapshot(batcher, registry, slo=slo, fabric=fabric)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(s, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return s


class SnapshotWriter:
    """Background ops-snapshot persistence: a daemon thread writing
    :func:`write_snapshot` to ``path`` every ``interval_s`` (and once on
    ``stop``, so the final state always lands). Context-manager form
    scopes it to a serving run.

    ``hooks``: callables invoked (guarded) each tick before the write —
    the serving loop's maintenance slot: ``BrownoutController.poll``
    consumes SLO verdicts, and a fabric hangs ``ServeFabric.tick``
    (per-tenant SLO poll + swap retire) — so the snapshot that lands each
    tick already reflects that tick's ladder moves and retires."""

    def __init__(self, path: str, interval_s: float = 10.0, batcher=None,
                 registry=None, slo=None, hooks=(), fabric=None):
        self.path = path
        self.interval_s = float(interval_s)
        self._batcher = batcher
        self._registry = registry
        self._slo = slo
        self._fabric = fabric
        self._hooks = tuple(hooks)
        if fabric is not None:
            # the fabric's maintenance tick rides the hook slot
            self._hooks = self._hooks + (fabric.tick,)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # per-hook failure latches (index-aligned with _hooks): a soak
        # must surface a dead maintenance hook, so failures are counted
        # per hook and flight-recorded once per TRANSITION (first
        # failure / recovery), never once per tick
        self._hook_failing = [False] * len(self._hooks)

    @staticmethod
    def _hook_name(h) -> str:
        name = getattr(h, "__qualname__", None) \
            or getattr(h, "__name__", None) or repr(h)
        return name.replace("<", "").replace(">", "")

    def tick(self) -> None:
        """Run the maintenance hooks once (each guarded — one failing
        hook must not starve the rest or the write). Failures are
        counted under ``debugz.hook_errors.<name>`` and recorded as one
        ``hook_error`` event per transition."""
        from . import metrics as _metrics

        reg = self._registry or _metrics.default_registry
        for i, h in enumerate(self._hooks):
            try:
                h()
            except Exception as exc:  # noqa: BLE001 - a broken hook
                # must not kill the maintenance loop
                name = self._hook_name(h)
                try:
                    reg.counter(f"debugz.hook_errors.{name}").inc()
                    if not self._hook_failing[i]:
                        self._hook_failing[i] = True
                        events.record("hook_error", f"debugz.{name}",
                                      action="failed", error=exc)
                except Exception:  # noqa: BLE001 - telemetry best-effort
                    pass
            else:
                if self._hook_failing[i]:
                    self._hook_failing[i] = False
                    try:
                        events.record("hook_error",
                                      f"debugz.{self._hook_name(h)}",
                                      action="recovered")
                    except Exception:  # noqa: BLE001
                        pass

    def write_once(self) -> dict:
        return write_snapshot(self.path, self._batcher, self._registry,
                              slo=self._slo, fabric=self._fabric)

    def start(self) -> "SnapshotWriter":
        if self._thread is None:
            self._stop.clear()
            self._thread = threading.Thread(
                target=self._run, name="debugz-snapshots", daemon=True)
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self.tick()
            try:
                self.write_once()
            except Exception:  # noqa: BLE001 - a failed write must not
                pass           # kill the writer (disk full, path gone)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(self.interval_s + 5.0)
            self._thread = None
        try:
            self.write_once()
        except Exception:  # noqa: BLE001
            pass

    def __enter__(self) -> "SnapshotWriter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
