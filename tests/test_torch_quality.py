"""The port's quality and telemetry layer against the JAX package's, on
the CPU: the recall sentinel, index health and device bytes, the debugz
snapshot, the flight recorder and tracing, and the telemetry the ported
modules record (the filter policy, the serialize reader, the host tier,
the mutable index, the fault probes).

Inputs are made with numpy from a seed. Tolerances: the sentinel's
estimates, windows and counters equal (the same reference, the same
offered samples); health and device-byte reports equal where the port
keeps the field; events compared by kind, site and field names (their
values where both packages compute them alike: rows, counts, generations,
recall). Workers run with ``autostart=False`` and are drained with a
timeout.
"""
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import bitset as jbitset
from raft_tpu.core import events as jev
from raft_tpu.core import faults as jfaults
from raft_tpu.core import logging as jlog
from raft_tpu.core import serialize as jser
from raft_tpu.core import tracing as jtr
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import host_stream as jhs
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import mutable as jmut
from raft_tpu.serve import batcher as jbat
from raft_tpu.serve import debugz as jdz
from raft_tpu.serve import degrade as jdeg
from raft_tpu.serve import metrics as jmetrics
from raft_tpu.serve import quality as jq
from raft_tpu.serve import slo as jslo
from raft_tpu_torch import convert
from raft_tpu_torch.core import bitset as tbitset
from raft_tpu_torch.core import events as tev
from raft_tpu_torch.core import faults as tfaults
from raft_tpu_torch.core import logging as tlog
from raft_tpu_torch.core import serialize as tser
from raft_tpu_torch.core import tracing as ttr
from raft_tpu_torch.core.errors import CorruptIndexError
from raft_tpu_torch.neighbors import brute_force, host_stream, ivf_flat
from raft_tpu_torch.neighbors import mutable as tmut
from raft_tpu_torch.ops import autotune
from raft_tpu_torch.serve import batcher as tbat
from raft_tpu_torch.serve import debugz as tdz
from raft_tpu_torch.serve import degrade as tdeg
from raft_tpu_torch.serve import metrics as tmetrics
from raft_tpu_torch.serve import quality as tq
from raft_tpu_torch.serve import slo as tslo

N, D, K = 600, 16, 5
TIMEOUT = 60


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No autotune verdict file: this module's verdicts stay in memory."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None


@pytest.fixture(autouse=True)
def _clean_rings():
    for m in (jev, tev):
        m.clear()
    for m in (jtr, ttr):
        m.clear_span_log()
    yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(31)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (64, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def flat(data):
    j = jivf.build(jnp.asarray(data[0]), jivf.IndexParams(n_lists=8,
                                                         seed=0))
    t = convert.ivf_flat_index_from_numpy(
        {"data": np.asarray(j.data), "data_norms": np.asarray(j.data_norms),
         "source_ids": np.asarray(j.source_ids),
         "centers": np.asarray(j.centers),
         "center_norms": np.asarray(j.center_norms),
         "list_offsets": j.list_offsets, "list_sizes_arr": j.list_sizes_arr,
         "metric": j.metric.value}, device="cpu")
    return j, t


def _naive(x):
    def ref(queries, k):
        q = np.asarray(queries, np.float32)
        d = ((q[:, None, :] - x[None]) ** 2).sum(-1)
        i = np.argsort(d, axis=1, kind="stable")[:, :k]
        return np.take_along_axis(d, i, 1), i.astype(np.int32)
    return ref


# ----------------------------------------------------------- sentinel

def _sentinel_run(q_mod, metrics, events, x, q, **kw):
    reg = metrics.Registry()
    s = q_mod.RecallSentinel(_naive(x), registry=reg, autostart=False,
                             **kw)
    ref = _naive(x)
    rng = np.random.default_rng(2)
    offered = []
    for r in range(24):
        rows = q[2 * r:2 * r + 2]
        d, i = ref(rows, K)
        if r >= 12:                 # degrade the second half's answers
            i = i.copy()
            i[:, :2] = rng.integers(0, N, (2, 2))
        offered.append(s.offer(rows, K, d, i, trace_id=f"t{r}",
                               engine="e" + str(r % 2)))
    s.start()
    assert s.drain(timeout=TIMEOUT)
    s.close()
    snap = s.snapshot()
    ev = [(e["kind"], e["site"], e["trace_id"], e["estimate"], e["floor"])
          for e in events.recent(kind="recall_regression")]
    return offered, snap, ev, reg.snapshot()


@pytest.mark.parametrize("kw", [
    dict(sample=1.0, floor=0.9, window=8, min_samples=4, max_pending=64),
    dict(sample=0.5, floor=0.95, window=32, min_samples=2, max_pending=64),
    dict(sample=1.0, floor=None, window=4, min_samples=1, max_pending=5),
    dict(sample=0.25, floor=0.99, window=16, min_samples=1,
         max_pending=64),
])
def test_sentinel_equal(data, kw):
    """Same reference, same offers: same sampled / dropped decisions,
    rolling estimates, regression events and recall gauges."""
    x, q = data
    j = _sentinel_run(jq, jmetrics, jev, x, q, **kw)
    t = _sentinel_run(tq, tmetrics, tev, x, q, **kw)
    assert j == t


def test_sentinel_disabled_is_one_check(data):
    for q_mod, metrics in ((jq, jmetrics), (tq, tmetrics)):
        s = q_mod.RecallSentinel(_naive(data[0]), sample=0.0,
                                 registry=metrics.Registry())
        assert not s.enabled and s._thread is None
        assert s.offer(data[1][:1], K, None, np.zeros((1, K))) is False


@pytest.mark.parametrize("raw", ["0", "0.5", "1", "0.25", "1.5", "-0.1",
                                 "nan", "x"])
def test_sample_rate_validation_equal(monkeypatch, raw):
    monkeypatch.setenv("RAFT_TPU_RECALL_SAMPLE", raw)
    out = []
    for tr in (jtr, ttr):
        try:
            out.append(tr.sample_rate(None, env="RAFT_TPU_RECALL_SAMPLE",
                                      name="recall sample"))
        except ValueError as e:
            out.append(str(e))
    assert out[0] == out[1]


def test_make_reference_equal(data):
    """The port's reference is its brute force on the caller's device; its
    ids equal JAX's reference's on integer rows."""
    x, q = data
    jd, ji = jq.make_reference(x)(q, K)
    td, ti = tq.make_reference(x, device="cpu")(torch.from_numpy(q), K)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-5)


def test_sentinel_behind_the_batcher(data):
    """A batcher offers each delivered request to its sentinel: both
    packages' sentinels score the same requests to the same estimate."""
    x, q = data
    ests = []
    for pkg in ("jax", "torch"):
        metrics = jmetrics if pkg == "jax" else tmetrics
        reg = metrics.Registry()
        if pkg == "jax":
            s = jq.RecallSentinel(_naive(x), sample=1.0, registry=reg,
                                  max_pending=64)
            b = jbat.MicroBatcher(jbf.make_searcher(jbf.build(
                jnp.asarray(x))), D, ladder=jbat.BucketLadder((8,), (16,)),
                registry=reg, sentinel=s, autostart=False)
        else:
            s = tq.RecallSentinel(_naive(x), sample=1.0, registry=reg,
                                  max_pending=64)
            b = tbat.MicroBatcher(brute_force.make_searcher(
                brute_force.build(x, device="cpu")), D,
                ladder=tbat.BucketLadder((8,), (16,)), registry=reg,
                sentinel=s, autostart=False, device="cpu")
        futs = [b.submit(q[i:i + 2], K) for i in range(0, 20, 2)]
        b.start()
        for f in futs:
            f.result(timeout=TIMEOUT)
        b.close()
        assert s.drain(timeout=TIMEOUT)
        s.close()
        ests.append((s.estimate(), reg.snapshot()["counters"][
            "serve.recall.scored"]))
    assert ests[0] == ests[1] == (1.0, 10.0)


# ------------------------------------------------------------- health

def test_health_and_device_bytes_equal(data, flat):
    """``quality.health`` and ``device_bytes`` on equal indexes give equal
    reports (JAX's brute-force ``fused_cache`` flag aside: the port keeps
    no padded copy)."""
    x, _ = data
    jb, tb = jbf.build(jnp.asarray(x)), brute_force.build(x, device="cpu")
    jh = jq.health(jb)
    jh.pop("fused_cache")
    assert jh == tq.health(tb)
    assert jq.device_bytes(jb) == tq.device_bytes(tb)
    assert jq.health(flat[0]) == tq.health(flat[1])
    assert jq.device_bytes(flat[0]) == tq.device_bytes(flat[1])


def test_watched_snapshots_equal(data, flat):
    x, _ = data
    jb, tb = jbf.build(jnp.asarray(x)), brute_force.build(x, device="cpu")
    out = []
    for q_mod, idx in ((jq, (jb, flat[0])), (tq, (tb, flat[1]))):
        q_mod.watch_index("bf", idx[0])
        q_mod.watch_index("flat", idx[1])
        try:
            hs = q_mod.health_snapshot()
            hs["bf"].pop("fused_cache", None)
            out.append((hs, q_mod.memz_snapshot(),
                        sorted(q_mod.ops_snapshot())))
        finally:
            q_mod.unwatch_index("bf")
            q_mod.unwatch_index("flat")
        assert q_mod.health_snapshot() == {}
    assert out[0] == out[1]


def test_export_health_jsonl_equal(tmp_path, flat):
    lines = []
    for name, q_mod, idx in (("j", jq, flat[0]), ("t", tq, flat[1])):
        q_mod.watch_index("flat", idx)
        try:
            n = q_mod.export_health_jsonl(str(tmp_path / f"{name}.jsonl"))
        finally:
            q_mod.unwatch_index("flat")
        rows = [json.loads(s) for s in open(tmp_path / f"{name}.jsonl")]
        for r in rows:
            r.pop("ts")
        lines.append((n, rows))
    assert lines[0] == lines[1]


def test_health_refuses_unknown_types():
    for q_mod in (jq, tq):
        with pytest.raises(TypeError):
            q_mod.health(object())
        with pytest.raises(TypeError):
            q_mod.device_bytes(object())


# ------------------------------------------------------------- debugz

# sections the port leaves out by design: no guards, no circuit breakers
LEFT_OUT = {"demotions", "breakers"}


def _dz_setup(pkg, x):
    metrics, bat, q_mod, slo, deg = (
        (jmetrics, jbat, jq, jslo, jdeg) if pkg == "jax" else
        (tmetrics, tbat, tq, tslo, tdeg))
    reg = metrics.Registry()
    kw = {} if pkg == "jax" else {"device": "cpu"}
    fn = lambda q, k, res=None: (  # noqa: E731
        (np.zeros((q.shape[0], k), np.float32),
         np.zeros((q.shape[0], k), np.int32)) if pkg == "jax" else
        (torch.zeros((q.shape[0], k)),
         torch.zeros((q.shape[0], k), dtype=torch.int32)))
    eng = slo.SLOEngine(slo.Targets(p99_latency_s=1.0), registry=reg)
    ctl = deg.BrownoutController(registry=reg)
    sent = q_mod.RecallSentinel(_naive(x), sample=1.0, registry=reg,
                                autostart=False)
    b = bat.MicroBatcher(fn, D, ladder=bat.BucketLadder((8,), (16,)),
                         registry=reg, degrade=ctl, sentinel=sent,
                         autostart=False, trace_sample=1.0, **kw)
    futs = [b.submit(np.ones((2, D), np.float32), 3) for _ in range(3)]
    b.start()
    for f in futs:
        f.result(timeout=TIMEOUT)
    b.close()
    return b, eng, sent


def test_debugz_sections_equal(data):
    """The snapshot's sections are JAX's, less the guarded ones; the
    sharded and fleet sections say "not ported yet"; the ladder, metrics
    and span sections agree."""
    out = []
    for pkg, dz in (("jax", jdz), ("torch", tdz)):
        b, eng, sent = _dz_setup(pkg, data[0])
        s = dz.snapshot(batcher=b, slo=eng)
        json.dumps(s, allow_nan=False)
        out.append(s)
        sent.close()
    j, t = out
    assert set(t) | LEFT_OUT >= set(j) - {"sharded"}
    assert {"ladder", "metrics", "events", "spans", "slo", "brownout",
            "quality"} <= set(t)
    assert t["sharded"] == t["fleet"] == {"not_ported": "not ported yet"}
    assert j["ladder"] == t["ladder"]
    assert j["brownout"]["ladder"] == t["brownout"]["ladder"]
    assert j["slo"]["verdict"] == t["slo"]["verdict"]
    assert sorted(j["metrics"]["counters"]) == sorted(
        t["metrics"]["counters"])
    assert [sorted(sp["stages"]) for sp in j["spans"]] == [
        sorted(sp["stages"]) for sp in t["spans"]]


def test_debugz_render_text_headers_equal(data):
    """The text page has JAX's sections in JAX's order (the autotune
    table, which holds this process's verdicts, aside)."""
    heads = []
    for pkg, dz in (("jax", jdz), ("torch", tdz)):
        b, eng, sent = _dz_setup(pkg, data[0])
        text = dz.render_text(batcher=b, slo=eng)
        sent.close()
        heads.append([ln.split("(")[0].strip() for ln in text.splitlines()
                      if ln.startswith("-- ") and not any(
                          w in ln for w in ("sharded", "fleet",
                                            "autotune"))])
    assert heads[0] == heads[1]


def test_snapshot_writer_hooks_equal(tmp_path):
    """A hook that fails then recovers records one ``hook_error`` event a
    transition and counts each failure, in both packages; the written
    snapshot reads back as strict JSON."""
    out = []
    for name, dz, metrics, events in (("j", jdz, jmetrics, jev),
                                      ("t", tdz, tmetrics, tev)):
        reg = metrics.Registry()
        fails = iter([True, True, False, True])

        def hook():
            if next(fails):
                raise RuntimeError("probe failed")

        w = dz.SnapshotWriter(str(tmp_path / f"{name}.json"),
                              interval_s=3600, registry=reg, hooks=[hook])
        for _ in range(4):
            w.tick()
        snap = w.write_once()
        with open(tmp_path / f"{name}.json") as f:
            back = json.load(f)
        assert back["metrics"] == json.loads(json.dumps(snap["metrics"]))
        out.append(([(e["kind"], e["action"]) for e in
                     events.recent(kind="hook_error")],
                    reg.snapshot()["counters"]))
    assert out[0] == out[1]
    assert [a for _, a in out[1][0]] == ["failed", "recovered", "failed"]


# ----------------------------------------------- events and tracing

PAYLOADS = {
    "floats": dict(a=1.5, b=float("inf"), c=float("nan"), d=-0.0),
    "numpy": dict(small=np.arange(4, dtype=np.int32),
                  big=np.zeros((10, 128), np.float32),
                  scalar=np.float32(2.5), flag=np.bool_(True)),
    "nested": dict(m={"x": [1, (2, 3)], 4: {"deep": {"er": [1.0]}}},
                   s={"only"}),
    "errors": dict(error=ValueError("bad"), obj=object),
}


@pytest.mark.parametrize("payload", sorted(PAYLOADS))
def test_events_jsonl_equal(payload):
    """The same records give the same JSON lines (timestamps and the
    process-random trace prefix aside)."""
    lines = []
    for ev, tr in ((jev, jtr), (tev, ttr)):
        ev.clear()
        ev.record("dispatch_error", "serve.batch", **PAYLOADS[payload])
        with tr.bind_trace("aaaa", "bbbb"):
            ev.record("fault_injected", "site.x", fault_kind="io_error")
        with tr.bind_trace("cccc"):
            ev.record("upsert", "idx", rows=3)
        rows = [json.loads(s) for s in ev.to_jsonl().splitlines()]
        for r in rows:
            r.pop("ts")
            r.pop("seq")
        lines.append(rows)
    assert lines[0] == lines[1]


def test_torch_tensors_scrub_like_numpy():
    """A 0-d tensor scrubs to its number (as a numpy scalar does); a larger
    one to its shape."""
    e = tev.record("x", "s", n=torch.tensor(3), f=torch.tensor(0.5),
                   big=torch.zeros(3, 4))
    j = jev.record("x", "s", n=np.int64(3), f=np.float32(0.5))
    assert (e["n"], e["f"]) == (j["n"], j["f"])
    assert e["big"] == "tensor(shape=(3, 4), dtype=torch.float32)"


def test_ring_api_equal(tmp_path):
    """counts, drain_new cursors, set_capacity, export_jsonl and the sink
    behave alike."""
    out = []
    for name, ev in (("j", jev), ("t", tev)):
        ev.clear()
        ev.set_capacity(4)
        try:
            ev.attach_sink(str(tmp_path / f"{name}.sink"))
            for i in range(6):
                ev.record("upsert" if i % 2 else "delete", "idx", i=i)
            ev.detach_sink()
            items, cur = ev.drain_new(0)
            more, cur2 = ev.drain_new(cur)
            n = ev.export_jsonl(str(tmp_path / f"{name}.jsonl"), n=3)
            sink = [json.loads(s)["i"] for s in open(tmp_path /
                                                     f"{name}.sink")]
            out.append(([e["i"] for e in items], len(more), cur2 - cur, n,
                        ev.counts(), sink, len(ev.recent(0)),
                        [e["i"] for e in ev.recent(2, kind="upsert")]))
        finally:
            ev.set_capacity(ev.DEFAULT_CAPACITY)
    assert out[0] == out[1]


def test_tracing_ids_and_span_log_equal():
    out = []
    for tr in (jtr, ttr):
        tr.clear_span_log()
        a, b = tr.new_trace_id(), tr.new_trace_id()
        with tr.bind_trace(a, b):
            inner = tr.current_traces()
            with tr.bind_trace(a):
                one = tr.current_trace()
        tr.log_spans(a, {"queue_wait": 0.5, "device": 0.25}, rows=3, k=10)
        tr.set_span_log_capacity(1)
        tr.log_spans(b, {"demux": 0.1})
        spans = tr.recent_spans()
        tr.set_span_log_capacity(256)
        out.append((len(a), inner == (a, b), one == a,
                    tr.current_traces(), [(s["stages"], s.get("rows"))
                                          for s in spans]))
    assert out[0] == out[1]


def test_logging_callback_equal():
    got = []
    for lg in (jlog, tlog):
        seen = []
        old = lg.get_level()
        lg.set_level(lg.TRACE)
        lg.set_pattern("%(levelname)s|%(message)s")
        lg.set_callback(lambda lvl, msg: seen.append((lvl, msg)))
        try:
            lg.log_trace("t %d", 1)
            lg.log_warn("w")
        finally:
            lg.set_callback(None)
            lg.set_pattern("[%(levelname)s] [%(asctime)s] %(name)s: "
                           "%(message)s")
            lg.set_level(old)
        got.append(seen)
    assert got[0] == got[1] == [(5, "TRACE|t 1"), (30, "WARNING|w")]


# ------------------------------------ telemetry of the ported modules

def test_filter_policy_telemetry_equal(monkeypatch, data, flat):
    """A filtered IVF-Flat search that crosses over sets the selectivity
    gauge and records one ``filter_crossover`` event with the same
    fields in both packages."""
    monkeypatch.setenv("RAFT_TPU_FILTER_BRUTE_MAX", "100")
    mask = np.random.default_rng(8).random(N) < 0.1
    _, q = data
    out = []
    jivf.search(flat[0], jnp.asarray(q[:4]), K, jivf.SearchParams(
        n_probes=2), filter=jbitset.Bitset.from_mask(jnp.asarray(mask)))
    ivf_flat.search(flat[1], torch.from_numpy(q[:4]), K,
                    ivf_flat.SearchParams(n_probes=2),
                    filter=tbitset.Bitset.from_mask(torch.from_numpy(mask)))
    for ev, metrics in ((jev, jmetrics), (tev, tmetrics)):
        e = ev.recent(kind="filter_crossover")
        out.append(([{k: v for k, v in x.items() if k not in ("ts", "seq")}
                     for x in e],
                    metrics.gauge("serve.filter.selectivity").value))
    assert out[0] == out[1]
    assert len(out[1][0]) == 1 and out[1][0][0]["survivors"] == mask.sum()


def test_corrupt_index_telemetry_equal(tmp_path):
    """A corrupt file loads as ``CorruptIndexError`` in both packages, each
    recording ``corrupt_index`` at the failing section and counting
    ``serialize.corrupt_load``."""
    p = str(tmp_path / "f.bin")
    tser.save_arrays(p, "unit", 1, {"a": 1},
                     {"x": np.arange(64, dtype=np.float32)})
    raw = bytearray(open(p, "rb").read())
    raw[-10] ^= 0x01
    open(p, "wb").write(bytes(raw))
    out = []
    for ser, ev, metrics in ((jser, jev, jmetrics), (tser, tev, tmetrics)):
        before = metrics.counter("serialize.corrupt_load").value
        with pytest.raises(Exception) as ei:
            ser.load_arrays(p)
        e = ev.recent(kind="corrupt_index")[-1]
        out.append((type(ei.value).__name__, e["site"], sorted(e),
                    metrics.counter("serialize.corrupt_load").value
                    - before))
    assert out[0] == out[1]
    assert out[1][0] == CorruptIndexError.__name__


def test_host_tier_armed_equal():
    """Each distinct budget records one ``host_tier_armed`` event with the
    same fields; a repeat records none."""
    out = []
    for hs, ev in ((jhs, jev), (host_stream, tev)):
        ev.clear()
        assert hs.budget_bytes(0.125) == 1 << 27
        hs.budget_bytes(0.125)
        hs.budget_bytes(0)
        out.append([{k: v for k, v in x.items() if k not in ("ts", "seq")}
                    for x in ev.recent(kind="host_tier_armed")])
    assert out[0] == out[1] and len(out[1]) <= 1


def _mutable_script(mod, root, x, **kw):
    m = mod.create(os.path.join(root, "idx"), x[:200], **kw)
    m.upsert(np.arange(1000, 1010), x[200:210])
    m.delete(np.array([3, 4, 5, 99999]))
    m.search(x[:3], K)
    assert m.merge() == "committed"
    m.upsert(np.arange(2000, 2002), x[210:212])
    r = mod.recover(os.path.join(root, "idx"), **kw)
    return r


def test_mutable_telemetry_equal(tmp_path, data):
    """The same mutations record the same event kinds, sites and fields,
    the same ``mutable.*`` counter moves and the same annotate spans."""
    x, _ = data
    out = []
    for name, mod, ev, metrics in (("j", jmut, jev, jmetrics),
                                   ("t", tmut, tev, tmetrics)):
        ev.clear()
        reg = metrics.Registry()
        metrics.enable_span_metrics(reg)
        before = metrics.snapshot()["counters"]
        try:
            kw = {} if mod is jmut else {"device": "cpu"}
            _mutable_script(mod, str(tmp_path / name), x, **kw)
        finally:
            metrics.disable_span_metrics()
        after = metrics.snapshot()["counters"]
        moved = {k: v - before.get(k, 0) for k, v in after.items()
                 if k.startswith("mutable.") and v != before.get(k, 0)}
        evs = [(e["kind"], e["site"], sorted(set(e) - {"ts", "seq",
                                                       "dur_s"}),
                {k: e[k] for k in ("rows", "found", "generation", "records",
                                   "truncated_bytes", "segment_rebuilt",
                                   "delta_rows", "tombstones") if k in e})
               for e in ev.recent()
               if e["kind"] in ("upsert", "delete", "merge_started",
                                "merge_committed", "merge_abandoned",
                                "wal_recovered")]
        spans = sorted(k for k in reg.snapshot()["histograms"]
                       if k.startswith("span.raft_tpu::mutable::"))
        out.append((evs, moved, spans))
    assert out[0] == out[1]
    assert [e[0] for e in out[1][0]] == [
        "upsert", "delete", "merge_started", "merge_committed", "upsert",
        "wal_recovered"]


def test_fault_fire_telemetry_equal():
    """A fault's every fire counts under ``faults.fired.<kind>.<site>``;
    only its first records ``fault_injected``."""
    out = []
    for faults, ev, metrics in ((jfaults, jev, jmetrics),
                                (tfaults, tev, tmetrics)):
        ev.clear()
        site = "unit.telemetry.site"
        before = metrics.counter(f"faults.fired.io_error.{site}").value
        with faults.inject("io_error", site, count=3):
            for _ in range(5):
                try:
                    faults.check("io_error", site)
                except faults.InjectedFault:
                    pass
        out.append(([{k: v for k, v in e.items() if k not in ("ts", "seq")}
                     for e in ev.recent(kind="fault_injected")],
                    metrics.counter(f"faults.fired.io_error.{site}").value
                    - before))
    assert out[0] == out[1]
    assert out[1][1] == 3 and len(out[1][0]) == 1
