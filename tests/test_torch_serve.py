"""The port's serving core against the JAX package's, on the CPU: metrics,
admission, warmup, the batcher and the sharded ``make_searcher``.

The same scripted inputs, made from a seed with numpy, go through
``raft_tpu.serve`` and ``raft_tpu_torch.serve``. Tolerances: registry
snapshots equal and ``render_text`` byte-equal; ladders, blocks, offsets,
shed and backpressure decisions equal; served answers on integer-valued
rows (exact in both packages) equal in ids and to rtol 1e-5 in values.
Clocks are injected and workers are driven with ``autostart=False``;
every future is read with ``result(timeout=...)``.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

import jax
from raft_tpu.core import deadline as jdl
from raft_tpu.core import tracing as jtracing
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.parallel import sharded_ann as jsa
from raft_tpu.serve import admission as jadm
from raft_tpu.serve import batcher as jbat
from raft_tpu.serve import metrics as jmetrics
from raft_tpu.serve import warmup as jwarm
from raft_tpu_torch import convert
from raft_tpu_torch.comms import Mesh
from raft_tpu_torch.core import deadline as tdl
from raft_tpu_torch.core import tracing as ttracing
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import brute_force, ivf_flat
from raft_tpu_torch.ops import _cuda
from raft_tpu_torch.parallel import sharded_ann
from raft_tpu_torch.serve import admission as tadm
from raft_tpu_torch.serve import batcher as tbat
from raft_tpu_torch.serve import metrics as tmetrics
from raft_tpu_torch.serve import warmup as twarm

N, D, K = 2000, 32, 10
TIMEOUT = 60
LADDER = ((8, 32, 128), (16, 64))


class FakeClock:
    """A settable clock, shared by both packages' objects."""

    def __init__(self, t=100.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(24)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (300, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def flat(data):
    """JAX's IVF-Flat index and the port's copy of it."""
    j = jivf.build(jnp.asarray(data[0]), jivf.IndexParams(n_lists=16,
                                                         seed=0))
    t = convert.ivf_flat_index_from_numpy(
        {"data": np.asarray(j.data), "data_norms": np.asarray(j.data_norms),
         "source_ids": np.asarray(j.source_ids),
         "centers": np.asarray(j.centers),
         "center_norms": np.asarray(j.center_norms),
         "list_offsets": j.list_offsets, "list_sizes_arr": j.list_sizes_arr,
         "metric": j.metric.value}, device="cpu")
    return j, t


@pytest.fixture(scope="module")
def searchers(data, flat):
    """family -> (JAX closure, port closure) over the same rows."""
    x = data[0]
    return {
        "brute_force": (jbf.make_searcher(jbf.build(jnp.asarray(x))),
                        brute_force.make_searcher(
                            brute_force.build(x, device="cpu"))),
        "ivf_flat": (jivf.make_searcher(flat[0], jivf.SearchParams(
                         n_probes=6), algo="xla"),
                     ivf_flat.make_searcher(flat[1], ivf_flat.SearchParams(
                         n_probes=6))),
    }


# ------------------------------------------------------------ metrics

SCRIPTS = {
    "latency": [("h", "serve.latency_s", v) for v in
                (0.0001, 0.0004, 0.003, 0.02, 0.2, 3.0, 40.0)],
    "mixed": [("c", "serve.requests", 3), ("c", "serve.requests", 2),
              ("g", "serve.queue_depth", 7), ("g", "serve.queue_depth", 2),
              ("gm", "serve.queue_depth_peak", 5),
              ("gm", "serve.queue_depth_peak", 3),
              ("h", "serve.batch_latency_s", 0.004)],
    "ratios": [("hr", "serve.batch_fill", v) for v in
               (0.05, 0.125, 0.5, 0.51, 1.0, 0.99)],
    "empty_hist": [("h", "serve.stage.device_s", None)],
    "odd_names": [("c", "tenant-a.qcache.hits", 1),
                  ("g", "serve.dispatch.8x16", 2.5),
                  ("h", "span.raft_tpu::mutable::upsert", 0.01)],
}


def _play(mod, script):
    reg = mod.Registry()
    for kind, name, v in script:
        if kind == "c":
            reg.counter(name).inc(v)
        elif kind == "g":
            reg.gauge(name).set(v)
        elif kind == "gm":
            reg.gauge(name).set_max(v)
        elif kind == "hr":
            reg.histogram(name, mod.RATIO_BUCKETS).observe(v)
        elif v is None:
            reg.histogram(name)
        else:
            reg.histogram(name).observe(v)
    return reg


def _nan_eq(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_nan_eq(a[k], b[k]) for k in a)
    if isinstance(a, float) and math.isnan(a):
        return isinstance(b, float) and math.isnan(b)
    return a == b


@pytest.mark.parametrize("script", sorted(SCRIPTS))
def test_registry_snapshot_and_text_equal(script):
    """Snapshot equal (NaN where both are empty), text byte-equal."""
    j, t = _play(jmetrics, SCRIPTS[script]), _play(tmetrics, SCRIPTS[script])
    assert _nan_eq(j.snapshot(), t.snapshot())
    assert j.render_text() == t.render_text()


@pytest.mark.parametrize("buckets", ["LATENCY_BUCKETS_S", "RATIO_BUCKETS",
                                     "MTTR_BUCKETS_S"])
def test_histogram_percentiles_equal(buckets):
    assert getattr(jmetrics, buckets) == getattr(tmetrics, buckets)
    vals = np.random.default_rng(3).exponential(0.05, 500)
    hj = jmetrics.Histogram("h", getattr(jmetrics, buckets))
    ht = tmetrics.Histogram("h", getattr(tmetrics, buckets))
    for v in vals:
        hj.observe(float(v))
        ht.observe(float(v))
    for q in (0, 1, 10, 50, 90, 99, 99.9, 100):
        assert hj.percentile(q) == ht.percentile(q)


def test_registry_type_collision_raises_in_both():
    for mod in (jmetrics, tmetrics):
        reg = mod.Registry()
        reg.counter("x")
        with pytest.raises(TypeError):
            reg.gauge("x")


def test_span_metrics_names_equal():
    """``enable_span_metrics``: the same ranges and annotated calls give
    the same ``span.*`` histogram names and counts."""
    snaps = []
    for metrics, tracing in ((jmetrics, jtracing), (tmetrics, ttracing)):
        reg = metrics.Registry()
        metrics.enable_span_metrics(reg)
        try:
            fn = tracing.annotate("unit::span")(lambda: 1)
            fn()
            fn()
            with tracing.range("unit::block"):
                pass
            with tracing.child_span("unit::child"):
                pass
        finally:
            metrics.disable_span_metrics()
        snaps.append({k: v["count"] for k, v in
                      reg.snapshot()["histograms"].items()})
    assert snaps[0] == snaps[1] == {"span.unit::span": 2,
                                    "span.unit::block": 1,
                                    "span.unit::child": 1}


# ---------------------------------------------------------- admission

def _queue_script(adm, dl_mod, depth, deadlines, clock):
    """Submit one request a deadline (None = no budget) into a queue of
    ``depth``; → (accepted flags, the popped batch's indices, the shed
    indices, counters)."""
    reg = (jmetrics if adm is jadm else tmetrics).Registry()
    q = adm.AdmissionQueue(depth, registry=reg, clock=clock)
    reqs, accepted = [], []
    for i, s in enumerate(deadlines):
        dl = None if s is None else dl_mod.Deadline(s, clock=clock)
        r = adm.Request(np.zeros((1 + i % 3, 4), np.float32), 5, dl)
        try:
            q.submit(r)
            accepted.append(True)
        except adm.QueueFullError:
            accepted.append(False)
        reqs.append(r)
    clock.t += 1.0
    batch = q.pop_nowait(64, max_rows=9)
    popped = [reqs.index(r) for r in batch]
    shed = [i for i, r in enumerate(reqs) if r.done()]
    return accepted, popped, shed, reg.snapshot()["counters"]


@pytest.mark.parametrize("depth,deadlines", [
    (4, [None] * 6),
    (8, [None, 0.5, None, 2.0, 0.1, None]),
    (3, [0.5, 0.5, None, None]),
    (16, [None, None, None, None, None, None, None]),
])
def test_admission_shed_and_backpressure_equal(depth, deadlines):
    j = _queue_script(jadm, jdl, depth, deadlines, FakeClock())
    t = _queue_script(tadm, tdl, depth, deadlines, FakeClock())
    assert j == t


@pytest.mark.parametrize("max_requests,max_rows", [(2, None), (64, 4),
                                                   (3, 100), (64, 1)])
def test_pop_batch_caps_equal(max_requests, max_rows):
    """Coalescing pops stop at the same request / row caps; the first
    request always pops."""
    out = []
    for adm, metrics in ((jadm, jmetrics), (tadm, tmetrics)):
        clock = FakeClock()
        q = adm.AdmissionQueue(32, registry=metrics.Registry(), clock=clock)
        reqs = [adm.Request(np.zeros((r, 4), np.float32), 3)
                for r in (3, 1, 4, 2, 2)]
        for r in reqs:
            q.submit(r)
        q.close()
        got = []
        while True:
            b = q.pop_batch(max_requests, 0.0, max_rows=max_rows)
            if not b:
                break
            got.append([reqs.index(r) for r in b])
        out.append(got)
    assert out[0] == out[1]


# ------------------------------------------------------------- ladder

@pytest.mark.parametrize("ladder", [((8, 32, 128, 512), (16, 64, 128)),
                                    ((1, 2, 3), (1,)), ((64,), (8, 256))])
def test_bucket_ladder_equal_on_grid(ladder):
    lj, lt = jbat.BucketLadder(*ladder), tbat.BucketLadder(*ladder)
    assert lj.shapes() == lt.shapes()
    assert (lj.max_queries, lj.max_k) == (lt.max_queries, lt.max_k)
    for m in range(1, lj.max_queries + 1, 3):
        assert lj.bucket_queries(m) == lt.bucket_queries(m)
    for k in range(1, lj.max_k + 1):
        assert lj.bucket_k(k) == lt.bucket_k(k)
    for bad in (0, lj.max_queries + 1):
        with pytest.raises(Exception):
            lj.bucket_queries(bad)
        with pytest.raises(RaftError):
            lt.bucket_queries(bad)


@pytest.mark.parametrize("ladder", [((8, 8), (16,)), ((32, 8), (16,)),
                                    ((8,), (0,)), ((), (16,))])
def test_bad_ladders_raise_in_both(ladder):
    with pytest.raises(Exception):
        jbat.BucketLadder(*ladder)
    with pytest.raises(RaftError):
        tbat.BucketLadder(*ladder)


def _reqs(adm, rows, dim, seed, k=5):
    rng = np.random.default_rng(seed)
    return [adm.Request(rng.standard_normal((r, dim)).astype(np.float32)
                        if adm is jadm else
                        torch.from_numpy(rng.standard_normal(
                            (r, dim)).astype(np.float32)), k)
            for r in rows]


@pytest.mark.parametrize("rows,mb", [([1], 8), ([3, 5], 8), ([7, 1, 20], 32),
                                     ([128], 128), ([2, 2, 2, 2, 2], 16)])
def test_coalesce_block_equal(rows, mb):
    bj, oj = jbat.coalesce_block(_reqs(jadm, rows, 6, 1), mb, 6)
    bt, ot = tbat.coalesce_block(_reqs(tadm, rows, 6, 1), mb, 6)
    assert oj == ot
    assert bt.dtype == torch.float32 and bt.shape == (mb, 6)
    np.testing.assert_array_equal(bj, bt.numpy())


@pytest.mark.parametrize("done,spent", [(0, ()), (4, (1,)), (9, (0, 2)),
                                        (12, (2,)), (5, ())])
def test_triage_partial_equal(done, spent):
    """Rows [0, done) delivered; requests ``spent`` carry a spent
    deadline: served, expired (with their slices) and retried agree."""
    out = []
    for adm, dlm, bat in ((jadm, jdl, jbat), (tadm, tdl, tbat)):
        clock = FakeClock()
        reqs = _reqs(adm, [3, 4, 5], 6, 2, k=2)
        for i in spent:
            reqs[i].deadline = dlm.Deadline(0.5, clock=clock)
        clock.t += 1.0
        rng = np.random.default_rng(9)
        pd = rng.standard_normal((done, 4)).astype(np.float32)
        pi = rng.integers(0, 99, (done, 4)).astype(np.int32)
        partial = None if done == 0 else (
            (pd, pi) if adm is jadm
            else (torch.from_numpy(pd), torch.from_numpy(pi)))
        served, expired, retry = bat.triage_partial(
            reqs, [0, 3, 7], dlm.DeadlineExceeded("x", partial))
        out.append((
            [(reqs.index(r), np.asarray(s.distances).tolist(),
              np.asarray(s.indices).tolist()) for r, s in served],
            [(reqs.index(r), c, None if own is None else
              [np.asarray(a).tolist() for a in own])
             for r, c, own in expired],
            [reqs.index(r) for r in retry]))
    assert out[0] == out[1]


# ------------------------------------------------------------ batcher

def _backlog(rng_seed, n_req, max_rows=24):
    rng = np.random.default_rng(rng_seed)
    return [(int(rng.integers(0, 300 - max_rows)),
             int(rng.integers(1, max_rows + 1)),
             int(rng.choice([1, 5, K, 16, 40]))) for _ in range(n_req)]


def _serve(package, fn, q, backlog, **kw):
    """Enqueue the backlog on a stopped batcher, start it, read every
    answer; → ([(distances, ids) | error type], counters)."""
    if package == "jax":
        reg = jmetrics.Registry()
        b = jbat.MicroBatcher(fn, D, ladder=jbat.BucketLadder(*LADDER),
                              registry=reg, autostart=False,
                              trace_sample=0.0, **kw)
    else:
        reg = tmetrics.Registry()
        b = tbat.MicroBatcher(fn, D, ladder=tbat.BucketLadder(*LADDER),
                              registry=reg, autostart=False,
                              trace_sample=0.0, device="cpu", **kw)
    futs = []
    for s, m, k in backlog:
        try:
            futs.append(b.submit(q[s:s + m], k))
        except Exception as e:  # noqa: BLE001 - backpressure is an outcome
            futs.append(type(e).__name__)
    b.start()
    out = []
    for f in futs:
        if isinstance(f, str):
            out.append(f)
            continue
        try:
            r = f.result(timeout=TIMEOUT)
            out.append((np.asarray(r.distances), np.asarray(r.indices)))
        except Exception as e:  # noqa: BLE001
            out.append(type(e).__name__)
    b.close()
    c = reg.snapshot()["counters"]
    return out, {k: v for k, v in c.items() if not k.startswith(
        "serve.dispatch.")}


@pytest.mark.parametrize("family", ["brute_force", "ivf_flat"])
def test_backlog_answers_equal(searchers, data, family):
    """A scripted backlog through both batchers: each request's ids equal,
    values to rtol 1e-5, and each equals a direct search of its rows."""
    jfn, tfn = searchers[family]
    q = data[1]
    backlog = _backlog(7, 40)
    jout, jc = _serve("jax", jfn, q, backlog)
    tout, tc = _serve("torch", tfn, q, backlog)
    assert jc == tc
    for (s, m, k), a, b in zip(backlog, jout, tout):
        np.testing.assert_array_equal(a[1], b[1])
        np.testing.assert_allclose(a[0], b[0], rtol=1e-5)
        dd, di = tfn(torch.from_numpy(q[s:s + m]), k)
        np.testing.assert_array_equal(b[1], di.numpy())


@pytest.mark.parametrize("depth", [4, 12])
def test_backlog_backpressure_equal(searchers, data, depth):
    """Past ``queue_depth`` both batchers refuse the same submits."""
    jfn, tfn = searchers["brute_force"]
    backlog = _backlog(11, 16)
    jout, jc = _serve("jax", jfn, data[1], backlog, queue_depth=depth)
    tout, tc = _serve("torch", tfn, data[1], backlog, queue_depth=depth)
    assert jc == tc and jc["serve.rejected"] == max(0, 16 - depth)
    for a, b in zip(jout, tout):
        assert isinstance(a, str) == isinstance(b, str)
        if isinstance(a, str):
            assert a == b == "QueueFullError"
        else:
            np.testing.assert_array_equal(a[1], b[1])


def test_backlog_shed_equal(searchers, data):
    """Requests whose deadlines are spent before the worker starts are
    shed by both (DeadlineExceeded, counted); the rest are served."""
    jfn, tfn = searchers["brute_force"]
    q = data[1]
    outs = []
    for pkg, fn, dlm in (("jax", jfn, jdl), ("torch", tfn, tdl)):
        clock = FakeClock()
        reg = (jmetrics if pkg == "jax" else tmetrics).Registry()
        bat = jbat if pkg == "jax" else tbat
        kw = {} if pkg == "jax" else {"device": "cpu"}
        b = bat.MicroBatcher(fn, D, ladder=bat.BucketLadder(*LADDER),
                             registry=reg, autostart=False, clock=clock,
                             max_wait_s=0.0, trace_sample=0.0, **kw)
        futs = [b.submit(q[i:i + 2], K, dlm.Deadline(s, clock=clock)
                         if s is not None else None)
                for i, s in enumerate([None, 0.5, 5.0, 0.1, None])]
        clock.t += 1.0
        b.start()
        got = []
        for f in futs:
            try:
                got.append(np.asarray(f.result(timeout=TIMEOUT).indices)
                           .tolist())
            except Exception as e:  # noqa: BLE001
                got.append(type(e).__name__)
        b.close()
        c = reg.snapshot()["counters"]
        outs.append((got, c["serve.shed"], c["serve.served"]))
    assert outs[0] == outs[1]
    assert outs[0][1] == 2


def test_pending_group_delivered_when_the_queue_is_all_shed():
    """A dispatched group is delivered even when every request left in the
    queue is shed before the next pop (JAX's worker, whose pop blocks for
    the next admissible request, holds it until new traffic arrives)."""
    clock = FakeClock()

    def fn(q, k, res=None):
        clock.t += 1.0              # the search spends B's budget
        z = torch.zeros((q.shape[0], k))
        return z, z.int()

    b = tbat.MicroBatcher(fn, 4, ladder=tbat.BucketLadder((8,), (16,)),
                          registry=tmetrics.Registry(), autostart=False,
                          max_batch_requests=1, clock=clock,
                          trace_sample=0.0, device="cpu")
    a = b.submit(np.ones((2, 4), np.float32), 3)
    late = b.submit(np.ones((1, 4), np.float32), 3,
                    tdl.Deadline(0.5, clock=clock))
    b.start()
    assert tuple(a.result(timeout=TIMEOUT).indices.shape) == (2, 3)
    with pytest.raises(tdl.DeadlineExceeded):
        late.result(timeout=TIMEOUT)
    b.close()


def test_batcher_stage_telemetry_names_equal(searchers, data):
    """With ``trace_sample=1.0`` both batchers record the five stages for
    every request, in the same histograms and span-log fields."""
    jfn, tfn = searchers["brute_force"]
    names = []
    for pkg, fn in (("jax", jfn), ("torch", tfn)):
        tracing = jtracing if pkg == "jax" else ttracing
        tracing.clear_span_log()
        reg = (jmetrics if pkg == "jax" else tmetrics).Registry()
        bat = jbat if pkg == "jax" else tbat
        kw = {} if pkg == "jax" else {"device": "cpu"}
        b = bat.MicroBatcher(fn, D, ladder=bat.BucketLadder(*LADDER),
                             registry=reg, autostart=False,
                             trace_sample=1.0, **kw)
        futs = [b.submit(data[1][i:i + 3], K) for i in range(4)]
        b.start()
        for f in futs:
            f.result(timeout=TIMEOUT)
        b.close()
        spans = tracing.recent_spans()
        names.append((sorted(h for h in reg.snapshot()["histograms"]),
                      sorted(spans[-1]), sorted(spans[-1]["stages"]),
                      len(spans)))
    assert names[0] == names[1]
    assert names[1][2] == sorted(tbat.STAGES)


def test_dispatch_error_reaches_every_request():
    """A failing search fails its batch's requests with its error, counted
    under ``<name>.errors``, in both packages; the worker survives."""
    outs = []
    for pkg in ("jax", "torch"):
        reg = (jmetrics if pkg == "jax" else tmetrics).Registry()
        bat = jbat if pkg == "jax" else tbat
        kw = {} if pkg == "jax" else {"device": "cpu"}
        calls = []

        def fn(q, k, res=None):
            calls.append(q.shape[0])
            if len(calls) == 1:
                raise ValueError("kernel failed")
            z = np.zeros((q.shape[0], k), np.float32)
            return ((z, z.astype(np.int32)) if pkg == "jax" else
                    (torch.from_numpy(z), torch.from_numpy(z).int()))

        b = bat.MicroBatcher(fn, 4, ladder=bat.BucketLadder((8,), (16,)),
                             registry=reg, autostart=False,
                             trace_sample=0.0, **kw)
        f1 = b.submit(np.ones((2, 4), np.float32), 3)
        b.start()
        with pytest.raises(ValueError, match="kernel failed"):
            f1.result(timeout=TIMEOUT)
        ok = b.submit(np.ones((1, 4), np.float32), 3).result(timeout=TIMEOUT)
        b.close()
        outs.append((reg.snapshot()["counters"]["serve.errors"],
                     np.asarray(ok.indices).shape))
    assert outs[0] == outs[1] == (1.0, (1, 3))


def test_host_queries_and_submit_validation():
    """The port's submit takes numpy or torch rows (1-d: one row) and
    refuses the widths JAX's refuses."""
    b = tbat.MicroBatcher(lambda q, k, res=None: None, 4, device="cpu",
                          autostart=False)
    jb = jbat.MicroBatcher(lambda q, k, res=None: None, 4, autostart=False)
    for rows in (np.ones(4, np.float32), torch.ones((3, 4)),
                 np.ones((2, 4), np.float64)):
        assert tuple(b.submit(rows, 3).queries.shape) == tuple(
            jb.submit(np.asarray(rows), 3).queries.shape)
    for bad, k in ((np.ones((2, 5)), 3), (np.ones((2, 4)), 500),
                   (np.ones((600, 4)), 3)):
        with pytest.raises(Exception):
            jb.submit(bad, k)
        with pytest.raises(RaftError):
            b.submit(bad, k)
    b.close(timeout=1)
    jb.close(timeout=1)


def test_batcher_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RaftError, match="no CUDA device"):
        tbat.MicroBatcher(lambda q, k, res=None: None, 4, autostart=False)


# ------------------------------------------------------------- warmup

def test_warmup_sweeps_every_shape(searchers):
    """Both warmups dispatch every ladder shape once and record the shape
    count; the port keeps each shape's first-call seconds."""
    jfn, tfn = searchers["ivf_flat"]
    jreg, treg = jmetrics.Registry(), tmetrics.Registry()
    jwarm.warmup(jfn, jbat.BucketLadder(*LADDER), D, registry=jreg)
    n = twarm.warmup(tfn, tbat.BucketLadder(*LADDER), D, registry=treg)
    assert n == 0        # a CPU search loads no kernel library
    jg, tg = jreg.snapshot()["gauges"], treg.snapshot()["gauges"]
    assert jg["serve.warmup.shapes"] == tg["serve.warmup.shapes"] == 6
    assert sorted(k for k in tg if "first_call_s" in k) == sorted(
        f"serve.warmup.first_call_s.{m}x{k}" for m, k in
        tbat.BucketLadder(*LADDER).shapes())


@pytest.mark.parametrize("label,warm", [(None, False), ("serve:8x16", False),
                                        ("serve:warmup:8x16", True)])
def test_first_call_watch_counts_like_the_compile_watch(label, warm):
    """A first call counts in ``count_compilations`` and ``serve.compiles``
    as a compile does in JAX's watch; inside a non-warmup dispatch label
    it also counts ``serve.recompiles`` and records one event (JAX's
    ``xla_compile``, the port's ``first_call``)."""
    from raft_tpu.core import events as jev
    from raft_tpu_torch.core import events as tev

    def deltas(metrics, events, kind, trigger, warmup_mod):
        before = metrics.snapshot()["counters"]
        n_ev = len(events.recent(kind=kind))
        with warmup_mod.count_compilations() as cc:
            if label is None:
                trigger()
            else:
                with warmup_mod.compile_context(label, warmup=warm):
                    trigger()
        after = metrics.snapshot()["counters"]
        return (cc.count > 0,
                after.get("serve.compiles", 0) > before.get(
                    "serve.compiles", 0),
                after.get("serve.recompiles", 0) - before.get(
                    "serve.recompiles", 0),
                len(events.recent(kind=kind)) - n_ev)

    def jax_compile():
        # the compile funnel JAX's watch wraps, called directly: the spy
        # counts before it hands the (here empty) arguments on
        from jax._src import compiler

        with pytest.raises(Exception):
            compiler.backend_compile(None)

    jwarm.install_recompile_watch()
    j = deltas(jmetrics, jev, "xla_compile", jax_compile, jwarm)
    t = deltas(tmetrics, tev, "first_call",
               lambda: _cuda.note_first_call("library", "unit"), twarm)
    assert j[:2] == t[:2] == (True, True)
    assert j[2:] == t[2:]
    assert t[2:] == ((1, 1) if label == "serve:8x16" else (0, 0))


def test_warmup_sharded_is_not_ported():
    with pytest.raises(RaftError, match="not ported yet"):
        twarm.warmup_sharded(None, (16,))


# --------------------------------------------------- sharded searcher

P4 = 4


@pytest.fixture(scope="module")
def sharded(data):
    x = data[0]
    mesh = JaxMesh(np.array(jax.devices()[:P4]), ("shard",))
    j = jsa.build_ivf_flat(jnp.asarray(x), mesh,
                           jivf.IndexParams(n_lists=8, seed=0))
    t = convert.sharded_ivf_flat_from_numpy(
        {"data": np.asarray(j.data), "data_norms": np.asarray(j.data_norms),
         "source_ids": np.asarray(j.source_ids),
         "centers": np.asarray(j.centers),
         "center_norms": np.asarray(j.center_norms),
         "offsets": np.asarray(j.offsets), "sizes": np.asarray(j.sizes),
         "n_total": j.n_total, "metric": j.metric.value},
        Mesh(["cpu"] * P4))
    return j, t


@pytest.mark.parametrize("dead", [(), (2,)])
def test_sharded_make_searcher_equal(sharded, data, dead):
    """``make_searcher(allow_partial=True)``: ids, values and
    ``shards_ok`` equal with every shard alive and with one marked dead."""
    j, t = sharded
    for s in range(P4):
        j.mark_shard_failed(s, ok=s not in dead)
        t.mark_shard_failed(s, ok=s not in dead)
    sp = 4
    jfn = jsa.make_searcher(j, jivf.SearchParams(n_probes=sp),
                            allow_partial=True)
    tfn = sharded_ann.make_searcher(t, ivf_flat.SearchParams(n_probes=sp),
                                    allow_partial=True)
    q = data[1][:16]
    jd, ji, jok = jfn(jnp.asarray(q), K)
    td, ti, tok = tfn(torch.from_numpy(q), K)
    np.testing.assert_array_equal(np.asarray(jok), tok)
    np.testing.assert_array_equal(np.asarray(ji), ti.numpy())
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), rtol=1e-5)
    assert sharded_ann.searcher_dim(t) == jsa.searcher_dim(j) == D
    for s in range(P4):
        j.mark_shard_failed(s, ok=True)
        t.mark_shard_failed(s, ok=True)


def test_batcher_demuxes_shards_ok(sharded, data):
    """Through the port's batcher a degraded sharded searcher's
    ``shards_ok`` reaches each response and the health metrics, as in
    JAX's."""
    j, t = sharded
    j.mark_shard_failed(1)
    t.mark_shard_failed(1)
    try:
        outs = []
        for pkg in ("jax", "torch"):
            reg = (jmetrics if pkg == "jax" else tmetrics).Registry()
            if pkg == "jax":
                fn = jsa.make_searcher(j, jivf.SearchParams(n_probes=4),
                                       allow_partial=True)
                b = jbat.MicroBatcher(fn, D, ladder=jbat.BucketLadder(
                    *LADDER), registry=reg, autostart=False)
            else:
                fn = sharded_ann.make_searcher(
                    t, ivf_flat.SearchParams(n_probes=4), allow_partial=True)
                b = tbat.MicroBatcher(fn, D, ladder=tbat.BucketLadder(
                    *LADDER), registry=reg, autostart=False, device="cpu")
            futs = [b.submit(data[1][i:i + 2], K) for i in (0, 2, 4)]
            b.start()
            res = [f.result(timeout=TIMEOUT) for f in futs]
            b.close()
            snap = reg.snapshot()
            outs.append(([np.asarray(r.shards_ok).tolist() for r in res],
                         [np.asarray(r.indices).tolist() for r in res],
                         snap["gauges"]["serve.healthy_shards"],
                         snap["counters"]["serve.degraded_batches"]))
        assert outs[0] == outs[1]
        assert outs[0][2] == P4 - 1
    finally:
        j.mark_shard_failed(1, ok=True)
        t.mark_shard_failed(1, ok=True)


def test_sharded_make_searcher_refusals(sharded):
    _, t = sharded
    with pytest.raises(RaftError, match="donate"):
        sharded_ann.make_searcher(t, donate=True)
    with pytest.raises(RaftError, match="unsupported"):
        sharded_ann.make_searcher(object())
    fn = sharded_ann.make_searcher(t)
    with pytest.raises(tdl.DeadlineExceeded):
        fn(torch.zeros((2, D)), K, res=tdl.Deadline(0.0))
