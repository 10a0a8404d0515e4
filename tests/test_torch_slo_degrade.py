"""The port's SLO engine and brownout controller against the JAX
package's, on the CPU.

Both packages' engines read the same scripted metric stream (counters,
latency observations and recall gauges written into each package's own
registry) under one injected clock; their reports must be equal, verdict
for verdict and number for number (pure Python on both sides: exact).
The controllers get the same scripted reports and must walk the same
levels step for step, with the same transitions and ``brownout`` events;
``degrade.params`` must override the same fields of each family's
``SearchParams``, and the families' ``make_searcher(degrade=...)`` must
search with the current level's parameters.
"""
import dataclasses

import numpy as np
import pytest
import torch

from raft_tpu.core import events as jev
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.serve import degrade as jdeg
from raft_tpu.serve import metrics as jmetrics
from raft_tpu.serve import slo as jslo
from raft_tpu_torch.core import events as tev
from raft_tpu_torch.neighbors import cagra, ivf_flat, ivf_pq
from raft_tpu_torch.serve import degrade as tdeg
from raft_tpu_torch.serve import metrics as tmetrics
from raft_tpu_torch.serve import slo as tslo


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t


PKGS = {"jax": (jmetrics, jslo, jdeg, jev), "torch": (tmetrics, tslo, tdeg,
                                                    tev)}

TARGETS = {
    "latency": dict(p99_latency_s=0.05),
    "shed": dict(max_shed_rate=0.1),
    "recall": dict(recall_floor=0.9, recall_min_samples=3),
    "all": dict(p99_latency_s=0.02, max_shed_rate=0.05, recall_floor=0.8,
                max_demotion_rate=0.5),
    "recall_family": dict(recall_floor=0.95, recall_family="ivf_flat",
                          recall_warn_margin=0.03),
}


def _stream(seed, steps=40):
    """A scripted stream: each step (dt, requests, sheds, latencies,
    recall estimate or None, recall samples)."""
    rng = np.random.default_rng(seed)
    out = []
    for s in range(steps):
        burn = 10 <= s < 22          # a burst of slow, shed traffic
        lat = rng.exponential(0.08 if burn else 0.004, int(rng.integers(
            3, 12))).tolist()
        rec = None if s < 3 else float(np.clip(
            (0.85 if burn else 0.97) + rng.normal(0, 0.02), 0, 1))
        out.append((float(rng.choice([5.0, 15.0, 30.0])),
                    int(rng.integers(5, 40)),
                    int(rng.integers(3, 9)) if burn else 0, lat, rec,
                    min(s, 32)))
    return out


def _feed(reg, name, step, family="default"):
    _dt, req, shed, lat, rec, n = step
    reg.counter(f"{name}.requests").inc(req)
    reg.counter(f"{name}.shed").inc(shed)
    reg.counter(f"{name}.batches").inc(max(1, req // 4))
    h = reg.histogram(f"{name}.latency_s")
    for v in lat:
        h.observe(v)
    if rec is not None:
        reg.gauge(f"{name}.recall.{family}").set(rec)
        reg.gauge(f"{name}.recall.{family}.samples").set(n)


def _run_slo(pkg, targets, seed):
    metrics, slo, _, events = PKGS[pkg]
    clock = FakeClock()
    reg = metrics.Registry()
    eng = slo.SLOEngine(slo.Targets(**targets), registry=reg, clock=clock,
                        fast_window_s=60.0, slow_window_s=300.0)
    events.clear()
    fam = targets.get("recall_family", "default")
    reports = []
    for step in _stream(seed):
        clock.t += step[0]
        _feed(reg, "serve", step, fam)
        if step[0] == 5.0:
            eng.tick()
        else:
            reports.append(eng.evaluate())
    ev = [(e["kind"], e["site"], e.get("target"), e.get("value"))
          for e in events.recent(kind="slo_breach")]
    return reports, ev, reg.counter("serve.slo.breaches").value


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("targets", sorted(TARGETS))
def test_slo_verdicts_equal(targets, seed):
    """Every evaluation's report, the breach events and the breach count
    are equal over the same stream."""
    j = _run_slo("jax", TARGETS[targets], seed)
    t = _run_slo("torch", TARGETS[targets], seed)
    assert j == t


def test_slo_breach_fires_once_a_transition():
    """A stream that burns then recovers: one ``slo_breach`` event per
    target per crossing in both packages, the counter alike."""
    j = _run_slo("jax", TARGETS["all"], 5)
    t = _run_slo("torch", TARGETS["all"], 5)
    assert j[1] == t[1] and j[2] == t[2] and len(t[1]) >= 1


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_slo_install_slot(pkg):
    """``install`` is a weak process slot in both packages."""
    metrics, slo, _, _ = PKGS[pkg]
    eng = slo.SLOEngine(slo.Targets(), registry=metrics.Registry())
    eng.install()
    assert slo.installed() is eng
    slo.uninstall()
    assert slo.installed() is None


# ---------------------------------------------------------- brownout

def _verdict(v):
    return {"verdict": v}


REPORTS = {
    # latency breach, dwell, further breach, recovery after green
    "step_down_up": [("p99_latency_s", "breach", 0, 0)] * 4
    + [("p99_latency_s", "ok", 0, 0)] * 8,
    # recall at the floor refuses further degradation
    "floor_refuses": [("p99_latency_s", "breach", 10, "warn")] * 3
    + [("p99_latency_s", "breach", 10, "breach")] * 2,
    # shed-rate breaches, interleaved warns reset the green timer
    "shed_flap": [("shed_rate", "breach", 0, 0),
                  ("shed_rate", "warn", 0, 0),
                  ("shed_rate", "ok", 0, 0),
                  ("shed_rate", "breach", 0, 0),
                  ("shed_rate", "ok", 0, 0),
                  ("shed_rate", "ok", 0, 0),
                  ("shed_rate", "ok", 0, 0)] * 2,
    # a memory breach skips the dwell
    "memory": [("device_bytes", "breach", 0, 0)] * 3
    + [("device_bytes", "ok", 0, 0)] * 5,
    # insufficient samples never block a step down
    "thin_recall": [("p99_latency_s", "breach", 0, "breach")] * 4,
}


def _report(key, v, samples, rec):
    t = {key: _verdict(v)}
    if rec:
        t["recall"] = {"verdict": rec, "samples": samples}
    return {"targets": t}


def _run_ctl(pkg, script, levels, env):
    _, _, degrade, events = PKGS[pkg]
    clock = FakeClock()
    events.clear()
    metrics = PKGS[pkg][0]
    reg = metrics.Registry()
    ctl = degrade.BrownoutController(levels, registry=reg, clock=clock,
                                     **env)
    walk = []
    for key, v, samples, rec in REPORTS[script]:
        clock.t += 4.0
        walk.append((ctl.on_report(_report(key, v, samples, rec)),
                     ctl.max_wait_scale()))
    snap = ctl.snapshot()
    trans = [(tr["from"], tr["to"], tr["reason"])
             for tr in snap.pop("transitions")]
    ev = [(e["kind"], e["level_from"], e["level_to"], e["reason"])
          for e in events.recent(kind="brownout")]
    return (walk, trans, ev, snap, reg.gauge("serve.brownout.level").value,
            reg.counter("serve.brownout.transitions").value)


LEVELS = {
    "default": None,
    "deep": [{"n_probes": 12, "max_wait_scale": 2.0},
             {"n_probes": 6, "itopk_size": 48, "max_wait_scale": 3.0},
             {"n_probes": 3, "itopk_size": 32, "max_wait_scale": 4.0}],
}


@pytest.mark.parametrize("levels", sorted(LEVELS))
@pytest.mark.parametrize("script", sorted(REPORTS))
def test_brownout_levels_equal(script, levels):
    """The same reports walk both controllers through the same levels,
    max-wait scales, transitions, events and metrics."""
    env = dict(min_dwell_s=5.0, up_after_s=12.0)
    j = _run_ctl("jax", script, LEVELS[levels], env)
    t = _run_ctl("torch", script, LEVELS[levels], env)
    assert j == t


@pytest.mark.parametrize("max_level", ["1", "0", "9", "bad"])
def test_brownout_env_knobs_equal(monkeypatch, max_level):
    monkeypatch.setenv("RAFT_TPU_BROWNOUT_MAX_LEVEL", max_level)
    monkeypatch.setenv("RAFT_TPU_BROWNOUT_MIN_DWELL_S", "2.5")
    monkeypatch.setenv("RAFT_TPU_BROWNOUT_UP_AFTER_S", "7")
    snaps = [PKGS[p][2].BrownoutController(LEVELS["deep"],
                                           registry=PKGS[p][0].Registry()
                                           ).snapshot() for p in PKGS]
    assert snaps[0] == snaps[1]


def test_poll_drives_the_engine():
    """``poll`` evaluates the attached engine and acts on it: the same
    breach stream walks both packages' controllers alike."""
    outs = []
    for pkg in ("jax", "torch"):
        metrics, slo, degrade, _ = PKGS[pkg]
        clock = FakeClock()
        reg = metrics.Registry()
        eng = slo.SLOEngine(slo.Targets(p99_latency_s=0.01), registry=reg,
                            clock=clock, fast_window_s=10, slow_window_s=20)
        ctl = degrade.BrownoutController(LEVELS["deep"], slo=eng,
                                         registry=reg, clock=clock,
                                         min_dwell_s=5, up_after_s=30)
        levels = []
        for step in range(30):
            clock.t += 6.0
            h = reg.histogram("serve.latency_s")
            for _ in range(5):
                h.observe(0.2 if step < 12 else 0.001)
            reg.counter("serve.requests").inc(5)
            rep = ctl.poll()
            levels.append((rep["brownout_level"], rep["verdict"]))
        outs.append(levels)
    assert outs[0] == outs[1]
    assert max(lv for lv, _ in outs[1]) == 3 and outs[1][-1][0] < 3


# -------------------------------------------------- params on families

FAMILY_PARAMS = {
    "ivf_flat": (jivf.SearchParams(n_probes=20), ivf_flat.SearchParams(
        n_probes=20), ("n_probes",)),
    "ivf_pq": (jpq.SearchParams(n_probes=20), ivf_pq.SearchParams(
        n_probes=20), ("n_probes",)),
    "cagra": (jcagra.SearchParams(itopk_size=64), cagra.SearchParams(
        itopk_size=64), ("itopk_size", "search_width")),
}


@pytest.mark.parametrize("level", [0, 1, 2, 3])
@pytest.mark.parametrize("family", sorted(FAMILY_PARAMS))
def test_degrade_params_equal(family, level):
    """``degrade.params`` overrides the same fields of each family's
    SearchParams at every level (fields a family lacks are ignored)."""
    jp, tp, fields = FAMILY_PARAMS[family]
    out = []
    for pkg, base in (("jax", jp), ("torch", tp)):
        metrics, _, degrade, _ = PKGS[pkg]
        ctl = degrade.BrownoutController(
            LEVELS["deep"] + [{"search_width": 2}],
            registry=metrics.Registry(), min_dwell_s=0)
        ctl._level = level
        p = ctl.params(base)
        out.append(({f: getattr(p, f) for f in fields}, p is base))
    assert out[0] == out[1]
    assert out[1][1] or level > 0


@pytest.fixture(scope="module")
def small_indexes():
    rng = np.random.default_rng(6)
    x = rng.integers(-4, 5, (600, 16)).astype(np.float32)
    return x, {
        "ivf_flat": ivf_flat.build(x, ivf_flat.IndexParams(n_lists=8),
                                   device="cpu"),
        "ivf_pq": ivf_pq.build(x, ivf_pq.IndexParams(n_lists=8, pq_dim=4),
                               device="cpu")}


@pytest.mark.parametrize("family", ["ivf_flat", "ivf_pq"])
def test_make_searcher_follows_the_level(small_indexes, family):
    """Each call of a ``make_searcher(degrade=ctl)`` closure searches with
    the controller's current level (n_probes 8 → 2 → 1 → back)."""
    x, idx = small_indexes
    mod = {"ivf_flat": ivf_flat, "ivf_pq": ivf_pq}[family]
    ctl = tdeg.BrownoutController([{"n_probes": 2}, {"n_probes": 1}],
                                  registry=tmetrics.Registry())
    fn = mod.make_searcher(idx[family], mod.SearchParams(n_probes=8),
                           degrade=ctl)
    q = torch.from_numpy(x[:20])
    for level, probes in ((0, 8), (1, 2), (2, 1), (0, 8)):
        ctl._level = level
        d, i = fn(q, 5)
        wd, wi = mod.search(idx[family], q, 5,
                            dataclasses.replace(mod.SearchParams(),
                                                n_probes=probes))
        assert torch.equal(i, wi) and torch.equal(d, wd)
