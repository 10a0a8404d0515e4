"""The port's multi-tenant fabric and query cache against the JAX
package's, on the CPU.

The same scripted traffic, made with numpy from a seed, goes through
``raft_tpu.serve.tenancy`` and ``raft_tpu_torch.serve.tenancy`` under one
injected clock, driven by hand (``autostart=False``, ``drain_once``,
``tick``). Tolerances: token-bucket admits, the weighted-fair drain's
order, cache digests (digest for digest on the same bytes), hits,
misses, evictions and invalidations, swap generations and events equal;
served answers on integer-valued rows equal in ids and to rtol 1e-5 in
values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import events as jev
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.serve import batcher as jbat
from raft_tpu.serve import metrics as jmetrics
from raft_tpu.serve import qcache as jqc
from raft_tpu.serve import quality as jq
from raft_tpu.serve import slo as jslo
from raft_tpu.serve import tenancy as jten
from raft_tpu_torch.core import events as tev
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.serve import batcher as tbat
from raft_tpu_torch.serve import metrics as tmetrics
from raft_tpu_torch.serve import qcache as tqc
from raft_tpu_torch.serve import quality as tq
from raft_tpu_torch.serve import slo as tslo
from raft_tpu_torch.serve import tenancy as tten

N, D, K = 500, 16, 5
TIMEOUT = 60
LADDER = ((8, 32, 64), (8, 16))


class FakeClock:
    def __init__(self, t=50.0):
        self.t = t

    def __call__(self):
        return self.t


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(77)
    x = rng.integers(-4, 5, (N, D)).astype(np.float32)
    q = rng.integers(-4, 5, (200, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def indexes(data):
    x = data[0]
    return {"jax": (jbf.build(jnp.asarray(x)),
                    jbf.build(jnp.asarray(x[::-1].copy()))),
            "torch": (brute_force.build(x, device="cpu"),
                      brute_force.build(x[::-1].copy(), device="cpu"))}


PKG = {"jax": (jten, jbat, jmetrics, jqc, jev),
       "torch": (tten, tbat, tmetrics, tqc, tev)}


def _fabric(pkg, clock, cache=None, **kw):
    ten, bat, metrics, _, _ = PKG[pkg]
    extra = {} if pkg == "jax" else {"device": "cpu"}
    return ten.ServeFabric(D, ladder=bat.BucketLadder(*LADDER),
                           registry=metrics.Registry(), clock=clock,
                           autostart=False, cache=cache, **extra, **kw)


def _stub(pkg, tag, calls):
    """A search closure that records its dispatches (tag, rows, k)."""
    def fn(q, k, res=None):
        calls.append((tag, int(q.shape[0]), int(k)))
        z = np.full((q.shape[0], k), float(len(calls)), np.float32)
        i = np.zeros((q.shape[0], k), np.int32)
        return ((z, i) if pkg == "jax"
                else (torch.from_numpy(z), torch.from_numpy(i)))
    return fn


# --------------------------------------------------------- token bucket

@pytest.mark.parametrize("rate,burst", [(1.0, None), (5.0, 2.0),
                                        (0.5, 3.0), (100.0, 1.0)])
def test_token_bucket_equal(rate, burst):
    """The same take / refill script admits the same requests."""
    out = []
    for ten in (jten, tten):
        clock = FakeClock()
        b = ten.TokenBucket(rate, burst, clock=clock)
        got = []
        for dt in (0.0, 0.0, 0.0, 0.3, 0.1, 1.0, 0.0, 2.5, 0.0, 0.0, 0.01):
            clock.t += dt
            got.append((b.try_take(), round(b.level(), 9)))
        out.append(got)
    assert out[0] == out[1]


def test_rate_limited_shed_equal(data):
    """Over-rate submits raise ``RateLimitedError`` (a ``QueueFullError``),
    counted under ``<tenant>.shed`` with one ``tenant_shed`` event each."""
    _, q = data
    out = []
    for pkg in ("jax", "torch"):
        ten, _, _, _, ev = PKG[pkg]
        ev.clear()
        clock = FakeClock()
        fab = _fabric(pkg, clock)
        fab.add_tenant("hot", search_fn=_stub(pkg, "hot", []), rate=2.0,
                       burst=2.0)
        got = []
        for s in range(6):
            clock.t += 0.2
            try:
                fab.submit("hot", q[s:s + 1], K)
                got.append("ok")
            except ten.RateLimitedError as e:
                got.append(type(e).__mro__[1].__name__)
        t = fab.tenant("hot")
        out.append((got, t.registry.counter("hot.shed").value,
                    [(e["site"], e["reason"], e["rows"], e["k"])
                     for e in ev.recent(kind="tenant_shed")]))
        fab.close(timeout=1)
    assert out[0] == out[1]
    assert out[1][0].count("ok") == 4


# ------------------------------------------------------ weighted drain

@pytest.mark.parametrize("weights,quantum", [((1, 1, 1), 8), ((2, 1, 1), 8),
                                             ((4, 1, 2), 4), ((1, 3), 16)])
def test_weighted_fair_drain_order_equal(data, weights, quantum):
    """A backlog on every tenant, drained round by round: the same
    dispatches (tenant, padded rows, k bucket) in the same order."""
    _, q = data
    out = []
    rng = np.random.default_rng(sum(weights) + quantum)
    script = [(int(rng.integers(len(weights))), int(rng.integers(1, 7)))
              for _ in range(40)]
    for pkg in ("jax", "torch"):
        calls = []
        fab = _fabric(pkg, FakeClock(), quantum_rows=quantum)
        for ti, w in enumerate(weights):
            fab.add_tenant(f"t{ti}", search_fn=_stub(pkg, f"t{ti}", calls),
                           weight=w)
        futs = [fab.submit(f"t{ti}", q[j:j + rows], K)
                for j, (ti, rows) in enumerate(script)]
        rounds = []
        while True:
            n = fab.drain_once()
            if not n:
                break
            rounds.append(n)
        res = [f.result(timeout=TIMEOUT) for f in futs]
        out.append((calls, rounds,
                    [float(np.asarray(r.distances)[0, 0]) for r in res]))
        fab.close(timeout=1)
    assert out[0] == out[1]


def test_cobatching_equal(data):
    """Tenants sharing one closure co-batch; the counter and the
    dispatches agree."""
    _, q = data
    out = []
    for pkg in ("jax", "torch"):
        calls = []
        fab = _fabric(pkg, FakeClock())
        shared = _stub(pkg, "shared", calls)
        fab.add_tenant("a", search_fn=shared)
        fab.add_tenant("b", search_fn=shared)
        fab.add_tenant("c", search_fn=_stub(pkg, "c", calls))
        futs = [fab.submit(t, q[i:i + 2], K) for i, t in
                enumerate("abcab")]
        fab.drain_once()
        [f.result(timeout=TIMEOUT) for f in futs]
        snap = fab.snapshot()
        out.append((calls, snap["cobatched_dispatches"], snap["batches"]))
        fab.close(timeout=1)
    assert out[0] == out[1]


def test_fabric_answers_equal(data, indexes):
    """Two brute-force tenants (their own indexes) behind both fabrics:
    every request's ids equal, values to rtol 1e-5, and equal to a direct
    search."""
    _, q = data
    rng = np.random.default_rng(3)
    script = [("a" if rng.random() < 0.5 else "b", int(rng.integers(0, 150)),
               int(rng.integers(1, 9)), int(rng.choice([3, K, 16])))
              for _ in range(30)]
    outs = []
    for pkg in ("jax", "torch"):
        fab = _fabric(pkg, FakeClock())
        fab.add_tenant("a", indexes[pkg][0], weight=2)
        fab.add_tenant("b", indexes[pkg][1])
        futs = [fab.submit(t, q[s:s + m], k) for t, s, m, k in script]
        while fab.drain_once():
            pass
        outs.append([f.result(timeout=TIMEOUT) for f in futs])
        fab.close(timeout=1)
    for (t, s, m, k), a, b in zip(script, *outs):
        np.testing.assert_array_equal(np.asarray(a.indices), b.indices)
        np.testing.assert_allclose(np.asarray(a.distances), b.distances,
                                   rtol=1e-5)
        idx = indexes["torch"][0 if t == "a" else 1]
        np.testing.assert_array_equal(
            brute_force.search(idx, q[s:s + m], k)[1], b.indices)


def test_fabric_refusals_equal(data):
    _, q = data
    for pkg in ("jax", "torch"):
        fab = _fabric(pkg, FakeClock())
        fab.add_tenant("a", search_fn=_stub(pkg, "a", []))
        for bad in (lambda: fab.add_tenant("a", search_fn=lambda *a: a),
                    lambda: fab.submit("nope", q[:1], K),
                    lambda: fab.submit("a", q[:1, :4], K),
                    lambda: fab.submit("a", q[:1], 99),
                    lambda: fab.add_tenant("w", search_fn=lambda *a: a,
                                           weight=0)):
            with pytest.raises(Exception) as ei:
                bad()
            if pkg == "torch":
                assert isinstance(ei.value, RaftError)
        fab.close(timeout=1)


def test_fabric_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RaftError, match="no CUDA device"):
        tten.ServeFabric(D, autostart=False)


# ---------------------------------------------------------- the cache

@pytest.mark.parametrize("shape,dtype", [((1, 16), np.float32),
                                         ((3, 7), np.float64),
                                         ((16, 128), np.float32),
                                         ((2, 5), np.int32)])
def test_query_digest_equal(shape, dtype):
    """Digest for digest on the same bytes (a tensor digests as its
    float32 bytes, a non-contiguous block as its contiguous copy)."""
    a = (np.random.default_rng(1).standard_normal(shape) * 9).astype(dtype)
    assert jqc.query_digest(a) == tqc.query_digest(a)
    assert jqc.query_digest(a) == tqc.query_digest(torch.from_numpy(a))
    at = np.asfortranarray(a)
    assert jqc.query_digest(at) == tqc.query_digest(at)


@pytest.mark.parametrize("capacity,max_rows", [(4, 16), (2, 1), (64, 3)])
def test_cache_hits_and_evictions_equal(capacity, max_rows):
    """The same get / put script: the same hits, misses, bypasses,
    evictions, entries and LRU order."""
    rng = np.random.default_rng(capacity)
    blocks = [rng.integers(0, 3, (int(rng.integers(1, 5)), 4)).astype(
        np.float32) for _ in range(12)]
    out = []
    for qc, metrics in ((jqc, jmetrics), (tqc, tmetrics)):
        c = qc.QueryCache(capacity, max_rows, registry=metrics.Registry())
        got = []
        for i in range(40):
            b = blocks[int(rng.integers(len(blocks)))] if i else blocks[0]
            key = c.key("t" + str(i % 2), b, 5, "p")
            hit = c.get(key)
            got.append(None if hit is None else
                       np.asarray(hit[1]).tolist())
            if hit is None:
                c.put(key, np.full((b.shape[0], 5), i, np.float32),
                      np.full((b.shape[0], 5), i, np.int32))
        snap = c.snapshot()
        out.append((got, snap, len(c)))
        rng = np.random.default_rng(capacity)
        [rng.integers(0, 3, (int(rng.integers(1, 5)), 4)) for _ in
         range(12)]
    assert out[0] == out[1]


def test_cache_invalidate_equal():
    out = []
    for qc, metrics in ((jqc, jmetrics), (tqc, tmetrics)):
        c = qc.QueryCache(16, 4, registry=metrics.Registry())
        for t in ("a", "a", "b"):
            blk = np.full((1, 4), len(c), np.float32)
            c.put(c.key(t, blk, 3, "p"), np.zeros((1, 3)),
                  np.zeros((1, 3), np.int32))
        n = c.invalidate_tenant("a")
        out.append((n, len(c), c.snapshot()))
        c.clear()
        assert len(c) == 0
    assert out[0] == out[1]


def test_cache_copies_in_and_out():
    """A hit is a copy: editing it, or the array put, leaves the entry."""
    c = tqc.QueryCache(4, 4, registry=tmetrics.Registry())
    blk = np.ones((1, 4), np.float32)
    d = np.zeros((1, 3), np.float32)
    key = c.key("a", blk, 3, "p")
    c.put(key, d, np.zeros((1, 3), np.int32))
    d[:] = 7
    h = c.get(key)
    h[0][:] = 9
    assert float(c.get(key)[0].sum()) == 0.0


def test_fabric_cache_and_swap_equal(data, indexes):
    """Repeats hit the cache; a swap moves the generation, invalidates the
    tenant's entries, records ``tenant_swap`` with the warmed shapes, and
    the next repeat misses and is served by the new index."""
    _, q = data
    out = []
    for pkg in ("jax", "torch"):
        ten, _, metrics, qc, ev = PKG[pkg]
        ev.clear()
        cache = qc.QueryCache(32, 8, registry=metrics.Registry())
        fab = _fabric(pkg, FakeClock(), cache=cache)
        t = fab.add_tenant("a", indexes[pkg][0])
        served = []
        for step in range(8):
            f = fab.submit("a", q[step % 3:step % 3 + 2], K)
            fab.drain_once()
            served.append((f.result(timeout=TIMEOUT).indices.tolist()
                           if pkg == "torch" else
                           np.asarray(f.result(timeout=TIMEOUT).indices)
                           .tolist()))
            if step == 4:
                gen = t.swap(indexes[pkg][1])
        fab.tick()
        snap = fab.snapshot()
        out.append((served, gen, cache.snapshot(),
                    [(e["site"], e["generation"], e["warmed_shapes"],
                      e["family"]) for e in ev.recent(kind="tenant_swap")],
                    snap["tenants"]["a"]["generation"],
                    snap["tenants"]["a"]["qcache"]))
        fab.close(timeout=1)
    assert out[0] == out[1]
    assert out[1][1] == 1 and out[1][2]["invalidated"] > 0


def test_stale_cache_hook_equal(data):
    """A ``qcache``-family recall regression from the tenant's sentinel
    records ``qcache_stale`` and drops the tenant's entries, in both."""
    x, q = data

    def ref(queries, k):
        qq = np.asarray(queries, np.float32)
        dd = ((qq[:, None] - x[None]) ** 2).sum(-1)
        ii = np.argsort(dd, 1, kind="stable")[:, :k]
        return np.take_along_axis(dd, ii, 1), ii.astype(np.int32)

    out = []
    for pkg, q_mod in (("jax", jq), ("torch", tq)):
        ten, _, metrics, qc, ev = PKG[pkg]
        ev.clear()
        reg = metrics.Registry()
        cache = qc.QueryCache(32, 8, registry=reg)
        fab = _fabric(pkg, FakeClock(), cache=cache)
        sent = q_mod.RecallSentinel(ref, sample=1.0, floor=0.9,
                                    min_samples=1, registry=reg,
                                    autostart=False)
        fab.add_tenant("a", search_fn=_stub(pkg, "a", []), sentinel=sent)
        for _ in range(3):
            f = fab.submit("a", q[:2], K)
            fab.drain_once()
            f.result(timeout=TIMEOUT)
        sent.start()
        assert sent.drain(timeout=TIMEOUT)
        sent.close()
        out.append(([(e["site"], e["samples"]) for e in
                     ev.recent(kind="qcache_stale")], len(cache),
                    fab.tenant("a").registry.counter(
                        "a.qcache.stale").value))
        fab.close(timeout=1)
    assert out[0] == out[1]
    assert out[1][0] and out[1][1] == 0


def test_tenant_slo_and_tick_equal(data):
    """Per-tenant SLO engines and brownout controllers over each tenant's
    own registry: ``tick`` reports the same verdicts and levels."""
    _, q = data
    out = []
    for pkg, slo in (("jax", jslo), ("torch", tslo)):
        clock = FakeClock()
        fab = _fabric(pkg, clock)
        fab.add_tenant("a", search_fn=_stub(pkg, "a", []),
                       targets=slo.Targets(p99_latency_s=0.5))
        fab.add_tenant("b", search_fn=_stub(pkg, "b", []))
        ticks = []
        for step in range(6):
            clock.t += 0.0 if step < 3 else 30.0
            f = fab.submit("a", q[:1], K)
            clock.t += 1.0 if step < 3 else 0.0
            fab.drain_once()
            f.result(timeout=TIMEOUT)
            ticks.append(fab.tick())
        snap = fab.snapshot()
        out.append((ticks, sorted(snap["tenants"]["a"]),
                     sorted(snap["tenants"]["b"]), sorted(snap)))
        fab.close(timeout=1)
    assert out[0] == out[1]


def test_install_slot_equal():
    for pkg in ("jax", "torch"):
        ten = PKG[pkg][0]
        fab = _fabric(pkg, FakeClock())
        ten.install(fab)
        assert ten.installed() is fab
        ten.uninstall()
        assert ten.installed() is None
        fab.close(timeout=1)
