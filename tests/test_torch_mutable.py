"""The port's crash-safe mutable index (``raft_tpu_torch/neighbors/
mutable.py``) against the JAX package's (``raft_tpu/neighbors/mutable.py``)
and on the scenarios of ``tests/test_mutable.py``.

Covered, on the port: upsert / delete / search against a reference,
delete-then-reinsert, an overwrite in the delta, auto ids across a
recover, ``make_searcher``, a user filter refused; tombstones on the four
families (CAGRA's gather and edge engines); every ``CRASH_POINTS`` site
killed and recovered (and a sweep of the sources for crash probes), the
torn-tail drill, a corrupt segment rebuilt from the snapshot; the merge
(upsert + merge equal to a build of the whole corpus, retirement,
mutations racing the build, a failed merge abandoned with the breaker
backing off until its probe, the deadline, the recall floor, duplicate
rows, the pre-warm at the served request, a concurrent merge call, a
torn tail across the rotation, the thresholds); the ops surface; the
device rule. Against the JAX package: the same mutations on the
brute-force family give equal results and byte-equal WAL, snapshot and
manifest files, and a directory the JAX package wrote, for each family,
recovered by the port answers as JAX's recovered index does.

Tolerances. Integer-valued rows and queries: every distance is an exact
float32 integer and ties go the same way in both packages (lower row,
then the sealed part before the delta), so brute force, IVF-Flat (every
list probed; JAX ``algo="xla"``) and CAGRA (gather engine, float32
candidates, JAX's random seed rows injected) give equal values and ids.
IVF-PQ decodes through its codebooks: ``assert_knn_close`` at rtol 1e-4,
ids on >= 98% of rows (``tests/test_torch_ivf_pq.py``'s contract), both
at ``lut_dtype=float32``.
"""
import os
import pathlib
import re
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raft_tpu_torch
from raft_tpu.core import faults as jfaults
from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.neighbors import ivf_flat as jivf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import mutable as jmut
from raft_tpu.ops import filter_policy as jfp
from raft_tpu.ops import guarded as jguarded
from raft_tpu_torch.core import faults, wal
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq
from raft_tpu_torch.neighbors import mutable
from raft_tpu_torch.ops import autotune
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)
CPU = {"device": "cpu"}


@pytest.fixture(scope="module", autouse=True)
def _verdicts_in_memory():
    """No autotune verdict file: this module's CAGRA verdicts stay in
    memory, and none is read from the user's cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAFT_TPU_TORCH_AUTOTUNE_CACHE", "")
        mp.setattr(autotune, "_MEM_CACHE", {})
        mp.setattr(autotune, "_LOADED_FROM", None)
        yield


def test_verdicts_stay_in_memory():
    assert autotune.cache_path() is None


def _corpus(rng, n, d):
    return rng.normal(size=(n, d)).astype(np.float32)


def _ints(rng, n, d):
    return rng.integers(-4, 5, (n, d)).astype(np.float32)


def _live_ids(m) -> set:
    sealed = set(np.asarray(m._sealed_ids)[m._alive].tolist())
    d = np.asarray(m._d_ids[:m._d_n])[m._d_alive[:m._d_n]]
    return sealed | set(d.tolist())


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


# ------------------------------------------------------------------ basics
def test_upsert_delete_search_vs_reference(tmp_path):
    rng = np.random.default_rng(0)
    X = _corpus(rng, 200, 12)
    m = mutable.create(tmp_path / "i", X, **CPU)
    up = _corpus(rng, 30, 12)
    ids = m.upsert(None, up)
    np.testing.assert_array_equal(ids, np.arange(200, 230))
    assert m.delete([3, 8, 205, 9999]) == 3
    live_v = np.concatenate([np.delete(X, [3, 8], axis=0),
                             np.delete(up, [5], axis=0)])
    live_i = np.concatenate([np.delete(np.arange(200), [3, 8]),
                             np.delete(np.arange(200, 230), [5])])
    q = _corpus(rng, 16, 12)
    rd, ri = brute_force.search(brute_force.build(live_v, **CPU), q, 10)
    md, mi = m.search(q, 10)
    np.testing.assert_array_equal(mi.numpy(), live_i[ri.numpy()])
    np.testing.assert_allclose(md.numpy(), rd.numpy(), rtol=1e-5, atol=1e-5)
    assert (m.size, m.sealed_rows, m.delta_rows, m.tombstones) == (
        227, 198, 29, 2)


def test_delete_then_reinsert_is_exact(tmp_path):
    rng = np.random.default_rng(1)
    X = _corpus(rng, 120, 8)
    m = mutable.create(tmp_path / "i", X, **CPU)
    q = X[17:18]
    assert int(m.search(q, 2)[1][0, 0]) == 17
    m.delete([17])
    assert 17 not in m.search(q, 2)[1].numpy()
    newv = _corpus(rng, 1, 8)
    m.upsert(np.array([17]), newv)
    d2, i2 = m.search(newv, 1)
    assert int(i2[0, 0]) == 17 and float(d2[0, 0]) < 1e-6
    d3, _ = m.search(q, 120)
    assert float(d3[0, 0]) > 1e-3


def test_upsert_overwrite_in_delta(tmp_path):
    rng = np.random.default_rng(2)
    m = mutable.create(tmp_path / "i", dataset=None, dim=8, **CPU)
    v1, v2 = _corpus(rng, 1, 8), _corpus(rng, 1, 8)
    m.upsert(np.array([42]), v1)
    m.upsert(np.array([42]), v2)
    assert m.delta_rows == 1
    d, i = m.search(torch.from_numpy(v2), 1)
    assert int(i[0, 0]) == 42 and float(d[0, 0]) < 1e-6


def test_empty_errors_and_auto_ids_resume(tmp_path):
    rng = np.random.default_rng(3)
    m = mutable.create(tmp_path / "i", dataset=None, dim=8, **CPU)
    with pytest.raises(RaftError):
        m.search(_corpus(rng, 1, 8), 1)
    m.upsert(np.array([100]), _corpus(rng, 1, 8))
    np.testing.assert_array_equal(m.upsert(None, _corpus(rng, 2, 8)),
                                  [101, 102])
    r = mutable.recover(tmp_path / "i", **CPU)
    assert int(r.upsert(None, _corpus(rng, 1, 8))[0]) == 103
    m.delete([100, 101, 102])
    d, i = m.search(_corpus(rng, 2, 8), 3)
    assert (i == -1).all() and torch.isinf(d).all()


def test_make_searcher_wal_bytes_and_filter_refused(tmp_path):
    rng = np.random.default_rng(4)
    X = _corpus(rng, 100, 8)
    m = mutable.create(tmp_path / "i", X, **CPU)
    d, i = mutable.make_searcher(m)(X[:4], 3)
    assert i.shape == (4, 3) and i.dtype == torch.int32
    b0 = m.wal_bytes()
    m.upsert(None, _corpus(rng, 2, 8))
    assert m.wal_bytes() > b0
    with pytest.raises(RaftError, match="filter"):
        m.search(X[:2], 3, filter=Bitset.create(100, **CPU))


def test_create_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is the card")
    rng = np.random.default_rng(5)
    with pytest.raises(RaftError, match="device"):
        mutable.create(tmp_path / "i", _corpus(rng, 20, 4))
    mutable.create(tmp_path / "j", _corpus(rng, 20, 4), **CPU)
    with pytest.raises(RaftError, match="device"):
        mutable.recover(tmp_path / "j")


# ------------------------------------------------------------- tombstones
FAMILY_CASES = [
    ("brute_force", {}, None),
    ("ivf_flat", {"n_lists": 4, "kmeans_n_iters": 2},
     ivf_flat.SearchParams(n_probes=4)),
    ("ivf_pq", {"n_lists": 4, "pq_dim": 4, "pq_bits": 4,
                "kmeans_n_iters": 2}, ivf_pq.SearchParams(n_probes=4)),
    ("cagra-gather", {"graph_degree": 8, "intermediate_graph_degree": 16},
     cagra.SearchParams(itopk_size=32, engine="gather")),
    ("cagra-edge", {"graph_degree": 8, "intermediate_graph_degree": 16},
     cagra.SearchParams(itopk_size=32, engine="edge")),
]


@pytest.mark.parametrize("case", FAMILY_CASES, ids=[c[0] for c in
                                                   FAMILY_CASES])
def test_deleted_id_never_returned(tmp_path, case):
    name, fp, sp = case
    family = name.split("-")[0]
    rng = np.random.default_rng(6)
    X = _corpus(rng, 256, 16)
    m = mutable.create(tmp_path / "i", X, family=family, family_params=fp,
                       **CPU)
    victim = 23
    q = X[victim:victim + 1]
    _, i0 = m.search(q, 5, params=sp)
    assert int(i0[0, 0]) == victim
    runner_up = int(i0[0, 1])
    m.delete([victim])
    assert int(m.search(q, 1, params=sp)[1][0, 0]) != victim
    _, i5 = m.search(q, 5, params=sp)
    assert victim not in i5.numpy()
    if family in ("brute_force", "ivf_flat"):
        assert int(i5[0, 0]) == runner_up
    m.upsert(None, _corpus(rng, 8, 16))
    assert victim not in m.search(q, 5, params=sp)[1].numpy()


# ------------------------------------------------------------ crash drills
def test_crash_site_sweep_matches_drilled_set():
    root = pathlib.Path(raft_tpu_torch.__file__).parent
    found = set()
    for rel in ("neighbors/mutable.py", "core/wal.py"):
        src = (root / rel).read_text()
        found |= set(re.findall(r'faults\.crash\(\s*\n?\s*"([^"]+)"', src))
        if re.search(r"faults\.crash\(APPEND_SITE\)", src):
            found.add(wal.APPEND_SITE)
    assert found == set(mutable.CRASH_POINTS) == set(jmut.CRASH_POINTS)


@pytest.mark.parametrize("site", mutable.CRASH_POINTS)
def test_kill_at_site_then_recover(tmp_path, site):
    rng = np.random.default_rng(7)
    X = _corpus(rng, 120, 8)
    p = tmp_path / "i"
    m = mutable.create(p, X, **CPU)
    acked_v = _corpus(rng, 3, 8)
    m.upsert(np.array([500, 501, 502]), acked_v)
    m.delete([5, 501])
    with pytest.raises(faults.InjectedCrash):
        with faults.inject("crash_point", site, count=1):
            if site.startswith("mutable.merge"):
                m.merge()
            else:
                m.upsert(np.array([900]), _corpus(rng, 1, 8))
    r = mutable.recover(p, **CPU)
    live = _live_ids(r)
    assert {500, 502} <= live and 501 not in live and 5 not in live
    d, i = r.search(acked_v[0:1], 1)
    assert int(i[0, 0]) == 500 and float(d[0, 0]) < 1e-6
    assert 5 not in r.search(X[5:6], 5)[1].numpy()
    assert sorted(os.listdir(p)) == sorted(
        ["MANIFEST", r._snap_name(r.generation), r._seg_name(r.generation),
         *r._wal_names])


def test_wal_torn_tail_drill(tmp_path):
    rng = np.random.default_rng(8)
    p = tmp_path / "i"
    m = mutable.create(p, _corpus(rng, 100, 8), **CPU)
    m.upsert(np.array([700]), _corpus(rng, 1, 8))
    with pytest.raises(faults.InjectedCrash):
        with faults.inject("wal_torn_tail", wal.APPEND_SITE, count=1):
            m.upsert(np.array([701]), _corpus(rng, 1, 8))
    wal_path = str(p / m._wal_names[-1])
    assert wal.replay(wal_path)[1] > 0
    r = mutable.recover(p, **CPU)
    assert 700 in _live_ids(r) and 701 not in _live_ids(r)
    assert wal.replay(wal_path)[1] == 0
    r.upsert(np.array([702]), _corpus(rng, 1, 8))
    assert 702 in _live_ids(mutable.recover(p, **CPU))


def test_corrupt_segment_rebuilt_from_snapshot(tmp_path):
    rng = np.random.default_rng(9)
    X = _corpus(rng, 100, 8)
    p = tmp_path / "i"
    m = mutable.create(p, X, **CPU)
    seg = p / m._seg_name(m.generation)
    raw = bytearray(seg.read_bytes())
    raw[len(raw) // 2] ^= 0x01
    seg.write_bytes(bytes(raw))
    r = mutable.recover(p, **CPU)
    assert r.sealed_rows == 100
    np.testing.assert_array_equal(r.search(X[:3], 1)[1][:, 0].numpy(),
                                  [0, 1, 2])
    brute_force.load(seg, **CPU)          # rewritten whole


# ---------------------------------------------------------------- the merge
def test_upsert_merge_equals_build_bit_exact(tmp_path):
    rng = np.random.default_rng(10)
    X = _corpus(rng, 300, 16)
    up = _corpus(rng, 40, 16)
    m = mutable.create(tmp_path / "i", X, **CPU)
    m.upsert(None, up)
    q = _corpus(rng, 12, 16)
    _, i_pre = m.search(q, 10)
    assert m.merge() == "committed"
    d_post, i_post = m.search(q, 10)
    assert torch.equal(i_pre, i_post)
    rd, ri = brute_force.search(
        brute_force.build(np.concatenate([X, up]), **CPU), q, 10)
    assert torch.equal(i_post, ri)
    np.testing.assert_allclose(d_post.numpy(), rd.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_merge_folds_retires_and_records(tmp_path):
    rng = np.random.default_rng(11)
    p = tmp_path / "i"
    m = mutable.create(p, _corpus(rng, 150, 8), **CPU)
    m.upsert(None, _corpus(rng, 10, 8))
    m.delete([0, 1])
    wal_before = m.wal_bytes()
    gen0 = m.generation
    assert m.merge() == "committed"
    assert m.generation == gen0 + 1
    assert (m.delta_rows, m.tombstones, m.sealed_rows) == (0, 0, 158)
    assert m.wal_bytes() < wal_before
    names = set(os.listdir(p))
    assert m._seg_name(gen0) not in names and m._snap_name(gen0) not in names
    lm = m.last_merge
    assert lm["verdict"] == "committed" and lm["rows"] == 158
    assert set(lm["stages_s"]) == {"rotate_snapshot", "build", "check",
                                   "prewarm", "write", "flip", "retire"}
    r = mutable.recover(p, **CPU)
    assert (r.generation, r.sealed_rows, r.delta_rows) == (gen0 + 1, 158, 0)


def test_mutations_racing_the_merge(tmp_path):
    rng = np.random.default_rng(12)
    X = _corpus(rng, 150, 8)
    p = tmp_path / "i"
    m = mutable.create(p, X, **CPU)
    m.upsert(None, _corpus(rng, 10, 8))
    mid_new = _corpus(rng, 1, 8)

    def mid_merge():
        m.upsert(np.array([7]), mid_new)
        m.delete([11])
        m.upsert(np.array([800]), mid_new)

    m._after_snapshot_hook = mid_merge
    assert m.merge() == "committed"
    m._after_snapshot_hook = None
    for idx in (m, mutable.recover(p, **CPU)):
        assert 11 not in _live_ids(idx) and {7, 800} <= _live_ids(idx)
        d, i = idx.search(mid_new, 2)
        assert set(i[0].tolist()) == {7, 800} and float(d[0, 0]) < 1e-6
        assert 11 not in idx.search(X[11:12], 5)[1].numpy()


def test_merge_failure_backs_off_then_probes(tmp_path, monkeypatch):
    now = {"t": 0.0}
    monkeypatch.setattr(mutable, "_clock", lambda: now["t"])
    rng = np.random.default_rng(13)
    X = _corpus(rng, 120, 8)
    m = mutable.create(tmp_path / "i", X, **CPU)
    m.upsert(None, _corpus(rng, 6, 8))
    before = m.search(X[:2], 3)
    with faults.inject("io_error", "core.serialize.*"):
        assert m.merge() == "backoff"
    assert m.last_merge["verdict"] == "abandoned"
    assert "io_error" in m.last_merge["reason"]
    b = m.merge_breaker()
    assert b["state"] == "open" and b["next_probe_in_s"] == 30.0
    assert m.delta_rows == 6 and m.generation == 1
    after = m.search(X[:2], 3)
    assert torch.equal(before[0], after[0]) and torch.equal(before[1],
                                                            after[1])
    assert m.merge() == "backoff"                 # no work while open
    assert m.last_merge["verdict"] == "abandoned"
    now["t"] += 31.0
    with faults.inject("io_error", "core.serialize.*"):
        assert m.merge() == "backoff"             # the probe fails
    assert m.merge_breaker()["backoff_s"] == 60.0
    now["t"] += 61.0
    assert m.merge() == "committed"               # the probe commits
    assert m.merge_breaker()["state"] == "closed"
    assert m.delta_rows == 0 and m.generation == 2
    r = mutable.recover(tmp_path / "i", **CPU)
    assert r.generation == 2 and r.sealed_rows == 126


def test_backoff_is_capped(monkeypatch):
    now = {"t": 0.0}
    monkeypatch.setattr(mutable, "_clock", lambda: now["t"])
    monkeypatch.setenv("RAFT_TPU_GUARD_PROBE_AFTER_S", "10")
    monkeypatch.setenv("RAFT_TPU_GUARD_MAX_BACKOFF_S", "25")

    def fail():
        raise RaftError("no")

    breaker = mutable._Breaker()
    assert breaker.call(fail) == "backoff"
    seen = []
    for _ in range(3):
        now["t"] += 100.0
        assert breaker.call(fail) == "backoff"
        seen.append(breaker.snapshot()["backoff_s"])
    assert seen == [20.0, 25.0, 25.0]
    now["t"] += 100.0
    assert breaker.call(lambda: "committed") == "committed"
    assert breaker.snapshot()["state"] == "closed"


def test_deadline_and_recall_floor_abandon(tmp_path):
    rng = np.random.default_rng(14)
    m = mutable.create(tmp_path / "i", _corpus(rng, 120, 8), **CPU)
    m.upsert(None, _corpus(rng, 4, 8))
    assert m.merge(deadline_s=1e-9) == "backoff"
    assert "deadline" in m.last_merge["reason"]
    assert m.generation == 1 and m.delta_rows == 4
    m._breaker = mutable._Breaker()
    m.merge_recall_floor = 1.1
    assert m.merge() == "backoff"
    assert "recall" in m.last_merge["reason"]
    m._breaker = mutable._Breaker()
    m.merge_recall_floor = 0.9
    assert m.merge() == "committed"


def test_duplicate_vectors_still_merge(tmp_path):
    rng = np.random.default_rng(15)
    base = _corpus(rng, 60, 8)
    m = mutable.create(tmp_path / "i", np.concatenate([base, base]), **CPU)
    m.upsert(None, base[:8])
    assert m.merge() == "committed"
    assert m.last_merge["merge_recall"] == 1.0


def test_prewarm_searches_the_served_request(tmp_path):
    rng = np.random.default_rng(16)
    X = _corpus(rng, 100, 8)
    m = mutable.create(tmp_path / "i", X, **CPU)
    m.upsert(None, _corpus(rng, 4, 8))
    calls = []
    orig = m._search_sealed

    def spy(idx, q, k, params, filt, opts):
        calls.append((tuple(q.shape), k, dict(opts)))
        return orig(idx, q, k, params, filt, opts)

    m._search_sealed = spy
    m.search(X[:6], 3, algo="matmul")
    calls.clear()
    assert m.merge() == "committed"
    warm = [(s, k) for s, k, o in calls if o.get("algo") == "matmul"]
    assert warm and warm[-1] == ((6, 8), 3)


def test_concurrent_merge_call_keeps_the_flag(tmp_path):
    rng = np.random.default_rng(17)
    m = mutable.create(tmp_path / "i", _corpus(rng, 60, 8), **CPU)
    m._merging = True
    assert m._merge_once(None) == "in_progress"
    assert m._merging is True
    m._merging = False


def test_torn_unacked_tail_survives_rotation(tmp_path):
    rng = np.random.default_rng(18)
    p = tmp_path / "i"
    m = mutable.create(p, _corpus(rng, 80, 8), **CPU)
    m.upsert(np.array([300]), _corpus(rng, 1, 8))
    m._wal._f.write(struct.pack("<I", 999) + b"torn")
    m._wal._f.flush()
    with pytest.raises(faults.InjectedCrash):
        with faults.inject("crash_point", "mutable.merge.build", count=1):
            m.merge()
    assert 300 in _live_ids(mutable.recover(p, **CPU))


def test_maintenance_thresholds(tmp_path, monkeypatch):
    rng = np.random.default_rng(19)
    m = mutable.create(tmp_path / "i", _corpus(rng, 100, 8), **CPU)
    m.merge_rows = 5
    assert m.maintenance() is None
    m.upsert(None, _corpus(rng, 6, 8))
    assert m.should_merge()
    assert m.maintenance() == "committed"
    assert not m.should_merge()
    m.delete(np.arange(30))
    assert m.should_merge()                         # 30% tombstoned
    monkeypatch.setenv("RAFT_TPU_MUTABLE_MERGE_ROWS", "7")
    monkeypatch.setenv("RAFT_TPU_MUTABLE_MERGE_RECALL_FLOOR", "x")
    m2 = mutable.create(tmp_path / "j", _corpus(rng, 10, 8), **CPU)
    assert (m2.merge_rows, m2.merge_recall_floor) == (7, 0.9)


def test_ops_snapshot_and_health(tmp_path):
    rng = np.random.default_rng(20)
    m = mutable.create(tmp_path / "ops-drill-idx", _corpus(rng, 90, 8),
                       **CPU)
    m.upsert(None, _corpus(rng, 3, 8))
    m.delete([2])
    ent = mutable.ops_snapshot()["indexes"][m.name]
    assert (ent["delta_rows"], ent["tombstones"], ent["generation"]) == (
        3, 1, 1)
    assert ent["wal_bytes"] > 0 and ent["merge_breaker"] == "closed"
    rep = mutable.health(m)
    assert rep["family"] == "mutable" and rep["n"] == 92
    assert rep["sealed"]["family"] == "brute_force"


# ---------------------------------------------------- against the JAX package
def _jax_seeds(monkeypatch):
    def draw(m, n_seeds, high, seed, device):
        r = jax.random.randint(jax.random.key(seed), (m, n_seeds), 0, high)
        return torch.from_numpy(np.array(r)).to(device)

    monkeypatch.setattr(cagra, "_draw_seeds", draw)


def test_same_mutations_give_jax_results_and_bytes(tmp_path):
    """The same create, upserts, deletes and merge on the brute-force
    family in both packages: equal searches and byte-equal WAL, snapshot
    and manifest files at each generation."""
    rng = np.random.default_rng(21)
    X = _ints(rng, 200, 12)
    ups = [_ints(rng, 20, 12) for _ in range(3)]
    q = _ints(rng, 10, 12)
    pj, pt = tmp_path / "jax", tmp_path / "port"
    jm = jmut.create(pj, X)
    tm = mutable.create(pt, X, **CPU)

    def same_files(*names):
        for n in names:
            assert (pj / n).read_bytes() == (pt / n).read_bytes(), n

    def same_search(k):
        jd, ji = jm.search(jnp.asarray(q), k)
        td, ti = tm.search(q, k)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    for m in (jm, tm):
        m.upsert(None, ups[0])
        m.delete([3, 8, 205, 9999])
        m.upsert(np.array([3, 500, 501]), ups[1][:3])
    same_files("MANIFEST", "snapshot-000001.idx", "wal-000001.log")
    same_search(7)
    same_search(40)
    try:
        assert jm.merge() == tm.merge() == "committed"
    finally:
        jguarded.reset()
    same_files("MANIFEST", "snapshot-000002.idx")
    for m in (jm, tm):
        m.upsert(None, ups[2])
        m.delete([0, 501])
    same_files("MANIFEST", "wal-000002.log")
    same_search(7)
    # each package recovers the other's directory
    tj = mutable.recover(pj, **CPU)
    jt = jmut.recover(pt)
    td, ti = tj.search(q, 7)
    jd, ji = jt.search(jnp.asarray(q), 7)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


JAX_DIRS = [
    ("brute_force", {}, None, None, "ints"),
    ("ivf_flat", {"n_lists": 4, "kmeans_n_iters": 2},
     jivf.SearchParams(n_probes=4), ivf_flat.SearchParams(n_probes=4),
     "ints"),
    ("ivf_pq", {"n_lists": 4, "pq_dim": 4, "pq_bits": 4,
                "kmeans_n_iters": 2},
     jpq.SearchParams(n_probes=4, lut_dtype=jnp.float32),
     ivf_pq.SearchParams(n_probes=4, lut_dtype="float32"), "gauss"),
    ("cagra", {"graph_degree": 8, "intermediate_graph_degree": 16},
     jcagra.SearchParams(itopk_size=16, search_width=1, max_iterations=6,
                         candidate_dtype="float32", engine="gather"),
     cagra.SearchParams(itopk_size=16, search_width=1, max_iterations=6,
                        candidate_dtype="float32", engine="gather"),
     "ints"),
]


@pytest.mark.parametrize("case", JAX_DIRS, ids=[c[0] for c in JAX_DIRS])
def test_jax_written_directory_recovers_in_the_port(tmp_path, monkeypatch,
                                                    case):
    """A directory the JAX package wrote (create, upserts, deletes, a
    merge, more mutations after it) recovered by the port answers as
    JAX's own recovered index does."""
    family, fp, jsp, tsp, kind = case
    _jax_seeds(monkeypatch)
    rng = np.random.default_rng(22)
    make = _ints if kind == "ints" else _corpus
    X, q = make(rng, 300, 16), make(rng, 12, 16)
    p = tmp_path / family
    jm = jmut.create(p, X, family=family, family_params=fp)
    jm.upsert(None, make(rng, 10, 16))
    jm.delete([1, 2, 3, 305])
    try:
        assert jm.merge() == "committed"
    finally:
        jguarded.reset()
    jm.upsert(np.array([7, 900]), make(rng, 2, 16))
    jm.delete([10, 301])
    opts = {"algo": "xla"} if family.startswith("ivf") else {}
    jr = jmut.recover(p)
    with jfp.suspended():
        jd, ji = jr.search(jnp.asarray(q), 5, jsp, **opts)
    tr = mutable.recover(p, **CPU)
    assert (tr.generation, tr.sealed_rows, tr.delta_rows, tr.tombstones) == (
        jr.generation, jr.sealed_rows, jr.delta_rows, jr.tombstones)
    td, ti = tr.search(q, 5, tsp)
    if family == "ivf_pq":
        assert_knn_close(torch.from_numpy(np.array(jd)),
                         torch.from_numpy(np.array(ji)), td, ti, rtol=1e-4,
                         min_rows_equal=0.98)
    else:
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
