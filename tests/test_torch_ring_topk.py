"""The port's cross-shard merge (``raft_tpu_torch.ops.ring_topk`` over
``raft_tpu_torch.comms``) against the JAX package's, on the CPU.

``merge_step`` (the plain K7) is held against JAX's ``merge_step`` with
the ``lax.sort`` fold (``engine="xla"``) and with the Pallas fold in
interpret mode (``engine="pallas"``): distances, positions and ids equal
exactly. ``merge`` with each engine — allgather, ring (the plain K7 a
hop) and ring_pallas (K8's plain version) — over p = 8 CPU shards is held
against JAX's ``knn_merge_parts`` and JAX's ring engine under
``shard_map`` on the 8-device CPU mesh, on JAX's own fixture: exact
cross-shard ties and a dead shard's (+inf, -1) block. Every comparison
is exact: a merge moves values, it computes none. JAX's ``ring_pallas``
needs remote DMA between TPU chips and cannot run on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.ops import ring_topk as jrt
from raft_tpu.utils import shard_map_compat
from raft_tpu_torch.comms import AxisComms, Mesh
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.ops import ring_topk

torch.set_num_threads(1)

INF = np.float32(np.inf)


def _step_case(seed, m, w1, w2, select_min, ties, nonfinite, run_above):
    """(run_d, run_pos, run_gid, blk_d, blk_pos, blk_gid), unsorted, with
    unique positions."""
    rng = np.random.default_rng(seed)
    rd = rng.integers(-6, 7, (m, w1)).astype(np.float32)
    bd = rng.integers(-6, 7, (m, w2)).astype(np.float32)
    if not ties:
        rd += rng.standard_normal((m, w1)).astype(np.float32)
        bd += rng.standard_normal((m, w2)).astype(np.float32)
    if nonfinite:
        rd[rng.random((m, w1)) < 0.2] = INF
        bd[rng.random((m, w2)) < 0.2] = INF
        bd[0, : w2 // 2] = -INF
        rd[1, :] = INF
    if not select_min:
        rd, bd = -rd, -bd
    rp = np.empty((m, w1), np.int32)
    bp = np.empty((m, w2), np.int32)
    for row in range(m):       # other unique positions in every row
        pos = rng.permutation(w1 + w2 + 50)[: w1 + w2].astype(np.int32)
        if run_above:          # the ring's hop 0: the block precedes
            pos = np.sort(pos)[::-1]
            pos = np.concatenate([rng.permutation(pos[:w1]),
                                  rng.permutation(pos[w1:])])
        rp[row], bp[row] = pos[:w1], pos[w1:]
    rg = rng.integers(0, 10_000, (m, w1)).astype(np.int32)
    bg = rng.integers(0, 10_000, (m, w2)).astype(np.int32)
    return rd, rp, rg, bd, bp, bg


STEP_CASES = {
    "ties": dict(m=9, w1=7, w2=7, k=7, ties=True, nonfinite=False,
                 run_above=False),
    "w1_ne_w2": dict(m=6, w1=5, w2=11, k=9, ties=True, nonfinite=False,
                     run_above=False),
    "k_lt_w": dict(m=5, w1=12, w2=4, k=3, ties=False, nonfinite=False,
                   run_above=False),
    "nonfinite": dict(m=7, w1=6, w2=9, k=12, ties=True, nonfinite=True,
                      run_above=False),
    "run_above": dict(m=8, w1=7, w2=7, k=7, ties=True, nonfinite=True,
                      run_above=True),
}


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_merge_step_matches_jax(case, select_min):
    c = dict(STEP_CASES[case])
    k = c.pop("k")
    args = _step_case(1, select_min=select_min, **c)
    got = ring_topk.merge_step(*map(torch.from_numpy, args), k,
                               select_min=select_min)
    jargs = tuple(map(jnp.asarray, args))
    for engine, kw in (("xla", {}), ("pallas", {"interpret": True})):
        want = jrt.merge_step(*jargs, k, select_min=select_min,
                              engine=engine, **kw)
        for a, b in zip(want, got):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=engine)


def test_merge_step_contract():
    """Best first under (key, position); the running list need not come
    first in position, and a tie of key goes to the lower position."""
    run_d = torch.tensor([[1.0, 3.0]])
    blk_d = torch.tensor([[1.0, 0.5]])
    run_p = torch.tensor([[10, 11]], dtype=torch.int32)
    blk_p = torch.tensor([[2, 3]], dtype=torch.int32)
    g = torch.tensor([[100, 101]], dtype=torch.int32)
    d, p, i = ring_topk.merge_step(run_d, run_p, g, blk_d, blk_p, g + 2, 3)
    assert d.tolist() == [[0.5, 1.0, 1.0]]
    assert p.tolist() == [[3, 2, 10]] and i.tolist() == [[103, 102, 100]]
    d, p, i = ring_topk.merge_step(run_d, run_p, g, blk_d, blk_p, g + 2, 2,
                                   select_min=False)
    assert d.tolist() == [[3.0, 1.0]] and i.tolist() == [[101, 102]]


@pytest.fixture(scope="module")
def parts():
    """JAX's fixture (tests/test_ring_topk.py): (p=8, m, k) candidate
    blocks with cross-shard exact ties and one dead shard's (+inf, -1)
    block."""
    rng = np.random.default_rng(0)
    p, m, k = 8, 16, 7
    d = np.sort(rng.standard_normal((p, m, k)).astype(np.float32), axis=-1)
    d[3] = d[1]                      # bit-exact ties across shards
    gid = rng.integers(0, 100_000, size=(p, m, k)).astype(np.int32)
    d[5], gid[5] = np.inf, -1        # dead shard sentinels
    return d, gid


@pytest.fixture(scope="module")
def jax_ring(multichip_mesh, parts):
    """JAX's ring engine under ``shard_map`` on the 8-device CPU mesh, for
    select_min True (on d) and False (on -d), in one program."""
    d, gid = parts
    spec = NamedSharding(multichip_mesh, P("shard", None, None))
    dd = jax.device_put(jnp.asarray(d), spec)
    gg = jax.device_put(jnp.asarray(gid), spec)
    p, _, k = d.shape

    def body(ds, gs):
        lo = jrt.merge(ds[0], gs[0], k, True, axis="shard", axis_size=p,
                       engine="ring")
        hi = jrt.merge(-ds[0], gs[0], k, False, axis="shard", axis_size=p,
                       engine="ring")
        return lo + hi

    f = shard_map_compat(body, mesh=multichip_mesh,
                         in_specs=(P("shard", None, None),) * 2,
                         out_specs=(P(),) * 4, check=False)
    out = [np.asarray(o) for o in f(dd, gg)]
    return {True: out[:2], False: out[2:]}


@pytest.mark.parametrize("select_min", [True, False])
def test_merge_engines_match_jax(parts, jax_ring, select_min):
    d, gid = parts
    d = d if select_min else -d
    p, _, k = d.shape
    want = jbf.knn_merge_parts(jnp.asarray(d), jnp.asarray(gid), select_min)
    for a, b in zip(want, jax_ring[select_min]):   # JAX's engines agree
        np.testing.assert_array_equal(np.asarray(a), b)
    mesh = Mesh(["cpu"] * p)
    ds = [torch.from_numpy(d[r]) for r in range(p)]
    gs = [torch.from_numpy(gid[r]) for r in range(p)]
    for engine in ring_topk.ENGINES:
        out_d, out_g = ring_topk.merge(ds, gs, k, select_min, mesh,
                                       engine=engine)
        assert len(out_d) == len(out_g) == p
        for od, og in zip(out_d, out_g):      # replica-identical
            np.testing.assert_array_equal(od.numpy(), np.asarray(want[0]),
                                          err_msg=engine)
            np.testing.assert_array_equal(og.numpy(), np.asarray(want[1]),
                                          err_msg=engine)
            assert og.dtype == torch.int32


def test_ring_topk_plain_is_the_ring():
    """K8's plain version is the ring with the plain fold, shard for
    shard, also at p = 2 and with unsorted lists."""
    rng = np.random.default_rng(3)
    for p in (2, 3):
        mesh = Mesh(["cpu"] * p)
        ds = [torch.from_numpy(rng.integers(0, 5, (4, 6)).astype(np.float32))
              for _ in range(p)]
        gs = [torch.from_numpy(rng.integers(0, 99, (4, 6)).astype(np.int32))
              for _ in range(p)]
        a = ring_topk.ring_topk(ds, gs, 6, True, mesh)
        b = ring_topk.merge(ds, gs, 6, True, mesh, engine="ring")
        for x, y in zip(a[0] + a[1], b[0] + b[1]):
            assert torch.equal(x, y)


def test_comms_collectives():
    mesh = Mesh(["cpu"] * 3)
    comms = AxisComms(mesh)
    xs = [torch.full((2,), float(r)) for r in range(3)]
    assert comms.get_size() == 3 and comms.get_rank() == [0, 1, 2]
    for g in comms.allgather(xs):
        assert g.shape == (3, 2) and g[:, 0].tolist() == [0.0, 1.0, 2.0]
    assert [x[0].item() for x in comms.device_sendrecv(xs)] == [2.0, 0.0, 1.0]
    assert [x[0].item() for x in comms.device_sendrecv(xs, 2)] == [1.0, 2.0,
                                                                    0.0]
    with pytest.raises(RaftError):
        comms.allgather(xs[:2])


def test_engine_resolution():
    mesh = Mesh(["cpu"] * 4)
    # the CPU default is allgather, as in the JAX package
    assert not ring_topk.ring_capable(8, 5, mesh)
    assert ring_topk.resolve_engine(8, 5, 4, mesh=mesh) == "allgather"
    assert ring_topk.resolve_engine(8, 5, 4, "auto", mesh) == "allgather"
    # an explicit engine is kept: ring_pallas is not demoted to ring
    for eng in ring_topk.ENGINES:
        assert ring_topk.resolve_engine(8, 5, 4, eng, mesh) == eng
    assert ring_topk.resolve_engine(8, 5, 1, "ring", mesh) == "allgather"
    with pytest.raises(RaftError, match="merge engine"):
        ring_topk.resolve_engine(8, 5, 4, "bogus", mesh)
    ds = [torch.zeros((2, 3))] * 4
    gs = [torch.zeros((2, 3), dtype=torch.int32)] * 4
    with pytest.raises(RaftError, match="not ported"):
        ring_topk.merge(ds, gs, 3, True, mesh, engine="hier")
    with pytest.raises(RaftError):
        ring_topk.merge(ds, gs, 4, True, mesh)   # lists are (m, 3)
    assert ring_topk.per_hop_bytes(10, 4) == jrt.per_hop_bytes(10, 4)
    assert ring_topk.gathered_bytes(10, 4, 8) == jrt.gathered_bytes(10, 4, 8)


def test_cuda_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RaftError):
        Mesh(["cuda"] * 2)


def test_default_engine_keeps_k8_on_one_card(monkeypatch):
    """Where K8 could run, the default takes it only when every shard
    shares one card: its cross-card mode is reached by an explicit
    ring_pallas alone. No card is touched: the mesh is built with CUDA
    reported present and ring_capable held true."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(ring_topk, "ring_capable", lambda m, k, mesh: True)
    one = Mesh(["cuda:0"] * 4)
    two = Mesh(["cuda:0", "cuda:1"] * 2)
    assert ring_topk.resolve_engine(8, 5, 4, mesh=one) == "ring_pallas"
    assert ring_topk.resolve_engine(8, 5, 4, "auto", two) == "allgather"
    assert ring_topk.resolve_engine(8, 5, 4, mesh=two) == "allgather"
    assert ring_topk.resolve_engine(8, 5, 4, "ring_pallas",
                                    two) == "ring_pallas"


# --------------------------------------------------------------------------
# K8's fold, stated in numpy: sort each shard's own list once by
# (order key, index), then merge sorted lists by binary-search ranks
# (csrc/ring_topk.cu::ring_kernel, lexfold::warp_sort_pairs and
# lexfold::warp_merge_ranks)
# --------------------------------------------------------------------------

def _order_key(d):
    """The float's place in the sort order as an int (lexfold::order_key):
    -0.0 as 0.0, every NaN after +inf, otherwise the IEEE order."""
    i = np.ascontiguousarray(d, np.float32).view(np.int32).astype(np.int64)
    key = np.where(i < 0, i ^ 0x7FFFFFFF, i)
    key = np.where(i == -(1 << 31), 0, key)
    return np.where(np.isnan(d), (1 << 31) - 1, key)


def _merge_ranks(a_key, a_pos, b_key, b_pos):
    """Ranks of two lists sorted by (key, position), with no position in
    common, in their merge: each cell's index plus a binary-search count
    of the other list's cells before it."""
    a = a_key * (1 << 31) + a_pos          # (key, position) as one int
    b = b_key * (1 << 31) + b_pos
    return (np.arange(len(a)) + np.searchsorted(b, a, "left"),
            np.arange(len(b)) + np.searchsorted(a, b, "left"))


def k8_fold(ds, gids, k, select_min, hops=None):
    """The ring of K8 on numpy (m, k) lists → per shard the running list
    (distances, ids, positions) after ``hops`` hops (all p − 1 by
    default). Each shard's list is sorted once by (order key, index); a
    cell then carries (its shard)·k + (its index in that sorted list) as
    its position, which orders cells as their true positions do."""
    p = len(ds)
    sign = np.float32(1 if select_min else -1)
    srt = []
    for d, g in zip(ds, gids):
        order = np.argsort(_order_key(sign * d), axis=1, kind="stable")
        srt.append((np.take_along_axis(d, order, 1),
                    np.take_along_axis(g, order, 1)))
    slots = np.arange(k)
    run = [(d.copy(), g.copy(), np.broadcast_to(r * k + slots, d.shape))
           for r, (d, g) in enumerate(srt)]
    for h in range(p - 1 if hops is None else hops):
        for r in range(p):
            src = (r - 1 - h) % p
            (rd, rg, rp), (bd, bg) = run[r], srt[src]
            out = [np.empty(t.shape, t.dtype) for t in run[r]]
            for row in range(rd.shape[0]):
                ra, rb = _merge_ranks(_order_key(sign * rd[row]), rp[row],
                                      _order_key(sign * bd[row]),
                                      src * k + slots)
                for rank, vals in ((ra, (rd[row], rg[row], rp[row])),
                                   (rb, (bd[row], bg[row],
                                         src * k + slots))):
                    keep = rank < k
                    for o, v in zip(out, vals):
                        o[row, rank[keep]] = v[keep]
            run[r] = tuple(out)
    return run


def _fold_fixture(name):
    """(p, m, k) lists: ``ties_dead`` is JAX's fixture (cross-shard exact
    ties, a dead shard); ``negzero_nan`` adds -0.0 against 0.0, NaN and
    ±inf cells; both with shard 0 left unsorted."""
    rng = np.random.default_rng(11)
    p, m, k = 5, 12, 9
    d = rng.integers(-3, 4, (p, m, k)).astype(np.float32)
    d[1:] = np.sort(d[1:], axis=-1)
    d[3] = d[1]
    gid = rng.integers(0, 100_000, (p, m, k)).astype(np.int32)
    d[4], gid[4] = np.inf, -1
    if name == "negzero_nan":
        d[d == 0] = np.where(rng.random(int((d == 0).sum())) < 0.5, 0.0,
                             -0.0)
        d[0][rng.random((m, k)) < 0.15] = np.nan
        d[2][rng.random((m, k)) < 0.15] = np.nan
        d[0][rng.random((m, k)) < 0.1] = -np.inf
        d[2][rng.random((m, k)) < 0.1] = np.inf
    return d, gid


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("fixture", ["ties_dead", "negzero_nan"])
def test_k8_fold_is_the_ring_hop_by_hop(fixture, select_min):
    """After every hop the numpy fold's running list equals the plain
    ring's (merge_step_plain a hop): distances bit for bit (-0.0 kept,
    NaN where NaN), ids, and the origin shard of each cell (its position
    // k)."""
    d, gid = _fold_fixture(fixture)
    d = d if select_min else -d
    p, m, k = d.shape
    mesh = Mesh(["cpu"] * p)
    ds = [torch.from_numpy(d[r]) for r in range(p)]
    gs = [torch.from_numpy(gid[r]) for r in range(p)]
    for hops in range(p):
        steps = []

        def step(*args):
            steps.append(ring_topk.merge_step_plain(*args))
            return steps[-1]

        comms = AxisComms(mesh)
        # the ring, stopped after ``hops`` hops
        slots = torch.arange(k, dtype=torch.int32).repeat(m, 1)
        state = [(ds[r], r * k + slots, gs[r]) for r in range(p)]
        send_d, send_g = list(ds), list(gs)
        for h in range(hops):
            recv_d = comms.device_sendrecv(send_d, 1)
            recv_g = comms.device_sendrecv(send_g, 1)
            for r in range(p):
                src = (r - (h + 1)) % p
                state[r] = step(*state[r], recv_d[r], src * k + slots,
                                recv_g[r], k, select_min)
            send_d, send_g = recv_d, recv_g
        want = state if hops else [
            ring_topk.merge_step_plain(ds[r], r * k + slots, gs[r],
                                       ds[r][:, :0], slots[:, :0],
                                       gs[r][:, :0], k, select_min)
            for r in range(p)]
        got = k8_fold(d, gid, k, select_min, hops)
        for (wd, wp, wg), (fd, fg, fs) in zip(want, got):
            np.testing.assert_array_equal(wd.numpy().view(np.int32),
                                          fd.view(np.int32))
            np.testing.assert_array_equal(wg.numpy(), fg)
            np.testing.assert_array_equal(wp.numpy() // k, fs // k)


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("fixture", ["ties_dead", "negzero_nan"])
def test_k8_fold_matches_plain_ring_and_merge_parts(fixture, select_min):
    """The fold's result, on every shard, equals K8's plain version and
    knn_merge_parts over the concatenation (NaN cells excepted from the
    latter: select_k drops NaN, the ring orders it after +inf)."""
    d, gid = _fold_fixture(fixture)
    d = d if select_min else -d
    p, m, k = d.shape
    ds = [torch.from_numpy(d[r]) for r in range(p)]
    gs = [torch.from_numpy(gid[r]) for r in range(p)]
    pd, pg = ring_topk.ring_topk_plain(ds, gs, k, select_min,
                                       Mesh(["cpu"] * p))
    got = k8_fold(d, gid, k, select_min)
    for r, (fd, fg, _) in enumerate(got):
        np.testing.assert_array_equal(pd[r].numpy().view(np.int32),
                                      fd.view(np.int32))
        np.testing.assert_array_equal(pg[r].numpy(), fg)
    if fixture == "ties_dead":
        from raft_tpu_torch.neighbors import brute_force as tbf

        want = tbf.knn_merge_parts(torch.from_numpy(d), torch.from_numpy(gid),
                                   select_min)
        np.testing.assert_array_equal(want[0].numpy(), got[0][0])
        np.testing.assert_array_equal(want[1].numpy(), got[0][1])


@pytest.mark.parametrize("select_min", [True, False])
def test_k8_fold_matches_jax_ring(parts, jax_ring, select_min):
    """On JAX's fixture (p = 8, ties across shards, a dead shard) the fold
    gives JAX's ring result on every shard."""
    d, gid = parts
    d = d if select_min else -d
    k = d.shape[2]
    want = jax_ring[select_min]
    for fd, fg, _ in k8_fold(d, gid, k, select_min):
        np.testing.assert_array_equal(fd, want[0])
        np.testing.assert_array_equal(fg, want[1])


@pytest.mark.parametrize("m,k,p,per_card,cap,want", [
    (10_000, 10, 4, 4, 2112, (527, 19, 3)),
    (10_000, 100, 8, 8, 1056, (132, 76, 7)),
    (10_000, 10, 16, 16, 2112, (132, 76, 15)),
    (1, 10, 4, 4, 2112, (1, 1, 3)),
    (3, 1024, 2, 2, 264, (3, 1, 1)),
    (100, 10, 4, 4, 2112, (100, 1, 3)),
    (1001, 31, 3, 1, 2112, (1001, 1, 2)),
    (1001, 31, 3, 3, 2112, (501, 2, 2)),
])
def test_ring_plan(m, k, p, per_card, cap, want):
    """K8's launch shape: no block without rows, every row owned, one row
    range a block through p − 1 steps, slots (2, m, k) a shard."""
    plan = ring_topk.ring_plan(m, k, p, per_card, cap)
    assert (plan.blocks, plan.rows, plan.steps) == want
    assert plan.slot_shape == (2, m, k)
    assert plan.blocks * plan.rows >= m > (plan.blocks - 1) * plan.rows
    assert plan.blocks * per_card <= cap


def test_ring_plan_refuses_a_card_without_room():
    with pytest.raises(RaftError):
        ring_topk.ring_plan(10, 10, 4, 4, 3)


@pytest.mark.parametrize("select_min", [True, False])
def test_k8_fold_matches_jax_ring_negzero_nan(multichip_mesh, select_min):
    """On the -0.0 / NaN / ±inf fixture widened to 8 shards, JAX's ring
    under ``shard_map`` and the fold agree bit for bit on every shard."""
    d, gid = _fold_fixture("negzero_nan")
    d = np.concatenate([d, d[:3]]) if select_min else -np.concatenate(
        [d, d[:3]])
    gid = np.concatenate([gid, gid[:3]])
    p, _, k = d.shape
    spec = NamedSharding(multichip_mesh, P("shard", None, None))

    def body(ds, gs):
        return jrt.merge(ds[0], gs[0], k, select_min, axis="shard",
                         axis_size=p, engine="ring")

    f = shard_map_compat(body, mesh=multichip_mesh,
                         in_specs=(P("shard", None, None),) * 2,
                         out_specs=(P(),) * 2, check=False)
    jd, jg = (np.asarray(o) for o in f(
        jax.device_put(jnp.asarray(d), spec),
        jax.device_put(jnp.asarray(gid), spec)))
    for fd, fg, _ in k8_fold(d, gid, k, select_min):
        np.testing.assert_array_equal(jd.view(np.int32), fd.view(np.int32))
        np.testing.assert_array_equal(jg, fg)
