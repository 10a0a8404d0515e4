"""The one-launch CAGRA traversal of the PyTorch port (the plain version
of kernel K6, ``max_iter`` edge hops on the plain K5) against
``raft_tpu.ops.cagra_fused.fused_traverse`` with its Pallas kernel in
interpret mode, from the same seeded buffer over an edge store built by
``raft_tpu``; and the port's fused engine against its edge engine.

Tolerances: integer-valued data and queries make every score an exact
float32 integer, so the buffers are equal, ties included. On Gaussian
data the scores are float32 sums in another order than XLA's:
``assert_knn_close`` (values to rtol 1e-5, ids on >= 99% of rows). The
port's fused and edge engines compute the same values by construction
(the same plain K5 on the CPU), so their results are equal. The same
holds over int4 stores (K6's int4 form against JAX's ``fused_traverse(
mode="int4")`` on JAX's int4 store, exact on integer-valued data).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops.cagra_fused import fused_traverse as jax_fused_traverse
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.matrix.select_k import select_k_plain
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import cagra_fused as tcf
from raft_tpu_torch.ops import graph_expand as tge
from test_torch_graph_expand import key_value, sort_key
from test_torch_kernels import assert_knn_close, edge_store

torch.set_num_threads(1)

N, D, DEG, M, ITOPK, KPRIME, HOPS = 700, 16, 24, 16, 16, 16, 3


def _case(integer: bool, penalty: bool, seed: int, store: str = "int8"):
    """A JAX edge store (``store``: int8 or int4) over a random graph,
    queries, an optional edge penalty, and a seeded buffer: the exact
    distances of ITOPK distinct random rows, sorted, with a +inf tail."""
    rng = np.random.default_rng(seed)
    gen = ((lambda s: rng.integers(-4, 5, s)) if integer
           else rng.standard_normal)
    x = gen((N, D)).astype(np.float32)
    q = gen((M, D)).astype(np.float32)
    graph = rng.integers(0, N, (N, DEG)).astype(np.int32)
    jidx = jcagra.Index(jnp.asarray(x), jnp.asarray(graph),
                        jcagra.DistanceType.L2Expanded)
    jcagra.prepare_traversal(jidx, store)
    _, ev, aux, gp, _ = jidx._edge_store
    pen = None
    if penalty:
        pen = np.where(rng.random(gp.shape) < 0.3, np.inf, 0.0).astype(
            np.float32)
    ids = np.stack([rng.permutation(N)[:ITOPK] for _ in range(M)])
    d = ((x[ids] - q[:, None, :]) ** 2).sum(-1)
    order = np.argsort(d, axis=1, kind="stable")
    buf_d = np.take_along_axis(d, order, 1).astype(np.float32)
    buf_i = np.take_along_axis(ids, order, 1).astype(np.int32)
    buf_d[:, -2:] = np.inf
    return q, ev, aux, gp, pen, buf_d, buf_i


@pytest.mark.parametrize("width,penalty", [(1, False), (2, True)])
def test_fused_traverse_plain_matches_jax(width, penalty):
    for integer in (False, True):
        q, ev, aux, gp, pen, buf_d, buf_i = _case(integer, penalty, width)
        kw = dict(itopk=ITOPK, width=width, max_iter=HOPS, kprime=KPRIME,
                  degree=DEG)
        jd, ji = jax_fused_traverse(
            jnp.asarray(q), jnp.asarray(buf_d), jnp.asarray(buf_i), ev, aux,
            gp, None if pen is None else jnp.asarray(pen), **kw)
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        td, ti = tcf.fused_traverse(
            t(q), t(buf_d), t(buf_i), t(ev), t(aux), t(gp),
            None if pen is None else t(pen), **kw)
        assert td.shape == (M, ITOPK) and ti.dtype == torch.int32
        if integer:
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        else:
            assert_knn_close(np.asarray(jd), np.asarray(ji), td.numpy(),
                             ti.numpy())


@pytest.mark.parametrize("width,penalty,metric", [(1, True, "l2"),
                                                  (2, False, "ip")])
def test_fused_traverse_plain_int4_matches_jax(width, penalty, metric):
    """K6's int4 form (its plain version) against JAX's on JAX's int4
    store: equal buffers on integer-valued data, ``assert_knn_close`` on
    Gaussian data."""
    for integer in (True, False):
        q, ev, aux, gp, pen, buf_d, buf_i = _case(integer, penalty,
                                                  width + 10, "int4")
        assert ev.shape[2] == 64                  # half_p: dim_p 128
        kw = dict(itopk=ITOPK, width=width, max_iter=HOPS, kprime=KPRIME,
                  degree=DEG, metric=metric)
        jd, ji = jax_fused_traverse(
            jnp.asarray(q), jnp.asarray(buf_d), jnp.asarray(buf_i), ev, aux,
            gp, None if pen is None else jnp.asarray(pen), mode="int4", **kw)
        t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
        args = (t(q), t(buf_d), t(buf_i), t(ev), t(aux), t(gp),
                None if pen is None else t(pen))
        td, ti = tcf.fused_traverse(*args, mode="int4", **kw)
        if integer:
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
            np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        else:
            assert_knn_close(np.asarray(jd), np.asarray(ji), td.numpy(),
                             ti.numpy())
        # the plain K6 is max_iter plain edge hops over the same store
        be = torch.zeros(buf_d.shape, dtype=torch.bool)
        bd, bi = args[1], args[2]
        for _ in range(HOPS):
            bd, bi, be = tcf.edge_hop(
                args[0], bd, bi, be, *args[3:], width=width, kprime=KPRIME,
                degree=DEG, metric=metric, select=select_k_plain,
                expand=tge.graph_expand_plain, mode="int4")
        assert torch.equal(bd.view(torch.int32), td.view(torch.int32))
        assert torch.equal(bi, ti)


@pytest.fixture(scope="module")
def port_index():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((900, D)).astype(np.float32)
    q = rng.standard_normal((40, D)).astype(np.float32)
    idx = cagra.build(x, cagra.IndexParams(intermediate_graph_degree=32,
                                           graph_degree=DEG), device="cpu")
    cagra.prepare_traversal(idx)
    return idx, torch.from_numpy(q), rng.random(900) < 0.7


@pytest.mark.parametrize("k,itopk,width,filtered", [
    (5, 16, 1, False), (5, 32, 2, False), (5, 16, 2, True),
    (1, 16, 1, False), (1, 1, 1, True)])
def test_fused_engine_equals_edge_engine(port_index, k, itopk, width,
                                         filtered):
    """The port's fused and edge engines return equal ids and distances,
    at width 1 and 2, k' = itopk < degree, under a filter, and at k = 1
    (itopk 1: one candidate per parent)."""
    idx, q, keep = port_index
    sp = cagra.SearchParams(itopk_size=itopk, search_width=width,
                            max_iterations=6)
    filt = Bitset.from_mask(torch.from_numpy(keep)) if filtered else None
    ev, ei = cagra.search(idx, q, k, sp, filter=filt, engine="edge")
    fv, fi = cagra.search(idx, q, k, sp, filter=filt, engine="fused")
    assert torch.equal(ei, fi) and torch.equal(ev, fv)
    found = ei[ei >= 0]
    assert found.numel() > 0 and bool((found < idx.size).all())
    if filtered:
        assert bool(torch.from_numpy(keep)[found.long()].all())


def test_fused_traverse_refuses_int4_store(port_index):
    """K6 takes an int4 store as int8 bytes of dim_p / 2 a row; other
    tiles in int4 mode are refused, and so is any pq store (K6 has no pq
    form)."""
    idx, q, _ = port_index
    st = idx.edge_store
    buf = torch.zeros((q.shape[0], 16))
    kw = dict(itopk=16, width=1, max_iter=1, kprime=16, degree=DEG)
    with pytest.raises(RaftError, match="tiles"):   # W 96: dim_p 192
        tcf.fused_traverse(q, buf, buf.int(), st.vecs[:, :, :96].contiguous(),
                           st.aux, st.gp, mode="int4", **kw)
    with pytest.raises(RaftError, match="no pq form"):
        tcf.fused_traverse(q, buf, buf.int(), st.vecs, st.aux, st.gp,
                           mode="pq", **kw)
    assert not tcf.fused_capable(16, 1, 16, 32, 128, "pq", 4, "cpu")
    assert tcf.fused_capable(16, 1, 16, 32, 128, "int4", 4, "cpu")


@pytest.mark.parametrize("width,filtered", [(1, False), (2, True)])
def test_fused_engine_equals_edge_engine_int4(width, filtered):
    """Over the port's own int4 store, the fused and edge engines return
    equal ids and distances (K6's int4 form and K5's share the scoring)."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((700, D)).astype(np.float32)
    q = torch.from_numpy(rng.standard_normal((24, D)).astype(np.float32))
    idx = cagra.build(x, cagra.IndexParams(intermediate_graph_degree=32,
                                           graph_degree=DEG), device="cpu")
    cagra.prepare_traversal(idx, "int4")
    assert idx.edge_store.vecs.shape == (700, 32, 64)
    sp = cagra.SearchParams(itopk_size=16, search_width=width,
                            max_iterations=6)
    keep = torch.from_numpy(rng.random(700) < 0.7)
    filt = Bitset.from_mask(keep) if filtered else None
    ev, ei = cagra.search(idx, q, 5, sp, filter=filt, engine="edge")
    fv, fi = cagra.search(idx, q, 5, sp, filter=filt, engine="fused")
    assert torch.equal(ei, fi) and torch.equal(ev, fv)
    assert bool((ei >= 0).any())


# --- K6's hop (csrc/cagra_fused.cu) as numpy statements, in the order the
# kernel decides, held hop by hop against the plain edge hop

def merge_lists(ak, ai, bk, bi):
    """The L best cells of two sorted key lists, sorted: C = min(A[n],
    B[L - 1 - n]) (a bitonic sequence), then the bitonic merge — at J =
    L/2 ... 1 the lower cell of (n, n ^ J) keeps the smaller key."""
    rk, ri = bk[::-1], bi[::-1]
    take = rk < ak
    k, i = np.where(take, rk, ak), np.where(take, ri, ai)
    n = np.arange(len(k))
    j = len(k) // 2
    while j:
        ok, oi = k[n ^ j], i[n ^ j]
        sw = np.where((n & j) == 0, ok < k, k < ok)
        k, i = np.where(sw, ok, k), np.where(sw, oi, i)
        j //= 2
    return k, i


def k6_load(bd, bi, itopk, L):
    """K6's load of a seeded buffer (rows in any order) → (cells, ids):
    sort_key(value, slot) for the itopk real cells and all-ones order bits
    above the slot for the pads, so every key is distinct and the pads
    sort after every real cell; each cell's rank is the count of keys
    below its own, and the cell moves there with its id; then cells take
    slots 0 ... again and past itopk become +inf pads — the order in
    which the plain hop picks and folds, (value, buffer position)."""
    m = bd.shape[0]
    cells = np.broadcast_to(np.arange(L), (m, L))
    vals = np.pad(bd.astype(np.float32), ((0, 0), (0, L - itopk)))
    k = np.where(cells < itopk, sort_key(vals, cells),
                 (np.uint64(0xffffffff) << np.uint64(32))
                 | (cells.astype(np.uint64) << np.uint64(2)))
    rank = (k[:, None, :] < k[:, :, None]).sum(-1)
    ids = np.pad(bi.astype(np.int64), ((0, 0), (0, L - itopk)),
                 constant_values=-1)
    sk, si = np.empty_like(k), np.empty_like(ids)
    np.put_along_axis(sk, rank, k, axis=1)
    np.put_along_axis(si, rank, ids, axis=1)
    k = (sk & ~np.uint64(0xfffffffc)) | (cells.astype(np.uint64) << 2)
    ids = si
    pad = sort_key(np.full((m, L), np.inf, np.float32), cells)
    real = cells < itopk
    return np.where(real, k, pad), np.where(real, ids, -1)


def k6_hop(q, bk, bi, vecs, aux, gph, pen, itopk, width, kprime, degree,
           metric):
    """One hop of K6 on numpy rows of cells → (bk, bi). A row's L cells
    (L = 32 · the next power of two of max(itopk, deg_p) / 32) hold
    sort_key(value, slot) with the explored flag in bit 0, and ids; cells
    past itopk are +inf pads. Parents are the first `width` unexplored
    finite cells; each parent's k' best come from the plain K5 (its
    scoring and selection: edge_score.cuh). Of the last parent only the
    ranks below the buffer's last value take part (none: the hop ends).
    A rank that takes part is dropped when its id is in the buffer as it
    stood when the hop began, at an earlier rank of its parent, or among
    an earlier parent's k'. Each parent's survivors keep rank order with
    slot L + concat position and fold into the buffer by
    :func:`merge_lists`, whose cells then take slots 0 ... again (past
    itopk: pads)."""
    m, L = bk.shape
    bk, bi = bk.copy(), bi.copy()
    pad = lambda pos: sort_key(np.full(len(pos), np.inf,  # noqa: E731
                                       np.float32), pos)
    for row in range(m):
        open_ = ((np.arange(L) < itopk) & ((bk[row] & 1) == 0)
                 & ((bk[row] >> 32) < 0xff800000))
        pick = np.flatnonzero(open_)[:width]
        bk[row, pick] |= 1
        held = set(bi[row, :itopk].tolist())     # the buffer, and then the
        for w, p in enumerate(bi[row, pick]):   # earlier parents' k' ids
            pids = torch.tensor([[p]], dtype=torch.int32)
            cv, ce = tge.graph_expand_plain(pids, q[row:row + 1], vecs, aux,
                                            kprime, metric, degree, pen)
            cv, ce = cv[0, 0].numpy(), ce[0, 0].numpy()
            ci = np.where(ce >= 0, gph.numpy()[p, np.maximum(ce, 0)], -1)
            lim = kprime
            if w == len(pick) - 1:
                th = bk[row, itopk - 1] >> np.uint64(32)
                lim = min(lim, int(((sort_key(cv, np.zeros(kprime))
                                     >> np.uint64(32)) < th).sum()))
                if lim == 0:
                    continue
            keep = np.array([j < lim and np.isfinite(cv[j])
                             and ci[j] not in held
                             and ci[j] not in ci[:j] for j in range(kprime)])
            held |= set(ci.tolist())
            cnt = int(keep.sum())
            if cnt == 0:
                continue
            r = np.flatnonzero(keep)
            nk = pad((width + 1) * L + np.arange(L))
            ni = np.full(L, -1, np.int64)
            nk[:cnt] = sort_key(cv[r], L + w * kprime + r)
            ni[:cnt] = ci[r]
            k, i = merge_lists(bk[row], bi[row], nk, ni)
            c = np.arange(L)
            k = (k & ~np.uint64(0xfffffffc)) | (c.astype(np.uint64) << 2)
            k[itopk:], i[itopk:] = pad(c[itopk:]), -1
            bk[row], bi[row] = k, i
    return bk, bi


@pytest.mark.parametrize("deg_p,seed", [(64, 0), (64, 1), (128, 2),
                                        (256, 3)])
def test_k6_sorts_the_keys_under_the_buffer_alone(deg_p, seed):
    """K6's last parent when at most 32 of its edges lie under the
    buffer's last value (cagra_fused.cuh): those keys, gathered in edge
    order one a lane and sorted alone (32 slots, the rest ~0), are the
    full sort's first ranks, ties, -0.0, +inf and NaN edges included; at
    every threshold from none to 32 keys under it."""
    rng = np.random.default_rng(seed)
    v = rng.integers(-6, 7, deg_p).astype(np.float32)
    v[rng.integers(0, deg_p, 8)] = -0.0
    v[rng.integers(0, deg_p, 8)] = np.inf
    v[rng.integers(0, deg_p, 2)] = np.nan
    keys = sort_key(v, np.arange(deg_p))
    full = np.sort(keys)
    for th in np.unique(keys >> np.uint64(32)):
        under = keys[(keys >> np.uint64(32)) < th]  # in edge order
        if len(under) > 32:
            break
        part = np.full(32, np.uint64(0xFFFFFFFFFFFFFFFF))
        part[:len(under)] = under
        part = np.sort(part)
        assert np.array_equal(part[:len(under)], full[:len(under)]), th
        assert not (part[len(under):] >> np.uint64(32) < 0xff800000).any()


@pytest.mark.parametrize("integer,n,width,kprime,closed", [
    (False, 3000, 1, 40, False), (True, 3000, 2, 16, True),
    (True, 120, 3, 24, True), (True, 120, 1, 64, False),
    (False, 150, 2, 64, True)])
def test_k6_hop_statement_is_the_edge_hop(integer, n, width, kprime,
                                          closed):
    """Hop by hop, the kernel's rules — ballot picks, the last parent's
    threshold, the dedup by rank, the register merge — give the plain
    edge hop's buffer (distances bit for bit, ids) and explored flags
    (where the buffer is finite), on Gaussian, tie-heavy integer and
    duplicate-heavy (n = 120: ids repeat within graph rows and between
    rows and the buffer) stores at width 1–3, k' up to deg_p, with
    frontiers closing early."""
    itopk = 48                                  # L = 64: 16 pad cells
    es = edge_store(torch.int8, 7, integer, n=n, degree=60, m=24,
                    itopk=itopk, closed=closed)
    kw = dict(width=width, kprime=kprime, degree=es["degree"], metric="l2")
    hops_against_edge_hop(es, es["buf_d"], es["buf_i"], itopk, kw)


@pytest.mark.parametrize("integer,width", [(True, 2), (False, 1)])
def test_k6_load_takes_a_shuffled_seed_as_the_edge_hop_does(integer, width):
    """A seeded buffer whose rows are shuffled out of order (integer
    values: ties between buffer cells): K6's load, by (value, slot) with
    the ids following, and its hops give the plain edge hop's buffers from
    the same shuffled seed, hop by hop."""
    itopk = 48
    es = edge_store(torch.int8, 8, integer, n=3000, degree=60, m=24,
                    itopk=itopk)
    perm = torch.from_numpy(np.argsort(
        np.random.default_rng(9).random((24, itopk)), axis=1))
    kw = dict(width=width, kprime=24, degree=es["degree"], metric="l2")
    hops_against_edge_hop(es, es["buf_d"].gather(1, perm),
                          es["buf_i"].gather(1, perm), itopk, kw)


def hops_against_edge_hop(es, bd, bi, itopk, kw, hops=5):
    """k6_load, then ``hops`` k6_hop steps beside as many plain edge
    hops from the same seed: equal distances (bits), ids and, where the
    buffer is finite, explored flags after every hop."""
    be = torch.zeros(bd.shape, dtype=torch.bool)
    sk, si = k6_load(bd.numpy(), bi.numpy(), itopk, 64)
    for _ in range(hops):
        bd, bi, be = tcf.edge_hop(
            es["q"], bd, bi, be, es["vecs"], es["aux"], es["gph"], es["pen"],
            select=select_k_plain, expand=tge.graph_expand_plain, **kw)
        sk, si = k6_hop(es["q"], sk, si, es["vecs"], es["aux"], es["gph"],
                        es["pen"], itopk=itopk, **kw)
        np.testing.assert_array_equal(
            key_value(sk[:, :itopk]).view(np.int32),
            bd.numpy().view(np.int32))
        np.testing.assert_array_equal(si[:, :itopk], bi.numpy())
        fin = np.isfinite(bd.numpy())
        np.testing.assert_array_equal((sk[:, :itopk] & 1).astype(bool)[fin],
                                      be.numpy()[fin])
