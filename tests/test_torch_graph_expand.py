"""The CAGRA frontier expansion of the PyTorch port (the plain version of
kernel K5) and its storage coding against the JAX package:
``raft_tpu.ops.graph_expand.graph_expand`` with its Pallas kernel in
interpret mode, over an edge store built by ``raft_tpu``'s
``cagra.prepare_traversal``, and ``raft_tpu.ops.quant.quantize_rows``.

Tolerances: the int8 codes and scales and the bf16 rows are equal (the
same float32 division and half-to-even rounding). Gaussian queries: the
per-parent values agree to ``rtol=1e-5, atol=1e-5·max|v|`` and the edge
positions on >= 99% of the (query, parent) rows (float32 sums in another
order; ``assert_knn_close``). Integer-valued data and queries: every
product and sum is exact, so values and positions are equal, ties
included.

The int4 and pq store modes against JAX's ``graph_expand(mode="int4" |
"pq")`` on JAX-built stores (pq with JAX's decode table and rescale row,
carried into the port's compact codebook by ``convert``): on
integer-valued data — for pq, integer codebooks whose per-subspace absmax
is 127, so the int8 table's scale is 1 — values and edge positions are
equal; on Gaussian data ``assert_knn_close``, since JAX sums a row in
another order (int4: its two planes apart, then added; pq: one dot over
the decoded row) than the kernels' lanes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops import quant as jquant
from raft_tpu.ops.graph_expand import graph_expand as jax_graph_expand
from raft_tpu_torch import convert
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.matrix.select_k import smallest_k_plain
from raft_tpu_torch.ops import graph_expand as tge
from raft_tpu_torch.ops import quant as tquant
from test_torch_kernels import assert_knn_close

torch.set_num_threads(1)

N, D, M, WIDTH, KOUT = 600, 24, 40, 2, 16


def _data(integer: bool, seed: int):
    rng = np.random.default_rng(seed)
    gen = ((lambda s: rng.integers(-4, 5, s)) if integer
           else rng.standard_normal)
    return (gen((N, D)).astype(np.float32), gen((M, D)).astype(np.float32),
            rng)


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_quantize_rows_matches_jax(dtype):
    x = np.random.default_rng(0).standard_normal((300, 40)).astype(
        np.float32) * 3
    x[7] = 0.0                                    # the 1e-30 scale floor
    jr, js = jquant.quantize_rows(jnp.asarray(x), getattr(jnp, dtype))
    tr, ts = tquant.quantize_rows(torch.from_numpy(x), dtype)
    assert tr.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(tr.to(torch.float32).numpy(),
                                  np.asarray(jr).astype(np.float32))
    if dtype == "int8":
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    else:
        assert ts is None and js is None


# (store, metric, penalty, degree): each store meets both metrics, both
# penalty settings and both degrees (each case compiles the Pallas kernel
# once, ~5 s); degree 24 pads to JAX's 32-edge tile and is cut to k' = 16
CASES = [("int8", "l2", True, 24), ("int8", "ip", False, 16),
         ("bfloat16", "l2", False, 24), ("bfloat16", "ip", True, 16)]


@pytest.mark.parametrize("store,metric,penalty,degree", CASES)
def test_graph_expand_plain_matches_jax(store, metric, penalty, degree):
    for integer in (False, True):
        x, q, rng = _data(integer, degree)
        graph = rng.integers(0, N, (N, degree)).astype(np.int32)
        jidx = jcagra.Index(jnp.asarray(x), jnp.asarray(graph),
                            jcagra.DistanceType.L2Expanded)
        jcagra.prepare_traversal(jidx, store)
        _, ev, aux, _, _ = jidx._edge_store
        deg_p = ev.shape[1]
        pen = None
        if penalty:
            pen = np.where(rng.random((N, deg_p)) < 0.25, np.inf,
                           0.0).astype(np.float32)
        parents = rng.integers(0, N, (M, WIDTH)).astype(np.int32)
        jv, je = jax_graph_expand(
            jnp.asarray(parents), jnp.asarray(q), ev, aux, KOUT,
            metric=metric, degree=degree,
            pen=None if pen is None else jnp.asarray(pen))
        tvecs = torch.from_numpy(np.array(ev.astype(jnp.float32))).to(
            getattr(torch, store))
        tv, te = tge.graph_expand(
            torch.from_numpy(parents), torch.from_numpy(q), tvecs,
            torch.from_numpy(np.array(aux)), KOUT, metric, degree,
            None if pen is None else torch.from_numpy(pen))
        assert tv.shape == (M, WIDTH, KOUT) and te.dtype == torch.int32
        jv = np.asarray(jv).reshape(M * WIDTH, KOUT)
        je = np.asarray(je).reshape(M * WIDTH, KOUT)
        tv, te = tv.reshape(M * WIDTH, KOUT), te.reshape(M * WIDTH, KOUT)
        if integer:
            np.testing.assert_array_equal(tv.numpy(), jv)
            np.testing.assert_array_equal(te.numpy(), je)
        else:
            assert_knn_close(jv, je, tv.numpy(), te.numpy())
        assert bool((te < degree).all())


def test_graph_expand_refuses_unported_modes():
    """Every store mode of the JAX kernel is ported; a mode it does not
    have, a pq store without its codebook, and an int4 tile whose width
    is not half the scored one are refused."""
    vecs = torch.zeros((4, 32, 128), dtype=torch.int8)
    aux = torch.zeros((4, 2, 32))
    args = (torch.zeros((2, 1), dtype=torch.int32), torch.zeros((2, 8)))
    with pytest.raises(RaftError, match="unknown store mode"):
        tge.graph_expand(*args, vecs, aux, 4, mode="int2")
    with pytest.raises(RaftError, match="codebook"):
        tge.graph_expand(*args, vecs.to(torch.uint8)[:, :, :16], aux, 4,
                         mode="pq")
    with pytest.raises(RaftError, match="int4 tiles"):
        tge.check_tile(32, 128, "int4", 128)
    for pq_dim in (1, 128):       # pq_len 128 and 1
        with pytest.raises(RaftError, match="pq tiles"):
            tge.check_tile(32, 128, "pq", pq_dim)
    tge.check_tile(32, 128, "pq", 64)
    tge.check_tile(32, 256, "int4", 128)


def _int_pq_books(rng, pq_dim: int, book: int, pq_len: int) -> np.ndarray:
    """Integer codebooks whose every subspace reaches |127|: JAX's int8
    table then has scale 1 and holds them exactly."""
    books = rng.integers(-40, 41, (pq_dim, book, pq_len)).astype(np.float32)
    books[:, 0, 0] = 127.0
    books[::2, 1, 0] = -127.0
    return books


def _jax_store(mode: str, x, graph, lut: str, pq_dim: int, integer: bool,
               rng):
    """JAX's edge store of ``mode`` over (x, graph) as a dict of numpy
    arrays, in the layout ``convert.cagra_index_from_numpy`` takes. An
    integer-valued pq store gets integer codebooks (random codes)."""
    jidx = jcagra.Index(jnp.asarray(x), jnp.asarray(graph),
                        jcagra.DistanceType.L2Expanded)
    if mode == "pq" and integer:
        degree = graph.shape[1]
        deg_p = -(-degree // 32) * 32
        books = _int_pq_books(rng, pq_dim, 256, 128 // pq_dim)
        codes = rng.integers(0, 256, (x.shape[0], pq_dim)).astype(np.uint8)
        norms = np.asarray(jquant.pq_decoded_norms(codes, books))
        vecs = np.zeros((x.shape[0], deg_p, pq_dim), np.uint8)
        vecs[:, :degree] = codes[graph]
        aux = np.zeros((x.shape[0], 2, deg_p), np.float32)
        aux[:, 0, :degree] = 1.0
        aux[:, 1, :degree] = norms[graph]
        gp = np.zeros((x.shape[0], deg_p), np.int32)
        gp[:, :degree] = graph
        tbl = jquant.pq_decode_table(books)
        cbm, cbs = (jquant.pq_int8_cb(tbl, pq_dim, 256) if lut == "int8"
                    else (tbl, jnp.ones((1, 128), jnp.float32)))
        if lut == "int8":
            assert (np.asarray(cbs) == 1.0).all()
        return dict(mode="pq", degree=degree, vecs=vecs, aux=aux, gp=gp,
                    cb_mat=np.asarray(cbm), cb_scale=np.asarray(cbs))
    jcagra.prepare_traversal(jidx, mode, pq_dim=pq_dim, pq_lut=lut)
    (tag, degree, _, _), ev, aux, gp, cbs = jidx._edge_store
    out = dict(mode=tag, degree=degree, vecs=np.asarray(ev),
               aux=np.asarray(aux), gp=np.asarray(gp))
    if cbs is not None:
        out.update(cb_mat=np.asarray(cbs[0]), cb_scale=np.asarray(cbs[1]))
    return out


# (mode, LUT, pq_dim, metric, penalty): both metrics and penalty settings
# for each mode; pq in both LUT types and at pq_dim 64 (pq_len 2: a lane's
# 4 dims span two subspaces)
MODE_CASES = [("int4", None, 0, "l2", True), ("int4", None, 0, "ip", False),
              ("pq", "int8", 16, "l2", False), ("pq", "f32", 16, "ip", True),
              ("pq", "int8", 64, "ip", True)]


@pytest.mark.parametrize("mode,lut,pq_dim,metric,penalty", MODE_CASES)
def test_graph_expand_modes_match_jax(mode, lut, pq_dim, metric, penalty):
    degree = 24
    for integer in (True, False):
        x, q, rng = _data(integer, pq_dim + 3)
        graph = rng.integers(0, N, (N, degree)).astype(np.int32)
        js = _jax_store(mode, x, graph, lut, pq_dim, integer, rng)
        st = convert.cagra_index_from_numpy(
            {"dataset": x, "graph": graph, "metric": "l2_expanded"},
            device="cpu", edge_store=js).edge_store
        assert st.dim_p == 128 and st.kernel_mode == mode
        deg_p = js["vecs"].shape[1]
        pen = None
        if penalty:
            pen = np.where(rng.random((N, deg_p)) < 0.25, np.inf,
                           0.0).astype(np.float32)
        parents = rng.integers(0, N, (M, WIDTH)).astype(np.int32)
        kw = {} if mode == "int4" else dict(
            cbm=jnp.asarray(js["cb_mat"]), cb_scale=jnp.asarray(js["cb_scale"]))
        jv, je = jax_graph_expand(
            jnp.asarray(parents), jnp.asarray(q), jnp.asarray(js["vecs"]),
            jnp.asarray(js["aux"]), KOUT, metric=metric, degree=degree,
            pen=None if pen is None else jnp.asarray(pen), mode=mode, **kw)
        tv, te = tge.graph_expand(
            torch.from_numpy(parents), torch.from_numpy(q), st.vecs, st.aux,
            KOUT, metric, degree,
            None if pen is None else torch.from_numpy(pen), mode, st.cb,
            st.cb_scale)
        jv = np.asarray(jv).reshape(M * WIDTH, KOUT)
        je = np.asarray(je).reshape(M * WIDTH, KOUT)
        tv, te = tv.reshape(M * WIDTH, KOUT), te.reshape(M * WIDTH, KOUT)
        if integer:
            np.testing.assert_array_equal(tv.numpy(), jv)
            np.testing.assert_array_equal(te.numpy(), je)
        else:
            assert_knn_close(jv, je, tv.numpy(), te.numpy())


# --- the rules of K5's and K6's scoring (csrc/edge_score.cuh) as numpy
# statements, in the order the kernel decides, held against the plain
# version's

def reduce_scatter(acc: np.ndarray) -> np.ndarray:
    """(32 lanes, 32 rows) lane partial sums → the 32 row sums, row e from
    lane e, as ``edge::reduce_scatter`` forms them: lane l holds row
    i ^ l's partial in register i; at xor distance 16, 8, 4, 2, 1 every
    lane keeps registers r < off and adds its partner's register r + off,
    the same row's partial (31 shuffles for 32 rows)."""
    lane = np.arange(32)
    regs = acc.astype(np.float32)[lane[:, None], np.arange(32)[None, :]
                                  ^ lane[:, None]]
    for off in (16, 8, 4, 2, 1):
        r = np.arange(off)
        regs = regs[:, r] + regs[lane ^ off][:, r + off]
    return regs[:, 0]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reduce_scatter_is_the_butterfly(seed):
    """The reduce-scatter tree gives every row the butterfly's bits, on
    floats of wide range (where another order of adds would round
    differently), and through lane_order_dot's lane partials."""
    rng = np.random.default_rng(seed)
    acc = (rng.standard_normal((32, 32))
           * 10.0 ** rng.integers(-6, 7, (32, 32))).astype(np.float32)
    want = tge._butterfly(torch.from_numpy(acc.T.copy())).numpy()
    np.testing.assert_array_equal(reduce_scatter(acc).view(np.int32),
                                  want.view(np.int32))
    # 32 rows of 256 dims against one query: the kernel's lane sums, then
    # the tree, equal lane_order_dot bit for bit
    q = rng.standard_normal(256).astype(np.float32)
    v = (rng.standard_normal((32, 256))
         * 10.0 ** rng.integers(-4, 5, (32, 256))).astype(np.float32)
    lanes = np.zeros((32, 32), np.float32)
    for c in range(2):
        for j in range(4):
            d = 128 * c + 4 * np.arange(32) + j
            lanes += q[d][:, None] * v[:, d].T
    want = tge.lane_order_dot(torch.from_numpy(q)[None, :],
                              torch.from_numpy(v)).numpy()
    np.testing.assert_array_equal(reduce_scatter(lanes).view(np.int32),
                                  want.view(np.int32))


def test_int8_widening_is_exact():
    """The byte, xor 0x80, in the mantissa of 2^23 (one prmt), less
    2^23 + 128: every int8 value exactly."""
    b = np.arange(-128, 128, dtype=np.int32)
    u = (b & 0xff) ^ 0x80
    f = (np.uint32(0x4B000000) | u.astype(np.uint32)).view(np.float32)
    np.testing.assert_array_equal(f - np.float32(8388736.0),
                                  b.astype(np.float32))


def sort_key(v: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """``edge::sort_key``: the value's order bits (-0.0 as 0.0) in the
    high word, the position << 2 below, bit 1 a -0.0's sign, bit 0 free
    (K6's explored flag)."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    neg0 = (u == 0x80000000).astype(np.uint64)
    u = np.where(neg0, np.uint64(0), u)
    u = np.where(u & np.uint64(0x80000000), ~u & np.uint64(0xffffffff),
                 u | np.uint64(0x80000000))
    return ((u << np.uint64(32)) | (pos.astype(np.uint64) << np.uint64(2))
            | (neg0 << np.uint64(1)))


def key_value(k: np.ndarray) -> np.ndarray:
    """``edge::key_value``: the value back, bit for bit."""
    u = (k >> np.uint64(32)) & np.uint64(0xffffffff)
    u = np.where(u & np.uint64(0x80000000), u & np.uint64(0x7fffffff),
                 ~u & np.uint64(0xffffffff))
    v = u.astype(np.uint32).view(np.float32)
    return np.where(k & np.uint64(2), np.float32(-0.0), v)


def bitonic(keys: np.ndarray) -> np.ndarray:
    """``edge::warp_sort``'s network on (..., N) distinct keys, cell n =
    32g + lane: at each (s, j) cell n keeps the smaller of itself and
    cell n ^ j when (n & j == 0) == (n & s == 0), else the larger."""
    n = np.arange(keys.shape[-1])
    k = keys.copy()
    s = 2
    while s <= keys.shape[-1]:
        j = s // 2
        while j:
            o = k[..., n ^ j]
            keep_min = ((n & j) == 0) == ((n & s) == 0)
            k = np.where(keep_min, np.minimum(k, o), np.maximum(k, o))
            j //= 2
        s *= 2
    return k


@pytest.mark.parametrize("ng", [1, 2, 4, 8])
def test_tile_topk_network_is_the_stable_sort(ng):
    """K5's per-parent top-k': keys of (value, edge) through the bitonic
    network, decoded, equal graph_expand_plain's selection — the stable
    float sort, -0.0 tied with 0.0 and kept as -0.0, +inf pad edges and
    the network's pad cells last, -1 past the finite values — on
    tie-heavy rows (k' = deg_p)."""
    rng = np.random.default_rng(ng)
    deg_p = 32 * ng - (32 if ng == 4 else 0)       # 96 pads to 128
    degree = deg_p - 5
    d = rng.integers(-3, 4, (64, deg_p)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = np.inf
    d[rng.random(d.shape) < 0.2] = -0.0
    d[:, degree:] = np.inf                          # pad edges
    full = np.full((64, 32 * ng), np.inf, np.float32)
    full[:, :deg_p] = d
    e = np.broadcast_to(np.arange(32 * ng), full.shape)
    k = bitonic(sort_key(full, e))[:, :deg_p]
    v, pos = key_value(k), (k & 0xffffffff).astype(np.int64) >> 2
    pos = np.where(np.isfinite(v), pos, -1)
    wv, wi = smallest_k_plain(torch.from_numpy(d), deg_p)
    wi = torch.where(torch.isfinite(wv), wi, -1)
    np.testing.assert_array_equal(v.view(np.int32), wv.numpy().view(np.int32))
    np.testing.assert_array_equal(pos, wi.numpy())


# --- the packed stores' rules in edge_score.cuh (TileScorer<Int4>,
# PqScorer) as numpy statements, held against widen_tile, whose rows the
# plain version scores in lane_order_dot's order

def int4_widen(w: np.ndarray, plane: int) -> np.ndarray:
    """``Store<Int4>::widen``: the plane's nibbles of each byte of a word,
    + 8 by an xor, in the mantissa of 2^23 (the prmt), less 2^23 + 8."""
    u = ((w.astype(np.uint32) >> np.uint32(4 * plane))
         & np.uint32(0x0f0f0f0f)) ^ np.uint32(0x08080808)
    out = []
    for k in range(4):
        byte = (u >> np.uint32(8 * k)) & np.uint32(0xff)
        f = (np.uint32(0x4B000000) | byte).view(np.float32)
        out.append(f - np.float32(8388616.0))
    return np.stack(out, axis=-1)


def test_int4_widening_is_exact():
    """Every byte's two nibbles, widened as the kernel does, equal
    ``int4_nibbles``' sign-extending shifts."""
    b = np.arange(256, dtype=np.uint32)
    w = b | (b << 8) | (b << 16) | (b << 24)
    low, high = tquant.int4_nibbles(torch.from_numpy(
        b.astype(np.uint8).view(np.int8)))
    np.testing.assert_array_equal(int4_widen(w, 0)[:, 0], low.numpy())
    np.testing.assert_array_equal(int4_widen(w, 1)[:, 0], high.numpy())
    np.testing.assert_array_equal(int4_widen(w, 1)[:, 3], high.numpy())


def int4_slot(r):
    return r ^ ((r >> 4) & 1)


def int4_lane_rows(rows: np.ndarray, dim_p: int) -> np.ndarray:
    """The (32 rows, dim_p) values the kernel's lanes widen from a unit of
    32 packed rows (32, dim_p / 2 bytes): for chunk c, stage the two
    64-byte segments of its halves (the same 64 bytes at dim_p 128, rows
    at slot r ^ (r >> 4 & 1)), then lane l reads its word of row i and
    widens the plane of half-chunk 2c + (l >= 16) into dims 128c + 4l +
    j."""
    half = dim_p // 2
    words = rows.view(np.uint8).reshape(32, half)
    out = np.zeros((32, dim_p), np.float32)
    seg = lambda h: 64 * h if 64 * h < half else 64 * h - half  # noqa
    for c in range(dim_p // 128):
        if dim_p == 128:
            stage = np.zeros((32, 64), np.uint8)
            stage[int4_slot(np.arange(32))] = words[:, :64]
        else:
            stage = np.concatenate(
                [words[:, seg(2 * c):seg(2 * c) + 64],
                 words[:, seg(2 * c + 1):seg(2 * c + 1) + 64]], axis=1)
        st32 = stage.copy().view(np.uint32)              # (32, 16 or 32)
        for lane in range(32):
            if dim_p == 128:
                w = st32[int4_slot(np.arange(32)), lane & 15]
                plane = lane >> 4
            else:
                w = st32[:, lane]
                plane = int(64 * (2 * c + (lane >> 4)) >= half)
            d = 128 * c + 4 * lane
            out[:, d:d + 4] = int4_widen(w, plane)
    return out


@pytest.mark.parametrize("dim_p", [128, 256, 384, 512])
def test_int4_lanes_widen_the_scored_dims(dim_p):
    """The kernel's staging and reads give every lane the dims the
    contract gives it (``widen_tile``'s low plane on [0, half), high on
    [half, dim_p)); at dim_p 128 lanes l and l ^ 16 read the same word,
    and the slots keep the reduce-scatter's reads (row i ^ l, lane l) on
    32 distinct banks."""
    rng = np.random.default_rng(dim_p)
    rows = rng.integers(-128, 128, (32, dim_p // 2)).astype(np.int8)
    want = tge.widen_tile(torch.from_numpy(rows), "int4").numpy()
    np.testing.assert_array_equal(int4_lane_rows(rows, dim_p), want)
    lane = np.arange(32)
    for i in range(32):
        bank = (int4_slot(i ^ lane) * 16 + (lane & 15)) % 32
        assert len(set(bank.tolist())) == 32


def pq_lane_rows(codes: np.ndarray, cb: np.ndarray, scale, dim_p: int
                 ) -> np.ndarray:
    """The (rows, dim_p) values ``PqScorer`` decodes: lane l's dims d =
    128c + 4l + j each read the code of subspace d // pq_len and the
    codebook entry (s·book + code)·pq_len + d % pq_len — one code and one
    word for the 4 dims when pq_len % 4 == 0 — in int8 mode float(t) ·
    scale[s], one float32 product."""
    pq_dim, book, pq_len = cb.shape
    flat = cb.reshape(-1)
    out = np.zeros((codes.shape[0], dim_p), np.float32)
    for c in range(dim_p // 128):
        for lane in range(32):
            d0 = 128 * c + 4 * lane
            if pq_len % 4 == 0:
                s = d0 // pq_len
                idx = s * book * pq_len + d0 - s * pq_len
                idx = idx + codes[:, s].astype(np.int64) * pq_len
                v = flat[idx[:, None] + np.arange(4)].astype(np.float32)
                if scale is not None:
                    v = v * np.float32(scale[s])
            else:
                v = np.zeros((codes.shape[0], 4), np.float32)
                for j in range(4):
                    s = (d0 + j) // pq_len
                    idx = (s * book * pq_len + d0 + j - s * pq_len
                           + codes[:, s].astype(np.int64) * pq_len)
                    v[:, j] = flat[idx].astype(np.float32)
                    if scale is not None:
                        v[:, j] *= np.float32(scale[s])
            out[:, d0:d0 + 4] = v
    return out


@pytest.mark.parametrize("dim_p,pq_dim", [(128, 16), (128, 64), (128, 4),
                                          (384, 64), (256, 32)])
@pytest.mark.parametrize("lut", ["int8", "f32"])
def test_pq_lanes_decode_the_scored_dims(dim_p, pq_dim, lut):
    """PqScorer's decode of each lane's dims equals ``widen_tile``'s, bit
    for bit: at pq_len 8, 2 (a lane's dims over two subspaces), 32, 6 (a
    subspace boundary inside a lane's word) and 8 at dim_p 256."""
    rng = np.random.default_rng(dim_p + pq_dim)
    pq_len, book = dim_p // pq_dim, 200
    codes = rng.integers(0, book, (64, pq_dim)).astype(np.uint8)
    if lut == "int8":
        cb = rng.integers(-127, 128, (pq_dim, book, pq_len)).astype(np.int8)
        scale = rng.uniform(0.001, 0.1, pq_dim).astype(np.float32)
    else:
        cb = rng.standard_normal((pq_dim, book, pq_len)).astype(np.float32)
        scale = None
    want = tge.widen_tile(
        torch.from_numpy(codes), "pq", torch.from_numpy(cb),
        None if scale is None else torch.from_numpy(scale)).numpy()
    np.testing.assert_array_equal(
        pq_lane_rows(codes, cb, scale, dim_p).view(np.int32),
        want.view(np.int32))
