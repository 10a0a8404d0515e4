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
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.neighbors import cagra as jcagra
from raft_tpu.ops import quant as jquant
from raft_tpu.ops.graph_expand import graph_expand as jax_graph_expand
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
    vecs = torch.zeros((4, 32, 128), dtype=torch.int8)
    aux = torch.zeros((4, 2, 32))
    for mode in ("int4", "pq"):
        with pytest.raises(RaftError, match="not ported"):
            tge.graph_expand(torch.zeros((2, 1), dtype=torch.int32),
                             torch.zeros((2, 8)), vecs, aux, 4, mode=mode)


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
