"""K2's wide form (``csrc/fused_knn.cuh``, past ``LIST_MAX_K``) on the CPU:
its selection stated step by step in numpy and held against the JAX
package's ``fused_knn`` (interpret mode) and the port's plain version,
the wrapper's boundary between the k-list plans and the wide form, and
the constants the wrapper shares with the kernel source.

The statement (:func:`wide_form`) runs the kernel's rule on one query's
distances at a time: the corpus cut into splits of 128-row tiles; each
(query, split) a buffer of ``wide_cap(k)`` 64-bit keys (order bits of
the distance, -0.0 keyed as 0.0, then the column and a -0.0 flag) behind
a bound, every key below it offered; a buffer past cap - 128 keys shrunk
to its keys below the tighter of its bound and the query's shared one,
or, past ``fit`` of them, to the k best and their bucket (10-bit
histogram passes, as ``block_select.cuh::find_bucket``), the bucket's
end becoming the bound and tightening the shared one; the first two
splits run tile by tile side by side (the card's first wave), the others
after them from the shared bound; at the end the k best keys below the
final shared bound over all the splits' buffers. The corpora are many
tiles long, so that the buffers shrink.

Tolerance: integer-valued data, so every distance is exact: values (-0.0
beside 0.0 included) and ids equal, bit for bit against the plain version.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops.fused_knn import fused_knn as jax_fused_knn
from raft_tpu_torch.ops import fused_knn as tfk

torch.set_num_threads(1)

NONE = (1 << 64) - 1   # no key: never taken
TILE = 128
CSRC = Path(tfk.__file__).resolve().parents[1] / "csrc"


def order_key(v: np.float32) -> int:
    """``list_select.cuh::order_key``: ascending keys are ascending values,
    -0.0 keyed as 0.0; None for +inf and NaN (never offered)."""
    if not v < np.inf:
        return None
    u = int(np.float32(v).view(np.uint32))
    if u == 0x80000000:
        u = 0
    return (~u & 0xFFFFFFFF) if u & 0x80000000 else (u | 0x80000000)


def key64(v: np.float32, col: int):
    ok = order_key(v)
    if ok is None:
        return None
    neg0 = int(np.float32(v).view(np.uint32)) == 0x80000000
    return (ok << 32) | (col << 1) | int(neg0)


def decode(key: int):
    """``buffer_value`` / ``buffer_column``: the key's value bit for bit
    and its column."""
    col = (key & 0xFFFFFFFF) >> 1
    if key & 1:
        return np.float32(-0.0), col
    ok = key >> 32
    u = (ok & 0x7FFFFFFF) if ok & 0x80000000 else (~ok & 0xFFFFFFFF)
    return np.uint32(u).view(np.float32), col


def bucket_end(keys, k: int, fit: int) -> int:
    """``find_bucket`` over ``keys`` (unique, more than fit) for the k-th:
    10-bit passes from the bits the least and greatest share, until the
    bucket and the keys below it are at most fit or the bucket is one key;
    the bucket's end, or NONE where it wraps."""
    lo, hi = min(keys), max(keys)
    sh = (lo ^ hi).bit_length()
    pre, less, krem = lo >> sh, 0, k
    while True:
        nb = min(sh, 10)
        sh2 = sh - nb
        hist = np.zeros(1 << nb, np.int64)
        for x in keys:
            if x >> sh == pre:
                hist[(x >> sh2) & ((1 << nb) - 1)] += 1
        cum = np.cumsum(hist)
        dig = int(np.searchsorted(cum, krem))
        before = int(cum[dig] - hist[dig])
        less, krem = less + before, krem - before
        pre, sh = (pre << nb) | dig, sh2
        if sh == 0 or less + int(hist[dig]) <= fit:
            break
    end = (pre + 1) << sh
    return NONE if end >= 1 << 64 else end


class Split:
    """One (query, split) block: its tiles, buffer and bound."""

    def __init__(self, dist, c0, c1, bound):
        self.dist, self.cols = dist, range(c0, c1)
        self.tiles = [range(t, min(t + TILE, c1)) for t in range(c0, c1,
                                                               TILE)]
        self.buf, self.thr, self.shrinks = [], bound, 0

    def tile(self, t, cap, k, fit, shared):
        for c in self.tiles[t]:
            key = key64(self.dist[c], c)
            if key is not None and key < self.thr:
                self.buf.append(key)
        if len(self.buf) > cap - TILE:
            self.shrinks += 1
            lim = min(self.thr, shared[0])
            below = [x for x in self.buf if x < lim]
            thr = lim
            if len(below) > fit:
                thr = min(lim, bucket_end(below, k, fit))
            self.buf = [x for x in self.buf if x < thr]
            assert len(self.buf) <= cap - TILE
            self.thr = thr
            shared[0] = min(shared[0], thr)


def wide_form(dist: np.ndarray, k: int, splits: int):
    """One query's k best (values, ids) by the wide form's rule, and its
    splits' shrink counts."""
    n = dist.shape[0]
    per = -(-(-(-n // splits)) // TILE) * TILE
    cap = tfk.wide_cap(k)
    fit = k + (cap - TILE - k) // 4
    shared = [NONE]
    first = [Split(dist, s * per, min(n, (s + 1) * per), shared[0])
             for s in range(min(2, splits))]
    for t in range(max(len(b.tiles) for b in first)):
        for b in first:
            if t < len(b.tiles):
                b.tile(t, cap, k, fit, shared)
    blocks = list(first)
    for s in range(2, splits):
        b = Split(dist, s * per, min(n, (s + 1) * per), shared[0])
        for t in range(len(b.tiles)):
            b.tile(t, cap, k, fit, shared)
        blocks.append(b)
    keys = sorted(x for b in blocks for x in b.buf if x < shared[0])[:k]
    vals = np.full(k, np.inf, np.float32)
    ids = np.full(k, -1, np.int32)
    for e, key in enumerate(keys):
        vals[e], ids[e] = decode(key)
    return vals, ids, [b.shrinks for b in blocks]


def int_case(seed: int, m: int, n: int, d: int, metric: str):
    """Integer-valued queries and rows (ties by the hundred), query 0 all
    zeros, a penalty of +inf on 30% of the rows and -0.0 or 0.0 on the
    rest (under ip the zero query's distances are -0.0 and 0.0 side by
    side); the distances as K2 computes them (exact here)."""
    rng = np.random.default_rng(seed)
    q = rng.integers(-2, 3, (m, d)).astype(np.float32)
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    q[0] = 0.0
    pen = np.where(rng.random(n) < 0.5, -0.0, 0.0).astype(np.float32)
    pen[rng.random(n) < 0.3] = np.inf
    qt, xt, pt = map(torch.from_numpy, (q, x, pen))
    qn = tfk.prepare_norms(metric, qt)
    dn = tfk.prepare_norms(metric, xt)
    dist = tfk._distances(qt @ xt.T, qn, dn, metric, pt).numpy()
    return q, x, pen, dist


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("k,splits", [(65, 3), (129, 4), (300, 2),
                                      (700, 3)])
def test_wide_form_statement_matches_jax(k, splits, metric):
    """The wide form's rule, shared bound and all, gives the plain
    version's k best bit for bit and JAX's ``fused_knn`` (interpret mode)
    values and ids, the first split shrinking at least once."""
    q, x, pen, dist = int_case(k + splits, 6, 6000, 16, metric)
    pv, pi = tfk.fused_knn_plain(torch.from_numpy(q), torch.from_numpy(x),
                                 k, metric, penalty=torch.from_numpy(pen))
    jv, ji = jax_fused_knn(jnp.asarray(q), jnp.asarray(x), k, metric,
                           penalty=jnp.asarray(pen), interpret=True)
    for r in range(q.shape[0]):
        v, i, shrinks = wide_form(dist[r], k, splits)
        np.testing.assert_array_equal(v.view(np.uint32),
                                      pv[r].numpy().view(np.uint32))
        np.testing.assert_array_equal(i, pi[r].numpy())
        np.testing.assert_array_equal(v, np.asarray(jv[r]))
        np.testing.assert_array_equal(i, np.asarray(ji[r]))
        assert shrinks[0] >= 1


def test_wide_form_statement_ties_and_short_rows():
    """Every row at one distance (k = n's worth of ties: the first k
    columns in order), and fewer finite rows than k ((+inf, -1) past
    them), through the statement as through the plain version."""
    d = np.zeros(3000, np.float32)
    v, i, _ = wide_form(d, 257, 4)
    np.testing.assert_array_equal(i, np.arange(257))
    d = np.full(3000, np.inf, np.float32)
    d[::40] = np.arange(75, dtype=np.float32) % 7
    v, i, _ = wide_form(d, 257, 3)
    assert np.isinf(v[75:]).all() and (i[75:] == -1).all()
    order = np.lexsort((np.arange(0, 3000, 40), d[::40]))
    np.testing.assert_array_equal(i[:75], np.arange(0, 3000, 40)[order])
    np.testing.assert_array_equal(v[:75], d[::40][order])


@pytest.mark.parametrize("k", [24, 25, 32, 33, 64])
def test_k_boundary_matches_jax(k):
    """Around the boundary between the k-list plans (up to LIST_MAX_K)
    and the wide form: brute force on the CPU (the plain version) against
    JAX's ``fused_knn`` on integer-valued rows with a filter, values and
    ids equal; the wrapper's plan: the k-list plans' corpus splits up to
    the boundary, the wide form's (at least 2k rows a split, its buffers
    within WIDE_BUDGET) past it."""
    q, x, pen, _ = int_case(k, 20, 3000, 16, "l2")
    tv, ti = tfk.fused_knn(torch.from_numpy(q), torch.from_numpy(x), k,
                           penalty=torch.from_numpy(pen))
    jv, ji = jax_fused_knn(jnp.asarray(q), jnp.asarray(x), k,
                           penalty=jnp.asarray(pen), interpret=True)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    splits, rows = tfk.split_plan(10_000, 1_000_000, k, 132)
    if k > tfk.LIST_MAX_K:
        assert rows >= 2 * k
        assert 8 * 10_000 * splits * tfk.wide_cap(k) <= tfk.WIDE_BUDGET
    assert tfk.block_queries(k) == 128


def test_constants_match_the_kernel_source():
    """The wrapper's boundary and query tile are the kernel's: kListMaxK
    is LIST_MAX_K, the wide form's 32·kWideMF queries a block are
    ``block_queries``', and its selection rounds (kRound) hold at least
    the k-lists' widest k."""
    src = (CSRC / "fused_knn.cuh").read_text()
    sel = (CSRC / "block_select.cuh").read_text()
    grab = lambda pat, text: int(re.search(pat, text).group(1))  # noqa
    assert grab(r"constexpr int kListMaxK = (\d+);", src) == tfk.LIST_MAX_K
    assert 32 * grab(r"constexpr int kWideMF = (\d+);", src) == \
        tfk.block_queries(tfk.LIST_MAX_K + 1)
    assert grab(r"constexpr int kRound = (\d+);", sel) >= tfk.LIST_MAX_K


def test_wide_scratch_statement():
    """The wide form's scratch as the library states it
    (``fused_knn_wide_scratch``; chip_smoke holds the two equal on the
    card): the buffers, wide_cap(k) keys of 8 bytes a (query, split),
    then a bound of 8 bytes a query and a count of 4 a (query, split)."""
    for m, splits, k in ((10_000, 5, 1024), (1, 1, 65), (32_768, 3, 129)):
        cap = tfk.wide_cap(k)
        assert tfk.wide_scratch_bytes(m, splits, k) == \
            8 * m * splits * cap + 8 * m + 4 * m * splits
