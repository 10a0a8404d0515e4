"""Kernel K1 (select_k) of the PyTorch port against
``raft_tpu.matrix.select_k``: the Pallas k-pass in interpret mode and the
``lax.top_k`` engine.

Tolerance: none. Rows are integer-valued (ties abound) with +inf
columns, and selection does no arithmetic, so values and ids must be
equal, including which of the tied columns comes first (the lowest).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.matrix.select_k import _kpass_2d
from raft_tpu.matrix.select_k import select_k as jax_select_k
from raft_tpu_torch.matrix import select_k as tsk

torch.set_num_threads(1)

ROWS, N = 256, 1000


def _rows(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 40, (ROWS, N)).astype(np.float32)
    x[rng.random((ROWS, N)) < 0.1] = np.inf
    x[7, :] = np.inf                  # a row of nothing but +inf
    return x


@pytest.mark.parametrize("k", [1, 10, 64])
def test_kpass_matches_pallas_kernel(k):
    x = _rows()
    jv, ji = _kpass_2d(jnp.asarray(x), k, True)
    tv, ti = tsk.kpass_select_k(torch.from_numpy(x), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 10, 64])
@pytest.mark.parametrize("algo", ["auto", "kpass", "topk"])
def test_select_k_matches_topk_engine(k, select_min, algo):
    x = _rows(1)
    if not select_min:
        x = np.where(np.isinf(x), -np.inf, x)
    jv, ji = jax_select_k(jnp.asarray(x), k, select_min=select_min,
                          algo="topk")
    tv, ti = tsk.select_k(torch.from_numpy(x), k, select_min=select_min,
                          algo=algo)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_batched_leading_dims_and_indices():
    x = _rows(2).reshape(4, 64, N)
    ids = np.arange(4 * 64 * N, dtype=np.int32).reshape(4, 64, N)
    jv, ji = jax_select_k(jnp.asarray(x), 5, indices=jnp.asarray(ids),
                          algo="topk")
    tv, ti = tsk.select_k(torch.from_numpy(x), 5,
                          indices=torch.from_numpy(ids))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_k_out_of_range_raises():
    from raft_tpu_torch.core.errors import RaftError

    with pytest.raises(RaftError):
        tsk.select_k(torch.zeros((2, 5)), 6)


@pytest.mark.parametrize("k,form", [(1, "warp"), (20, "warp"), (256, "warp"),
                                    (257, "warp"), (512, "warp"),
                                    (513, "radix"), (1024, "radix")])
def test_form_is_chosen_by_k(k, form):
    assert tsk.select_form(k) == form


# --------------------------------------------------------------------------
# The warp select, stated in numpy (csrc/select_k.cu::warp_select_kernel):
# a queue of C = 32·R keys, key e in register e // 32 of lane e % 32; a
# column enters the warp's buffer (CAP slots, filled in lane order) only
# if it is before the k-th key; a full buffer is sorted descending by a
# bitonic network in CAP // 32 registers, folded into the queue's last
# CAP // 32 registers by an elementwise min and the queue bitonic-merged
# back. CAP = C up to k = 256; past it a 512-key queue folds 128-key
# buffers (warp_queue.cuh::fold_buffer<T, 16, 4>).
# --------------------------------------------------------------------------

_IMAX = (1 << 31) - 1


def _less(v, i, w, j):
    return (v < w) | ((v == w) & (i < j))


def _bitonic_step(v, c, s, j, desc):
    lane = np.arange(32)
    for r in range(v.shape[0]):
        e = r * 32 + lane
        asc = ((e & s) == 0) != desc
        if j >= 32:
            r2 = r | (j >> 5)
            if r & (j >> 5):
                continue
            swap = np.where(asc, _less(v[r2], c[r2], v[r], c[r]),
                            _less(v[r], c[r], v[r2], c[r2]))
            v[[r, r2]] = np.where(swap, v[[r2, r]], v[[r, r2]])
            c[[r, r2]] = np.where(swap, c[[r2, r]], c[[r, r2]])
        else:
            ov, oc = v[r][lane ^ j], c[r][lane ^ j]
            take = ((lane & j) == 0) == asc
            take = take == _less(ov, oc, v[r], c[r])
            v[r] = np.where(take, ov, v[r])
            c[r] = np.where(take, oc, c[r])


def warp_select(row, k, select_min=True):
    n, cap = len(row), max(32, 1 << (k - 1).bit_length())
    rr = cap // 32
    buf_cap = cap if k <= 256 else 128     # the kernel's CAP
    rb = buf_cap // 32
    sign = np.float32(1 if select_min else -1)
    qv = np.full((rr, 32), np.inf, np.float32)
    qc = np.full((rr, 32), _IMAX, np.int64)
    buf = []                       # the warp's buffer, in lane order
    tv, tc = np.float32(np.inf), _IMAX

    def fold():
        bv = np.full(buf_cap, np.inf, np.float32)
        bc = np.full(buf_cap, _IMAX, np.int64)
        bv[:len(buf)] = [v for v, _ in buf]
        bc[:len(buf)] = [c for _, c in buf]
        bv, bc = bv.reshape(rb, 32), bc.reshape(rb, 32)
        for s in (2 << i for i in range(rb.bit_length() + 4)):
            for j in (s >> 1 >> i for i in range(s.bit_length() - 1)):
                _bitonic_step(bv, bc, s, j, True)
        tail_v, tail_c = qv[rr - rb:], qc[rr - rb:]
        take = _less(bv, bc, tail_v, tail_c)
        tail_v[take], tail_c[take] = bv[take], bc[take]
        for j in (16 * rr >> i for i in range((16 * rr).bit_length())):
            _bitonic_step(qv, qc, 64 * rr, j, False)

    for base in range(0, n, 32):
        cols = np.arange(base, min(base + 32, n))
        v = sign * row[cols]
        buf += [(x, c) for x, c, ok in zip(v, cols, _less(v, cols, tv, tc))
                if ok]
        if len(buf) >= buf_cap:
            rest = buf[buf_cap:]
            del buf[buf_cap:]
            fold()
            buf = rest
            tv, tc = qv[(k - 1) // 32, (k - 1) % 32], qc[(k - 1) // 32,
                                                         (k - 1) % 32]
    if buf:
        fold()
    e = np.arange(k)
    fv, fc = qv[e // 32, e % 32], qc[e // 32, e % 32]
    empty = fc == _IMAX
    return sign * np.where(empty, np.inf, fv), np.where(empty, -1, fc)


@pytest.mark.parametrize("k,n", [(1, 64), (20, 1024), (32, 140), (33, 200),
                                 (64, 128), (100, 400), (129, 520),
                                 (257, 700), (300, 900), (512, 600)])
def test_warp_select_statement_matches_pallas_kernel(k, n):
    """The numpy statement of the warp select equals the Pallas k-pass
    (interpret mode) on integer rows with ties, +inf cells, a row of
    nothing but +inf, and the max selection through negation; past
    k = 256, with a 128-key buffer folding into a 512-key queue."""
    rows = 6
    rng = np.random.default_rng(k + n)
    x = rng.integers(0, 30, (rows, n)).astype(np.float32)
    x[rng.random((rows, n)) < 0.1] = np.inf
    x[2] = np.inf
    jv, ji = _kpass_2d(jnp.asarray(x), k, True)
    jv, ji = np.asarray(jv), np.asarray(ji)
    for row in range(rows):
        for sel, xs in ((True, x[row]), (False, -x[row])):
            v, c = warp_select(xs, k, sel)
            np.testing.assert_array_equal(v, jv[row] if sel else -jv[row])
            np.testing.assert_array_equal(c, ji[row])


def _odd_rows(seed, rows=64, n=300):
    """Integer rows with NaN, -NaN, ±inf and -0.0 against 0.0 cells and
    ties; rows 0-3 with 0, 1, 5 and 40 cells that are not NaN."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (rows, n)).astype(np.float32)
    for v, share in ((np.nan, 0.2), (-np.float32(np.nan), 0.05),
                     (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.15)):
        x[rng.random((rows, n)) < share] = v
    for r, keep in zip(range(4), (0, 1, 5, 40)):
        x[r, keep:] = np.nan
        x[r] = x[r, rng.permutation(n)]
    return x


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [1, 3, 20, 300])
def test_nan_and_signed_zero_order_matches_jax(k, select_min):
    """The port's select_k (its plain version on the CPU) against JAX's
    select_k (lax.top_k) on rows with NaN, -NaN, ±inf and -0.0 against
    0.0, at k under and over each row's count of cells that are not NaN:
    values bit for bit and ids equal (NaN after +inf in a min selection,
    first in a max one, -0.0 before 0.0 in a min one)."""
    x = _odd_rows(k + select_min)
    jv, ji = jax_select_k(jnp.asarray(x), k, select_min=select_min,
                          algo="topk")
    tv, ti = tsk.select_k(torch.from_numpy(x), k, select_min=select_min)
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_nan_order_on_the_measured_row():
    """The row the rule was measured on: [3, nan, 1, inf, nan, 2]."""
    x = torch.tensor([[3, np.nan, 1, np.inf, np.nan, 2]], dtype=torch.float32)
    _, i = tsk.select_k(x, 6, select_min=True)
    assert i.tolist() == [[2, 5, 0, 3, 1, 4]]
    v, i = tsk.select_k(x, 6, select_min=False)
    assert i.tolist() == [[1, 4, 3, 0, 5, 2]]
    assert torch.isnan(v[0, :2]).all() and v[0, 2:].tolist() == [
        np.inf, 3, 2, 1]


@pytest.mark.parametrize("select_min", [True, False])
def test_knn_merge_parts_nan_shards_match_jax(select_min):
    """knn_merge_parts of both packages on shards with NaN, ±inf and -0.0
    cells and a dead shard."""
    from raft_tpu.neighbors import brute_force as jbf
    from raft_tpu_torch.neighbors import brute_force as tbf

    rng = np.random.default_rng(3)
    d = _odd_rows(5, rows=3 * 24, n=9).reshape(3, 24, 9)
    d[2] = np.inf if select_min else -np.inf
    gid = rng.integers(0, 100_000, (3, 24, 9)).astype(np.int32)
    gid[2] = -1
    jv, ji = jbf.knn_merge_parts(jnp.asarray(d), jnp.asarray(gid),
                                 select_min)
    tv, ti = tbf.knn_merge_parts(torch.from_numpy(d), torch.from_numpy(gid),
                                 select_min)
    np.testing.assert_array_equal(tv.numpy().view(np.int32),
                                  np.asarray(jv).view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
