"""K1's radix select (``csrc/select_k.cu::radix_select_kernel``, the form
past k = 512) stated step by step in numpy, and held bit for bit against
the port's plain version (``select_k_plain``) and the JAX package: the
Pallas k-pass (``_kpass_2d``) in interpret mode, and ``lax.top_k`` on
rows with NaN, -NaN and -0.0.

The statement follows the kernel: each cell's key is its place in the
selection order as an unsigned 32-bit integer (IEEE totalOrder, inverted
for a max selection, the sign bit flipped); a round looks for the c-th key
(c <= the round's capacity) among the keys after the last (key, column)
written, a digit a pass (11, 11, then 10 bits), each pass a
histogram of the next digit of the keys that share the prefix found so
far, stopping once the bucket is one key or it and the keys below it make
c; a row read from device memory is read again until the keys at or below
the bucket fit in shared memory, then gathered there in column order and
the later passes read them; the round's keys are taken in column
order by a block-wide scan a tile (the keys below the prefix, then the
first ties at it); where the prefix is the whole c-th key its ties are
written out at once, and the keys below them, or else all the round's
keys, are sorted as 64-bit (key, column) keys by a bitonic network and
written. The round's capacity and the block's tile are
scaled down here so that rounds and tiles are many.

Tolerance: none. Selection does no arithmetic: values bit for bit, ids
equal, ties to the lowest column.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.matrix.select_k import _kpass_2d
from raft_tpu.matrix.select_k import select_k as jax_select_k
from raft_tpu_torch.matrix import select_k as tsk

torch.set_num_threads(1)

_M64 = (1 << 64) - 1
BITS = 11  # the digit: passes of 11, 11 and 10 bits


def radix_keys(row, select_min=True):
    """The kernel's radix_key: select_key's int bits with the sign bit
    flipped, as uint32."""
    b = row.astype(np.float32).view(np.int32).astype(np.int64)
    t = b ^ ((b >> 31) & 0x7fffffff)
    if not select_min:
        t = ~t
    return ((t & 0xffffffff) ^ 0x80000000).astype(np.uint64)


def key_values(u, select_min=True):
    """radix_value: the float whose key is u, bit for bit."""
    t = (u.astype(np.int64) ^ 0x80000000)
    t = np.where(t >= 1 << 31, t - (1 << 32), t)
    if not select_min:
        t = ~t
    b = t ^ ((t >> 31) & 0x7fffffff)
    return b.astype(np.int32).view(np.float32)


def above(u, sh):
    return np.zeros_like(u) if sh >= 32 else u >> np.uint64(sh)


def ordered_take(idx, lt, eq, krem, threads, quad=8):
    """The block-wide ordered compaction (take_round): tiles of
    threads x quad columns, each thread its quad consecutive columns; the
    counts packed (lt in the low 16 bits, eq in the high) and summed
    exclusively over the threads in order; the keys below the prefix to
    their running slot, the ties at it to theirs after all of them,
    only the first krem. Stops once every key is found."""
    tile = quad * threads
    less = int(lt.sum())
    out_lt, out_eq = [], []
    run_lt = run_eq = 0
    for base in range(0, len(idx), tile):
        if run_lt == less and run_eq >= krem:
            break
        sl = slice(base, base + tile)
        t_lt = np.zeros(tile, bool)
        t_eq = np.zeros(tile, bool)
        t_lt[:len(idx[sl])] = lt[sl]
        t_eq[:len(idx[sl])] = eq[sl]
        packed = (t_lt.reshape(threads, quad).sum(1)
                  | (t_eq.reshape(threads, quad).sum(1) << 16))
        ex = np.cumsum(packed) - packed
        total = int(packed.sum())
        for t in range(threads):
            at_lt = run_lt + (ex[t] & 0xffff)
            at_eq = run_eq + (ex[t] >> 16)
            for j in range(quad):
                e = quad * t + j
                if t_lt[e]:
                    assert at_lt == len(out_lt)
                    out_lt.append(idx[base + e])
                    at_lt += 1
                elif t_eq[e]:
                    if at_eq < krem:
                        assert at_eq == len(out_eq)
                        out_eq.append(idx[base + e])
                    at_eq += 1
        run_lt += total & 0xffff
        run_eq += total >> 16
    return np.array(out_lt + out_eq, np.int64)


def bitonic_sort(keys, local=128):
    """sort_round: a bitonic network over at least ``local`` keys (a warp's
    keys in registers, 32 lanes x the keys a thread holds), the next power
    of two, padded with the greatest 64-bit key; compare-exchange (i,
    i + j) ascending where i & s == 0. The kernel runs the steps of
    partners ``local`` apart or more in shared memory and the rest in
    registers: the same network."""
    p2 = max(local, 1 << max(0, (len(keys) - 1).bit_length()))
    a = np.full(p2, _M64, np.uint64)
    a[:len(keys)] = keys
    s = 2
    while s <= p2:
        j = s >> 1
        while j > 0:
            p = np.arange(p2 // 2)
            i = 2 * p - (p & (j - 1))
            x, y = a[i], a[i + j]
            swap = (x > y) == ((i & s) == 0)
            a[i], a[i + j] = np.where(swap, y, x), np.where(swap, x, y)
            j >>= 1
        s <<= 1
    return a[:len(keys)]


def radix_select(row, k, select_min=True, cap=2048, threads=512,
                 source="staged", gcap=0, stats=None):
    """The kernel on one row → (values, columns, each round's digit
    passes). source: "staged" (the row's keys in shared memory after the
    first read) or "device" (read from device memory every pass, the keys
    at or below the bucket gathered to at most gcap slots once they
    fit)."""
    u = radix_keys(row, select_min)
    n = len(u)
    cols = np.arange(n)
    out_u, out_c = [], []
    floor, written = None, 0
    while written < k:
        c = min(cap, k - written)
        if floor is None:
            alive = np.ones(n, bool)
        else:
            fu, fc = floor
            alive = (u > fu) | ((u == fu) & (cols > fc))
        pre, sh, less, krem = 0, 32, 0, c
        src = cols            # in column order: the row, its stage or
        limit = None          # the gathered keys
        passes = 0
        while True:
            nb = min(BITS, sh)
            sh2 = sh - nb
            a = above(u[src], sh)
            take = alive[src] & (a == pre)
            hist = np.bincount(((u[src][take] >> np.uint64(sh2))
                                & np.uint64((1 << nb) - 1)).astype(np.int64),
                               minlength=1 << nb)
            if limit is not None:  # this pass gathers
                src = src[alive[src] & (u[src] <= np.uint64(limit))]
                assert c <= len(src) <= gcap
                limit = None
            passes += 1
            cum = np.cumsum(hist)
            dig = int(np.argmax(cum >= krem))
            cnt = int(hist[dig])
            before = int(cum[dig]) - cnt
            less += before
            krem -= before
            pre = (pre << nb) | dig
            sh = sh2
            if sh == 0 or krem == cnt:
                break
            if source == "device" and len(src) == n and less + cnt <= gcap:
                # the keys at or below the bucket: prefix <= pre
                limit = (pre << sh) | ((1 << sh) - 1)
                assert len(src[alive[src] & (u[src] <= np.uint64(limit))]
                           ) == less + cnt
        a = above(u[src], sh)
        lt = alive[src] & (a < pre)
        eq = alive[src] & (a == pre)
        assert int(lt.sum()) == less
        taken = ordered_take(src, lt, eq, krem, threads)
        assert len(taken) == c
        keys = (u[taken] << np.uint64(32)) | taken.astype(np.uint64)
        # at the last bit the ties of the c-th key are written as taken
        # (in column order); the keys below them, or at a bucket all c,
        # are sorted
        cut = less if sh == 0 else c
        keys[:cut] = bitonic_sort(keys[:cut], 32 * (cap // threads))
        np.testing.assert_array_equal(keys, np.sort(keys))
        out_u.append(keys >> np.uint64(32))
        out_c.append((keys & np.uint64(0xffffffff)).astype(np.int64))
        floor = (out_u[-1][-1], out_c[-1][-1])
        written += c
        if stats is not None:
            stats.append(passes)
    uu = np.concatenate(out_u)
    return key_values(uu, select_min), np.concatenate(out_c).astype(
        np.int32)


def statement_rows(x, k, select_min=True, **kw):
    out = [radix_select(r, k, select_min, **kw) for r in x]
    return (np.stack([v for v, _ in out]), np.stack([c for _, c in out]))


def merge_rows(seed, rows, runs, k, n):
    """Integer rows with heavy ties and +inf cells; rows 0-7 built like
    the wide-k merges (sorted runs of k with +inf tails, cut to n
    columns), row 8 all +inf, row 9 one repeated value."""
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 60, (rows, n)).astype(np.float32)
    x[rng.random((rows, n)) < 0.1] = np.inf
    run = np.sort(rng.integers(0, 400, (8, runs, k)).astype(np.float32), 2)
    short = rng.integers(0, k, (8, runs, 1))
    run[np.arange(k)[None, None, :] >= short] = np.inf
    x[:8] = run.reshape(8, runs * k)[:, :n]
    x[8] = np.inf
    x[9] = 5.0
    return x


def odd_rows(seed, rows, n):
    """Rows of small integers with NaN, -NaN, ±inf and -0.0 against 0.0;
    rows 0-2 with 0, 9 and 700 cells that are not NaN."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-3, 4, (rows, n)).astype(np.float32)
    for v, share in ((np.nan, 0.2), (-np.float32(np.nan), 0.05),
                     (np.inf, 0.05), (-np.inf, 0.05), (-0.0, 0.15)):
        x[rng.random((rows, n)) < share] = v
    for r, keep in zip(range(3), (0, 9, 700)):
        x[r, keep:] = np.nan
        x[r] = x[r, rng.permutation(n)]
    return x


@functools.lru_cache(maxsize=None)
def _pallas(k, n):
    x = merge_rows(k + n, 130, 64, 64 + k % 64, n)
    jv, ji = _kpass_2d(jnp.asarray(x), k, True)
    return x, np.asarray(jv), np.asarray(ji)


def assert_bits(v, c, ref_v, ref_c):
    np.testing.assert_array_equal(np.asarray(v).view(np.int32),
                                  np.asarray(ref_v).view(np.int32))
    np.testing.assert_array_equal(np.asarray(c), np.asarray(ref_c))


@pytest.mark.parametrize("k,n", [(513, 1024), (600, 1500), (1025, 2048)])
def test_radix_statement_matches_pallas_kernel(k, n):
    """The statement (round capacity 128, tiles of 128 columns) on 130
    rows with ties, +inf cells, merge-like sorted runs with +inf tails,
    a row of all +inf and a row of one value, bit for bit against the
    Pallas k-pass in interpret mode and the port's kernel wrapper (its
    plain version on the CPU); the max selection through negation."""
    x, jv, ji = _pallas(k, n)
    sv, sc = statement_rows(x, k, cap=128, threads=32)
    assert_bits(sv, sc, jv, ji)
    tv, ti = tsk.kpass_select_k(torch.from_numpy(x), k)
    assert_bits(tv.numpy(), ti.numpy(), jv, ji)
    sv, sc = statement_rows(-x[:40], k, False, cap=128, threads=32)
    assert_bits(sv, sc, -jv[:40], ji[:40])


@pytest.mark.parametrize("k,n", [(600, 1500), (1025, 2048)])
@pytest.mark.parametrize("source,gcap", [("staged", 0), ("device", 0),
                                         ("device", 300),
                                         ("device", 4096)])
@pytest.mark.parametrize("select_min", [True, False])
def test_radix_statement_sources(k, n, source, gcap, select_min):
    """Every source (the row staged, read from device memory every pass,
    or its keys at or below the bucket gathered once they fit 300 or
    4,096 slots) gives the plain version's bits, in one round and in
    several."""
    x = merge_rows(7 + k, 24, 64, 64, n)
    x = x if select_min else -x
    pv, pi = tsk.select_k_plain(torch.from_numpy(x), k, select_min)
    sv, sc = statement_rows(x, k, select_min, cap=256, threads=64,
                            source=source, gcap=gcap)
    assert_bits(sv, sc, pv.numpy(), pi.numpy())


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("k", [513, 1025])
def test_radix_statement_nan_rows_match_jax(k, select_min):
    """Rows with NaN, -NaN, ±inf and -0.0 against 0.0, at k under and
    over a row's count of cells that are not NaN: the statement, the
    plain version and JAX's select_k (lax.top_k) bit for bit (NaN after
    +inf in a min selection and first in a max one, -0.0 before 0.0 in a
    min one)."""
    x = odd_rows(k + select_min, 16, 1600)
    jv, ji = jax_select_k(jnp.asarray(x), k, select_min=select_min,
                          algo="topk")
    sv, sc = statement_rows(x, k, select_min, cap=128, threads=32)
    assert_bits(sv, sc, jv, ji)
    pv, pi = tsk.select_k_plain(torch.from_numpy(x), k, select_min)
    assert_bits(pv.numpy(), pi.numpy(), jv, ji)


@pytest.mark.parametrize("cap", [64, 2048])
def test_radix_statement_every_column(cap):
    """k = n: every column comes out, in rounds to the row's end (one
    pass a round when the round takes every key left: the last bucket
    and the keys below it make c)."""
    n = 1000
    x = merge_rows(3, 10, 64, 64, n)
    for sel in (True, False):
        stats = []
        sv, sc = statement_rows(x, n, sel, cap=cap, threads=32,
                                stats=stats)
        pv, pi = tsk.select_k_plain(torch.from_numpy(x), n, sel)
        assert_bits(sv, sc, pv.numpy(), pi.numpy())
        if cap >= n:
            assert stats == [1] * len(x)


@pytest.mark.parametrize("k", [513, 700])
def test_radix_statement_digit_passes(k):
    """A round finds its key in at most three passes (11, 11, 10 bits),
    fewer where the bucket and the keys below it make c first."""
    x = merge_rows(11, 12, 64, 64, 1500)
    stats = []
    statement_rows(x, k, cap=2048, threads=32, stats=stats)
    assert max(stats) <= 3
    assert min(stats) >= 1


def test_bitonic_network_sorts_64_bit_keys():
    rng = np.random.default_rng(5)
    for c in (1, 2, 3, 100, 129, 1025, 4096):
        keys = rng.integers(0, 1 << 63, c, dtype=np.uint64) << np.uint64(1)
        for local in (32, 128):
            np.testing.assert_array_equal(bitonic_sort(keys, local),
                                          np.sort(keys))


def test_radix_keys_round_trip_and_order():
    """Every float's key maps back to its bits; unsigned key order is the
    selection order (select_k_plain's), both directions."""
    rng = np.random.default_rng(9)
    x = rng.integers(-(1 << 31), 1 << 31, 5000, dtype=np.int64).astype(
        np.int32).view(np.float32)
    x[:6] = [np.nan, -np.float32(np.nan), np.inf, -np.inf, 0.0, -0.0]
    for sel in (True, False):
        u = radix_keys(x, sel)
        assert_bits(key_values(u, sel), 0, x, 0)
        order = np.argsort(u, kind="stable")
        _, pi = tsk.select_k_plain(torch.from_numpy(x[None]), len(x), sel)
        np.testing.assert_array_equal(order, pi.numpy()[0])

