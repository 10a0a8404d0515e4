"""The selection of K4's grouped form past k = 256
(``raft_tpu_torch/csrc/list_select.cuh``), stated in numpy step by step
and held against a stable sort, on the CPU.

The kernel's rule, a pair at a time: order keys of the distances (+inf and
NaN never taken, -0.0 keyed as 0.0); the bits every taken key shares from
the pair's least and greatest key; histogram passes of 10 bits below them
until the k-th key's bucket and the keys below it fit 512 (or every bit
is spent: the bucket is the k-th key); the keys below the bucket sorted by
(key, row), then the bucket's sorted (or, at the last bit, its first ties
in row order); the first k with their values, (+inf, -1) after (a list of
at most k taken keys keeps them all, sorted). The statement here is the card tests' oracle for the
rule itself: the cases that break a histogram select — lists around k,
keys on the buckets' edges, hundreds of ties at the k-th value, every row
equal, +inf and NaN on most rows, -0.0 beside 0.0, negative values — must
give the sorted order of the streaming selection it replaced.
"""
import numpy as np
import pytest

NONE = 0xFFFFFFFF
DIGIT, CAP = 10, 512


def order_key(v: np.ndarray) -> np.ndarray:
    """list_select.cuh::order_key over a float32 array → uint32 keys."""
    v = np.asarray(v, np.float32)
    u = v.view(np.uint32).copy()
    u[u == 0x80000000] = 0
    key = np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)
    return np.where(v < np.inf, key, np.uint32(NONE)).astype(np.uint32)


def above(key, sh: int):
    return np.zeros_like(key) if sh >= 32 else key >> np.uint32(sh)


def select_row(d: np.ndarray, k: int):
    """select_row's steps → (values, rows, histogram passes, keys sorted)."""
    d = np.asarray(d, np.float32)
    keys = order_key(d)
    ok = keys != NONE
    out_v = np.full(k, np.inf, np.float32)
    out_i = np.full(k, -1, np.int64)
    if not ok.any():
        return out_v, out_i, 0, 0
    lo, hi = int(keys[ok].min()), int(keys[ok].max())
    sh = (lo ^ hi).bit_length()
    pre = lo >> sh if sh < 32 else 0
    less, krem, bucket, passes, every = 0, k, 0, 0, False
    while True:
        nb = min(sh, DIGIT)
        sh2 = sh - nb
        live = ok & (above(keys, sh) == pre)
        digit = (keys[live] >> np.uint32(sh2)) & np.uint32((1 << nb) - 1)
        hist = np.bincount(digit.astype(np.int64), minlength=1 << DIGIT)
        passes += 1
        if passes == 1 and hist.sum() <= k:
            every = True
            break
        cum = np.cumsum(hist)
        dig = int(np.argmax(cum >= krem))
        before = int(cum[dig] - hist[dig])
        bucket = int(hist[dig])
        less += before
        krem -= before
        pre = pre if nb == 0 else (pre << nb) | dig
        sh = sh2
        if sh == 0 or less + bucket <= CAP:
            break
    by_key = lambda rows: rows[np.lexsort((rows, keys[rows]))]  # noqa: E731
    if every:
        lt, eq = by_key(np.flatnonzero(ok)), np.zeros(0, np.int64)
    else:
        a = above(keys, sh)
        lt = by_key(np.flatnonzero(ok & (a < pre)))
        eq = np.flatnonzero(ok & (a == pre))   # the bucket, in row order
        # the bucket sorted, unless it is the k-th key: its ties in row
        # order, the first krem of them
        eq = by_key(eq) if sh > 0 else eq[:krem]
        assert len(lt) == less and len(lt) + len(eq) >= k
        assert len(lt) + len(eq) <= CAP or sh == 0
    sel = np.concatenate([lt, eq])[:k]
    out_v[:len(sel)] = d[sel]
    out_i[:len(sel)] = sel
    return out_v, out_i, passes, (len(lt), len(eq))


def reference(d: np.ndarray, k: int):
    """The streaming selection's order: values below +inf (no NaN) by
    (value, row) under the float compare (-0.0 equal to 0.0), values
    written as computed; (+inf, -1) after."""
    d = np.asarray(d, np.float32)
    rows = np.flatnonzero(d < np.inf)
    canon = d[rows] + np.float32(0.0)  # -0.0 -> 0.0 for the order only
    sel = rows[np.lexsort((rows, canon))][:k]
    out_v = np.full(k, np.inf, np.float32)
    out_i = np.full(k, -1, np.int64)
    out_v[:len(sel)] = d[sel]
    out_i[:len(sel)] = sel
    return out_v, out_i


def edge_keys(rng, n: int, k: int) -> np.ndarray:
    """Distances whose keys sit on 10-bit bucket edges around the k-th:
    a base key and keys one below and at multiples of 2^10 and 2^20 off."""
    base = int(order_key(np.float32(123.5))[()])
    offs = rng.choice([-(1 << 20), -(1 << 10), -1, 0, 1, 1 << 10,
                       (1 << 10) - 1, 1 << 20], n)
    keys = (base + offs).astype(np.uint32)
    u = np.where(keys & 0x80000000, keys & 0x7FFFFFFF, ~keys)
    return u.astype(np.uint32).view(np.float32)


def case(name: str, n: int, k: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if name == "gauss":
        return (100 + 30 * rng.standard_normal(n)).astype(np.float32)
    if name == "ties":  # hundreds tie at the k-th value, scattered
        d = rng.uniform(200, 300, n).astype(np.float32)
        d[rng.permutation(n)[:min(n, 600)]] = 150.0
        d[rng.permutation(n)[:min(n, k // 2)]] = rng.uniform(0, 100)
        return d
    if name == "equal":
        return np.full(n, 7.25, np.float32)
    if name == "mostly_inf":
        d = rng.uniform(0, 50, n).astype(np.float32)
        d[rng.random(n) < 0.9] = np.inf
        d[rng.random(n) < 0.05] = np.nan
        return d
    if name == "zeros":  # -0.0 and 0.0 tie, negatives before them
        d = rng.choice(np.array([-0.0, 0.0, -1.5, 3.0], np.float32), n)
        d[rng.random(n) < 0.1] = -np.inf
        return d.astype(np.float32)
    if name == "signs":  # keys that differ in the top bit
        return rng.standard_normal(n).astype(np.float32) * np.float32(1e3)
    if name == "edges":
        return edge_keys(rng, n, k)
    raise ValueError(name)


CASES = ("gauss", "ties", "equal", "mostly_inf", "zeros", "signs", "edges")


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("k", [257, 300, 512])
def test_select_row_matches_the_stable_order(name, k):
    """Every list length the card tests cut (0, 1, k - 1, k, k + 1, 2k,
    3,000) and 511–513 around the widest sort: the statement equals
    the streaming selection's order, slot by slot, values bit for bit."""
    for n in sorted({0, 1, k - 1, k, k + 1, 2 * k, 3000, 511, 512, 513}):
        d = case(name, n, k, seed=n + k)
        v, i, _, _ = select_row(d, k)
        rv, ri = reference(d, k)
        np.testing.assert_array_equal(i, ri, err_msg=f"{name} n={n}")
        np.testing.assert_array_equal(v.view(np.uint32),
                                      rv.view(np.uint32))


@pytest.mark.parametrize("n", [800, 1590, 5000])
def test_select_row_passes_on_real_distances(n):
    """On distances spread as a list's are (two octaves below the shared
    bits), one histogram pass leaves the k-th key's bucket with a few keys
    (so the kernel reads such a list twice: the pass and the compaction),
    and the sorts take the keys below it (fewer than k: 256 keys wide at
    k = 257) and the bucket's (32 wide); hundreds of ties at the k-th value
    spend every bit and keep their first in row order after the keys below
    it."""
    rng = np.random.default_rng(n)
    d = np.sort(rng.uniform(100, 400, 64)).astype(np.float32)
    d = (d[rng.integers(0, 64, n)] +
         rng.standard_normal(n).astype(np.float32) * 5).astype(np.float32)
    v, i, passes, (n_lt, n_bucket) = select_row(d, 257)
    rv, ri = reference(d, 257)
    np.testing.assert_array_equal(i, ri)
    assert passes == 1 and n_lt <= 256 and 1 <= n_bucket <= 32
    t = case("ties", n, 257, seed=n)
    v, i, passes, (n_lt, n_eq) = select_row(t, 257)
    rv, ri = reference(t, 257)
    np.testing.assert_array_equal(i, ri)
    assert n_lt < 257 and n_lt + n_eq == 257 and passes >= 2


def test_order_key_orders_as_the_float_compare():
    """Ascending keys are ascending values; -0.0 and 0.0 share a key;
    +inf and NaN take the key no candidate has."""
    vals = np.array([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0,
                     3e38], np.float32)
    keys = order_key(vals)
    assert (np.diff(keys.astype(np.int64)) >= 0).all()
    assert keys[4] == keys[5] and len(set(keys.tolist())) == len(vals) - 1
    assert (order_key(np.array([np.inf, np.nan, -np.nan], np.float32))
            == NONE).all()
