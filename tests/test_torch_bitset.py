"""The port's ``core.bitset.Bitset`` against ``raft_tpu.core.bitset``:
every method on the same bits, made from a seed with numpy, at lengths
that are not multiples of 32 (so the last word has bits past ``n_bits``).

Exact: both packages pack bit ``j`` of word ``w`` as row ``32 * w + j``,
so the words, the masks, the counts and the fingerprints (a digest of
the uint32 words' little-endian bytes and the length) are equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.errors import RaftError

torch.set_num_threads(1)

N_BITS = [1, 31, 33, 100, 1000, 4099]


def _pair(mask):
    return (JaxBitset.from_mask(jnp.asarray(mask)),
            Bitset.from_mask(torch.from_numpy(mask)))


def _mask(n, seed, p=0.4):
    return np.random.default_rng(seed).random(n) < p


def _words(jb):
    """JAX's words with the bits past n_bits cleared, as int64."""
    return np.asarray(jb._masked_words()).astype(np.int64)


def _same(jb, tb):
    assert tb.n_bits == jb.n_bits
    np.testing.assert_array_equal(tb.to_mask().numpy(),
                                  np.asarray(jb.to_mask()))
    np.testing.assert_array_equal(tb.words.numpy(), _words(jb))


def test_create_defaults_to_the_card():
    """With no ``device``, ``create`` places the words as every entry
    point does: on the card, and with no card it raises rather than fall
    back to the CPU."""
    if torch.cuda.is_available():
        assert Bitset.create(40).words.is_cuda
    else:
        with pytest.raises(RaftError):
            Bitset.create(40)


@pytest.mark.parametrize("n", N_BITS)
def test_from_mask_and_to_mask(n):
    jb, tb = _pair(_mask(n, n))
    _same(jb, tb)
    np.testing.assert_array_equal(tb.words.numpy(),
                                  np.asarray(jb.words).astype(np.int64))


@pytest.mark.parametrize("default", [True, False])
@pytest.mark.parametrize("n", N_BITS)
def test_create(n, default):
    _same(JaxBitset.create(n, default),
          Bitset.create(n, default, device="cpu"))


@pytest.mark.parametrize("n", N_BITS)
def test_test_reads_out_of_range_as_false(n):
    jb, tb = _pair(_mask(n, n + 1))
    idx = np.random.default_rng(n).integers(-3, n + 40, 300)
    idx[:4] = [-1, 0, n - 1, n]
    got = tb.test(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jb.test(jnp.asarray(
        idx, jnp.int32))))
    assert not got[idx < 0].any() and not got[idx >= n].any()
    assert tb.test(torch.tensor(-1)).shape == ()


@pytest.mark.parametrize("value", [True, False])
@pytest.mark.parametrize("n", N_BITS)
def test_set(n, value):
    jb, tb = _pair(_mask(n, n + 2))
    idx = np.unique(np.random.default_rng(n + 3).integers(0, n, 7))
    _same(jb.set(jnp.asarray(idx, jnp.int32), value),
          tb.set(torch.from_numpy(idx), value))
    # a scalar index, and the operand left as it was
    _same(jb.set(0, value), tb.set(0, value))
    _same(jb, tb)


@pytest.mark.parametrize("n", N_BITS)
def test_flip_count_any_all_none(n):
    jb, tb = _pair(_mask(n, n + 4))
    jf, tf = jb.flip(), tb.flip()
    _same(jf, tf)
    for j, t in ((jb, tb), (jf, tf)):
        assert int(t.count()) == int(j.count())
        assert bool(t.any()) == bool(j.any())
        assert bool(t.all()) == bool(j.all())
        assert bool(t.none()) == bool(j.none())
    for default in (True, False):
        j, t = JaxBitset.create(n, default), Bitset.create(n, default, "cpu")
        assert int(t.count()) == int(j.count()) == (n if default else 0)
        assert bool(t.all()) == bool(j.all()) == default
        assert bool(t.none()) == bool(j.none()) == (not default)
        assert bool(t.flip().any()) == bool(j.flip().any()) == (not default)


@pytest.mark.parametrize("n", N_BITS)
def test_count_by_segments_with_slack(n):
    """Ids include -1 (slack rows) and ids past n_bits: both count 0."""
    rng = np.random.default_rng(n + 5)
    jb, tb = _pair(_mask(n, n + 6))
    ids = rng.integers(-1, n + 20, 2048)
    ids[rng.random(2048) < 0.2] = -1
    seg = rng.integers(0, 12, 2048)
    got = tb.count_by_segments(torch.from_numpy(ids), torch.from_numpy(seg),
                               12).numpy()
    want = np.asarray(jb.count_by_segments(jnp.asarray(ids, jnp.int32),
                                           jnp.asarray(seg, jnp.int32), 12))
    np.testing.assert_array_equal(got, want)
    mask = np.asarray(jb.to_mask())
    ok = (ids >= 0) & (ids < n)
    assert got.sum() == mask[ids[ok]].sum()


@pytest.mark.parametrize("n", N_BITS)
def test_fingerprint_equals_jax(n):
    mask = _mask(n, n + 7)
    jb, tb = _pair(mask)
    assert tb.fingerprint() == jb.fingerprint()
    # the same rows, made another way: the same digest; one bit more: not
    same = Bitset.create(n, False, "cpu").set(
        torch.from_numpy(np.nonzero(mask)[0]))
    assert same.fingerprint() == tb.fingerprint()
    other = tb.set(n // 2, not mask[n // 2])
    assert other.fingerprint() != tb.fingerprint()
    assert other.fingerprint() == jb.set(n // 2, not mask[n // 2]) \
        .fingerprint()
    # flip's cleared tail: the JAX flip's digest too
    assert tb.flip().fingerprint() == jb.flip().fingerprint()


def test_fingerprint_names_the_length():
    assert (Bitset.create(32, False, "cpu").fingerprint()
            != Bitset.create(31, False, "cpu").fingerprint())
