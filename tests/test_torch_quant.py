"""The storage codecs of the PyTorch port (``raft_tpu_torch.ops.quant``)
against the JAX package's (``raft_tpu.ops.quant``).

Tolerance: none. The same numpy rows go through both packages, and the
codes, scales, packed widths, nibble planes, dequantized rows and health
summaries must be equal bit for bit (``torch.round`` and ``jnp.round``
both round half to even; the int4 bytes are packed in int32 and
reinterpreted on both sides).

The PQ row codecs, on JAX's codebooks fed to both sides: the decode
table, its int8 form and the decoded norms bit for bit (the norms sum in
XLA's CPU order), the codes equal on integer-valued rows and codebooks
and, on Gaussian rows, on at least 99.9% of the (row, subspace) cells
(float32 distances in another order can flip a near tie; 100% at these
seeds). Training draws its init from ``torch.Generator``, not JAX's
threefry, so it is held by quality: exact when the book covers the
corpus (JAX's own contract), and a mean squared quantization error
within 1.10x of JAX's on the same rows (1.003-1.029x measured).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import quant as jq
from raft_tpu_torch.core.errors import RaftError
from raft_tpu_torch.ops import quant as tq

torch.set_num_threads(1)

DIMS = (32, 100, 128)


def _rows(store: str, d: int, seed: int = 0) -> np.ndarray:
    """Rows a store takes: bytes for uint8; Gaussian rows with exact
    halves mixed in (round-half-to-even cases) for the others."""
    rng = np.random.default_rng(seed + d)
    if store == "uint8":
        return rng.integers(0, 256, (300, d)).astype(np.float32)
    x = rng.standard_normal((300, d)).astype(np.float32) * 3
    x[:40] = np.round(x[:40] * 2) / 2
    x[5] = 0.0                                   # an all-zero row
    return x


def _jax_dtype(store: str):
    return "int4" if store == "int4" else getattr(jnp, store)


def _bits(a) -> np.ndarray:
    """The stored bits: bf16 as 16-bit words, others as they are."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("store", ["float32", "bfloat16", "int8", "uint8",
                                   "int4"])
def test_codes_and_scales_match_jax(store, d):
    x = _rows(store, d)
    jr, js = jq.quantize_rows(jnp.asarray(x), _jax_dtype(store))
    tr, ts = tq.quantize_rows(torch.from_numpy(x), store)
    assert tr.dtype == tq.STORES[store]
    np.testing.assert_array_equal(_bits(tr), _bits(jr))
    assert (ts is None) == (js is None)
    if js is not None:
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    if store == "int4":
        deq_j = jq.dequantize_int4(jr, js, d)
        deq_t = tq.dequantize_int4(tr, ts, d)
    else:
        deq_j = jq.dequantize_rows(jr, js)
        deq_t = tq.dequantize_rows(tr, ts)
    np.testing.assert_array_equal(deq_t.numpy(), np.asarray(deq_j))
    np.testing.assert_array_equal(
        tq.dequantize_store(tr, ts, d if store == "int4" else None).numpy(),
        np.asarray(deq_j))


@pytest.mark.parametrize("d", (1, 2, 32, 100, 127, 128, 129, 300))
def test_int4_half_width_matches_jax(d):
    assert tq.int4_half_width(d) == jq.int4_half_width(d)
    assert tq.int4_half_width(d) % 64 == 0


def test_int4_nibbles_every_byte():
    """Every byte value: the low and high planes are sign-extended
    nibbles, as JAX's arithmetic shifts give them."""
    b = np.arange(-128, 128, dtype=np.int8).reshape(16, 16)
    jl, jh = jq.int4_nibbles(jnp.asarray(b).astype(jnp.int32))
    tl, th = tq.int4_nibbles(torch.from_numpy(b))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    assert tl.min() == -8 and tl.max() == 7 and th.min() == -8


def test_int4_roundtrip_within_half_a_step():
    """JAX's own bound (tests/test_quant_ladder.py): each component of
    the dequantized row within half its row's step."""
    x = np.random.default_rng(0).normal(size=(300, 100)).astype(np.float32)
    packed, scales = tq.quantize_int4(torch.from_numpy(x))
    assert packed.shape == (300, tq.int4_half_width(100))
    assert packed.dtype == torch.int8
    deq = tq.dequantize_int4(packed, scales, 100).numpy()
    assert (np.abs(deq - x) <= scales.numpy()[:, None] / 2 + 1e-6).all()


def test_uint8_refuses_data_that_is_not_bytes():
    x = torch.from_numpy(_rows("uint8", 32))
    tq.quantize_rows(x, "uint8")                 # bytes: taken
    for bad in (x + 0.25, x - 256.0, x + 300.0):
        with pytest.raises(RaftError, match="byte-valued"):
            tq.quantize_rows(bad, "uint8")


def test_store_names():
    for name, dt in tq.STORES.items():
        assert tq.store_dtype(name) == name
        if name != "int4":
            assert tq.store_dtype(dt) == name
    assert tq.store_dtype("i4") == "int4"
    with pytest.raises(RaftError):
        tq.store_dtype("fp8")
    with pytest.raises(RaftError):
        tq.store_dtype(torch.float16)


def test_int8_scale_report_matches_jax():
    x = _rows("int8", 100)
    _, js = jq.quantize_rows(jnp.asarray(x), jnp.int8)
    _, ts = tq.quantize_rows(torch.from_numpy(x), "int8")
    assert tq.int8_scale_report(ts) == jq.int8_scale_report(js)


# --- the PQ row codecs (CAGRA's pq edge store)

PQ_SHAPES = [(64, 8), (100, 4), (128, 16), (128, 64), (256, 32)]


def _jax_books(d: int, pq_dim: int, seed: int = 0):
    rng = np.random.default_rng(seed + d + pq_dim)
    x = rng.standard_normal((1500, d)).astype(np.float32) * 3
    return x, np.asarray(jq.train_pq_rows(x, pq_dim, iters=4))


@pytest.mark.parametrize("d,pq_dim", PQ_SHAPES)
def test_pq_tables_and_norms_match_jax(d, pq_dim):
    x, books = _jax_books(d, pq_dim)
    tb = torch.from_numpy(books.copy())
    jt = np.asarray(jq.pq_decode_table(books))
    tt = tq.pq_decode_table(tb)
    np.testing.assert_array_equal(tt.numpy().view(np.int32),
                                  jt.view(np.int32))
    j8, js = jq.pq_int8_cb(jnp.asarray(jt), pq_dim, books.shape[1])
    t8, ts = tq.pq_int8_cb(tt, pq_dim, books.shape[1])
    np.testing.assert_array_equal(t8.numpy(), np.asarray(j8))
    np.testing.assert_array_equal(ts.numpy().view(np.int32),
                                  np.asarray(js).view(np.int32))
    codes = np.asarray(jq.encode_pq_rows(x, books))
    jn = np.asarray(jq.pq_decoded_norms(codes, books))
    tn = tq.pq_decoded_norms(torch.from_numpy(codes.copy()), tb)
    np.testing.assert_array_equal(tn.numpy().view(np.int32),
                                  jn.view(np.int32))
    # the compact form holds the tables' numbers: the codebooks for f32,
    # the int8 table's non-zero blocks with one scale a subspace
    cf, none = tq.pq_compact_cb(tt, None, pq_dim)
    assert none is None and torch.equal(cf, tb)
    c8, cs = tq.pq_compact_cb(t8, ts, pq_dim)
    pq_len = jt.shape[1] // pq_dim
    for s in range(pq_dim):
        blk = np.asarray(j8)[s * books.shape[1]:(s + 1) * books.shape[1],
                             s * pq_len:(s + 1) * pq_len]
        np.testing.assert_array_equal(c8[s].numpy(), blk)
        assert float(cs[s]) == float(np.asarray(js)[0, s * pq_len])


@pytest.mark.parametrize("d,pq_dim", PQ_SHAPES)
def test_pq_int8_books_is_the_compact_int8_table(d, pq_dim):
    """The codebooks quantized straight into the compact int8 form give
    the bits of JAX's int8 decode table cut to its non-zero blocks."""
    _, books = _jax_books(d, pq_dim)
    tb = torch.from_numpy(books.copy())
    c8, cs = tq.pq_compact_cb(*tq.pq_int8_cb(tq.pq_decode_table(tb), pq_dim,
                                             books.shape[1]), pq_dim)
    b8, bs = tq.pq_int8_books(tb)
    assert b8.dtype == torch.int8 and torch.equal(b8, c8)
    np.testing.assert_array_equal(bs.numpy().view(np.int32),
                                  cs.numpy().view(np.int32))


@pytest.mark.parametrize("d,pq_dim", PQ_SHAPES)
def test_encode_pq_rows_matches_jax(d, pq_dim):
    x, books = _jax_books(d, pq_dim)
    jc = np.asarray(jq.encode_pq_rows(x, books))
    tc = tq.encode_pq_rows(torch.from_numpy(x), torch.from_numpy(books),
                           chunk=512)
    assert tc.dtype == torch.uint8 and tc.shape == jc.shape
    assert (tc.numpy() == jc).mean() >= 0.999
    # integer-valued rows and codebooks: every distance is exact
    rng = np.random.default_rng(d)
    xi = rng.integers(-6, 7, (700, d)).astype(np.float32)
    bi = rng.integers(-6, 7, books.shape).astype(np.float32)
    np.testing.assert_array_equal(
        tq.encode_pq_rows(torch.from_numpy(xi), torch.from_numpy(bi),
                          chunk=256).numpy(),
        np.asarray(jq.encode_pq_rows(xi, bi)))


def test_default_pq_dim_matches_jax():
    for d in (8, 24, 64, 100, 128, 200, 512, 960, 2048):
        assert tq.default_pq_dim(d) == jq.default_pq_dim(d)


def test_train_pq_rows_exact_when_book_covers_corpus():
    """JAX's contract: with more codewords than rows, every row decodes
    to itself."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((100, 64)).astype(np.float32)
    books = tq.train_pq_rows(torch.from_numpy(x), 8)
    assert books.shape == (8, 100, 16)
    codes = tq.encode_pq_rows(torch.from_numpy(x), books).long()
    dec = torch.cat([books[s][codes[:, s]] for s in range(8)], dim=1)
    assert float((dec[:, :64] - torch.from_numpy(x)).abs().max()) < 1e-4


@pytest.mark.parametrize("d,pq_dim", [(64, 8), (128, 16), (128, 64)])
def test_train_pq_rows_quality_tracks_jax(d, pq_dim):
    rng = np.random.default_rng(d * pq_dim)
    x = rng.standard_normal((3000, d)).astype(np.float32) * 3

    def mse(books, codes):
        dec = np.concatenate([books[s][codes[:, s]]
                              for s in range(pq_dim)], axis=1)[:, :d]
        return float(((dec - x) ** 2).sum(1).mean())

    jb = np.asarray(jq.train_pq_rows(x, pq_dim, iters=8, train_rows=2000))
    tb = tq.train_pq_rows(torch.from_numpy(x), pq_dim, iters=8,
                          train_rows=2000)
    assert tb.shape == jb.shape
    j = mse(jb, np.asarray(jq.encode_pq_rows(x, jb)))
    t = mse(tb.numpy(), tq.encode_pq_rows(torch.from_numpy(x), tb).numpy())
    assert t <= 1.10 * j, (t, j)
