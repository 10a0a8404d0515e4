"""The storage codecs of the PyTorch port (``raft_tpu_torch.ops.quant``)
against the JAX package's (``raft_tpu.ops.quant``).

Tolerance: none. The same numpy rows go through both packages, and the
codes, scales, packed widths, nibble planes, dequantized rows and health
summaries must be equal bit for bit (``torch.round`` and ``jnp.round``
both round half to even; the int4 bytes are packed in int32 and
reinterpreted on both sides).
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
