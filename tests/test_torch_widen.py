"""The in-register widening of K2's store forms (``csrc/tf32_tile.cuh``,
``widen_lane`` and the bf16 fragments), stated bit for bit in torch
integer ops and held over every stored value against ``ops/quant.py``'s
dequantization to f32 at a scale of 1.

A lane of the kernel holds a 32-bit word of four stored bytes and widens
its byte t4 (0..3): ``prmt(x, 0x4b000000, 0x7540 | t4)`` puts that byte
into the mantissa of 2^23 (the word 0x4b0000XX is the float 2^23 + XX),
and one f32 subtraction leaves the value:

* uint8: the byte as it is, minus 2^23;
* int8: the byte xored with 0x80 (so -128..127 becomes 0..255), minus
  2^23 + 128;
* int4: the low nibble of the byte (or the high one, for the high half's
  stage) xored into 0x4b000008, minus 2^23 + 8;
* bf16: the 16 stored bits shifted into the top of an f32 word (the bf16
  products take the stored bits as they are; this is the same value).

Tolerance: none; every step is exact in f32.
"""
import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import quant

MAGIC = 0x4B000000


def byte_perm(x: torch.Tensor, y: int, sel: int) -> torch.Tensor:
    """CUDA's ``__byte_perm(x, y, sel)`` on int64-held 32-bit words: byte
    i of the result is byte ``(sel >> 4·i) & 7`` of the eight bytes
    (x's four, then y's four)."""
    pool = [(x >> (8 * b)) & 0xFF for b in range(4)] + [
        torch.full_like(x, (y >> (8 * b)) & 0xFF) for b in range(4)]
    out = torch.zeros_like(x)
    for i in range(4):
        out |= pool[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def as_f32(bits: torch.Tensor) -> torch.Tensor:
    return bits.to(torch.int32).view(torch.float32)


def widen_lane(words: torch.Tensor, t4: int, store: str,
               hi: bool = False) -> torch.Tensor:
    """``widen_lane<S>(w, t4, hi)``: byte t4 of each 32-bit word (int64
    tensor) as the exact f32 the kernel's fragment holds."""
    if store == "int4":
        m = ((words >> (8 * t4 + (4 if hi else 0))) & 0xF) ^ (MAGIC | 8)
        return as_f32(m) - np.float32(2 ** 23 + 8)
    x = words ^ 0x80808080 if store == "int8" else words
    m = byte_perm(x, MAGIC, 0x7540 | t4)
    return as_f32(m) - np.float32(2 ** 23 + (128 if store == "int8" else 0))


def every_byte_in_words(dtype):
    """All 256 byte values, four to a word, each byte at every place of a
    word once: (stored bytes (256,), words (4, 64) int64 where word w of
    rotation t has the byte 4·w + (i - t) % 4 at place i)."""
    b = torch.arange(256, dtype=torch.int64)
    stored = b.to(torch.uint8).view(dtype) if dtype != torch.uint8 else \
        b.to(torch.uint8)
    quads = b.reshape(64, 4)
    words = torch.stack([
        sum(quads[:, (i - t) % 4] << (8 * i) for i in range(4))
        for t in range(4)])
    return stored, quads, words


@pytest.mark.parametrize("store", ["uint8", "int8"])
def test_byte_widening_matches_dequantization(store):
    """Every byte value at every place of a word widens to the value
    ``quant.dequantize_rows`` gives its stored byte."""
    dtype = quant.STORES[store]
    stored, quads, words = every_byte_in_words(dtype)
    ref = quant.dequantize_rows(stored[None, :], None)[0]
    for t in range(4):
        for t4 in range(4):
            got = widen_lane(words[t], t4, store)
            # byte t4 of word w is the stored byte 4·w + (t4 - t) % 4
            want = ref[quads[:, (t4 - t) % 4]]
            assert torch.equal(got.view(torch.int32),
                               want.view(torch.int32)), (t, t4)


def test_int4_widening_matches_dequantization():
    """Both nibbles of every byte value at every place of a word widen to
    the values ``quant.dequantize_int4`` gives (scale 1): the low nibble
    to the row's low half, the high nibble to its high half."""
    stored, quads, words = every_byte_in_words(torch.int8)
    rows = stored.reshape(1, 256)
    full = quant.dequantize_int4(rows, torch.ones(1), 512)[0]
    low, high = full[:256], full[256:]
    for t in range(4):
        for t4 in range(4):
            idx = quads[:, (t4 - t) % 4]
            for hi, want in ((False, low[idx]), (True, high[idx])):
                got = widen_lane(words[t], t4, "int4", hi)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (t, t4, hi)


def test_bf16_widening_matches_dequantization():
    """Every bf16 bit pattern but NaNs, shifted into the top half of an
    f32 word, is ``quant.dequantize_rows``'s f32 (bf16 products read the
    stored bits as they are)."""
    bits = torch.arange(1 << 16, dtype=torch.int64)
    stored = bits.to(torch.int16).view(torch.bfloat16)
    keep = ~torch.isnan(stored)
    ref = quant.dequantize_rows(stored[keep][None, :], None)[0]
    got = as_f32(bits[keep] << 16)
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
