"""The in-register widening of K2's and K3's store forms
(``csrc/tf32_tile.cuh``, ``widen_lane``, ``widen_bf16`` and the bf16
fragments), stated bit for bit in torch integer ops and held over every
stored value against ``ops/quant.py``'s dequantization to f32 at a scale
of 1.

A lane of the kernel holds a 32-bit word of four stored bytes and widens
its byte t4 (0..3): ``prmt(x, 0x4b000000, 0x7540 | t4)`` puts that byte
into the mantissa of 2^23 (the word 0x4b0000XX is the float 2^23 + XX),
and one f32 subtraction leaves the value:

* uint8: the byte as it is, minus 2^23;
* int8: the byte xored with 0x80 (so -128..127 becomes 0..255), minus
  2^23 + 128;
* int4: the low nibble of the byte (or the high one, for the high half's
  stage) xored into 0x4b000008, minus 2^23 + 8;
* bf16: the 16 stored bits shifted into the top of an f32 word (K2's bf16
  products take the stored bits as they are; this is the same value).
  K3's TF32 fragments take, for lane t4, the halfwords of dimensions t4
  and t4 + 4 of each 8 from the two 16-byte chunks of a row's 16
  dimensions: ``prmt(a, b, (2·t4 + 1) << 12 | 2·t4 << 8) & 0xffff0000``
  over a word pair (a, b) of a chunk.

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


def byte_perm_words(x: torch.Tensor, y: torch.Tensor, sel: int
                    ) -> torch.Tensor:
    """``__byte_perm(x, y, sel)`` over two int64-held 32-bit word
    tensors."""
    pool = [(w >> (8 * b)) & 0xFF for w in (x, y) for b in range(4)]
    out = torch.zeros_like(x)
    for i in range(4):
        out |= pool[(sel >> (4 * i)) & 7] << (8 * i)
    return out


def widen_bf16(a: torch.Tensor, b: torch.Tensor, t4: int) -> torch.Tensor:
    """``widen_bf16(a, b, t4)``: halfword t4 of the word pair (a's low,
    a's high, b's low, b's high) in the top of an f32 word."""
    sel = ((2 * t4 + 1) << 12) | ((2 * t4) << 8)
    return as_f32(byte_perm_words(a, b, sel) & 0xFFFF0000)


def test_bf16_fragment_lanes_take_their_dimensions():
    """K3's bf16 B fragments (``stage_dots_bytes<MF, kBF16>``): a row's 16
    dimensions are two 16-byte chunks of 4 words (dimensions 2w and 2w + 1
    in word w's low and high halves); lane t4 widens, for each 8-dimension
    step u and register h, the pair (word 2h, word 2h + 1) of chunk u into
    dimension 8u + 4h + t4 — the TF32 fragment's dimensions t4 and t4 + 4
    of each 8. Over every bf16 bit pattern but NaNs, each such value is
    ``quant.dequantize_rows``'s f32 of that dimension, bit for bit."""
    bits = torch.arange(1 << 16, dtype=torch.int64)
    keep = ~torch.isnan(bits.to(torch.int16).view(torch.bfloat16))
    bits = bits[keep]
    bits = torch.cat([bits, bits[:(-len(bits)) % 16]]).reshape(-1, 16)
    stored = bits.to(torch.int16).view(torch.bfloat16)
    ref = quant.dequantize_rows(stored, None)              # (rows, 16)
    words = bits[:, 0::2] | (bits[:, 1::2] << 16)          # (rows, 8)
    for t4 in range(4):
        for u in range(2):
            for h in range(2):
                a = words[:, 4 * u + 2 * h]
                b = words[:, 4 * u + 2 * h + 1]
                got = widen_bf16(a, b, t4)
                want = ref[:, 8 * u + 4 * h + t4]
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (t4, u, h)
