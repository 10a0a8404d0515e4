"""Packed sample-filter bitset: counterpart of ``raft_tpu/core/bitset.py``
(``Bitset.from_mask`` / ``to_mask`` only).

Bits are packed 32 to a word, bit ``j`` of word ``w`` standing for row
``32 * w + j`` as in the JAX package. Words are kept in an int64 tensor
holding the unsigned 32-bit value, because torch has no full uint32
arithmetic. A filter reaches the kernels as the additive penalty row the
search modules build from :meth:`Bitset.to_mask`.
"""
from __future__ import annotations

import torch

from ..utils import cdiv

__all__ = ["Bitset"]

_BITS = 32


class Bitset:
    """Fixed-length bitset; a set bit keeps its row, a clear bit filters
    it out."""

    def __init__(self, words: torch.Tensor, n_bits: int):
        self.words = words
        self.n_bits = n_bits

    @classmethod
    def from_mask(cls, mask: torch.Tensor) -> "Bitset":
        """Pack a boolean vector (n_bits,) into a bitset."""
        mask = torch.as_tensor(mask)
        n_bits = mask.shape[0]
        n_words = cdiv(n_bits, _BITS)
        m = torch.zeros(n_words * _BITS, dtype=torch.int64,
                        device=mask.device)
        m[:n_bits] = mask.to(torch.int64)
        shifts = torch.arange(_BITS, dtype=torch.int64, device=mask.device)
        words = (m.reshape(n_words, _BITS) << shifts).sum(dim=1)
        return cls(words, n_bits)

    def to(self, device) -> "Bitset":
        return Bitset(self.words.to(device), self.n_bits)

    def to_mask(self) -> torch.Tensor:
        """Unpack to a boolean vector of shape (n_bits,)."""
        shifts = torch.arange(_BITS, dtype=torch.int64,
                              device=self.words.device)
        bits = (self.words[:, None] >> shifts[None, :]) & 1
        return bits.reshape(-1)[: self.n_bits].to(torch.bool)
