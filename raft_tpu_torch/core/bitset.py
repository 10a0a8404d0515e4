"""Packed sample-filter bitset: counterpart of ``raft_tpu/core/bitset.py``
(``Bitset``: ``create``, ``from_mask``, ``test``, ``set``, ``flip``,
``to_mask``, ``count``, ``count_by_segments``, ``fingerprint``, ``any``,
``all``, ``none``; ``to`` is the port's own).

Bits are packed 32 to a word, bit ``j`` of word ``w`` standing for row
``32 * w + j`` as in the JAX package, and bits past ``n_bits`` in the last
word are zero after every operation here. Words are kept in an int64
tensor holding the unsigned 32-bit value, because torch has no full
uint32 arithmetic; their values, and so :meth:`Bitset.fingerprint`, equal
the JAX package's (which hashes its uint32 words as little-endian bytes).
A filter reaches the kernels as the additive penalty row the search
modules build from :meth:`Bitset.to_mask`. Every operation returns a new
bitset and leaves its operand as it was.
"""
from __future__ import annotations

import hashlib

import numpy as np
import torch

from ..utils import cdiv, resolve_device

__all__ = ["Bitset"]

_BITS = 32
_WORD = (1 << _BITS) - 1


class Bitset:
    """Fixed-length bitset; a set bit keeps its row, a clear bit filters
    it out."""

    def __init__(self, words: torch.Tensor, n_bits: int):
        self.words = words
        self.n_bits = n_bits

    @classmethod
    def create(cls, n_bits: int, default: bool = True,
               device=None) -> "Bitset":
        """All set (``default``, the reference's "nothing filtered") or
        all clear, on ``device`` (the card unless the caller asks for the
        CPU)."""
        n_words = cdiv(n_bits, _BITS)
        words = torch.full((n_words,), _WORD if default else 0,
                           dtype=torch.int64, device=resolve_device(device))
        return cls(words, n_bits)._masked()

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

    def _masked(self) -> "Bitset":
        """The bitset with the bits past ``n_bits`` cleared."""
        tail = self.n_bits % _BITS
        if tail == 0 or self.words.numel() == 0:
            return self
        words = self.words.clone()
        words[-1] &= (1 << tail) - 1
        return Bitset(words, self.n_bits)

    def test(self, idx) -> torch.Tensor:
        """The bits at ``idx`` (any integer tensor shape), as bools.
        Indices outside [0, n_bits) read as False (a slack row's source id
        -1 among them)."""
        idx = torch.as_tensor(idx, device=self.words.device).to(torch.int64)
        ok = (idx >= 0) & (idx < self.n_bits)
        safe = torch.where(ok, idx, 0)
        bit = (self.words[safe // _BITS] >> (safe % _BITS)) & 1
        return (bit != 0) & ok

    def set(self, idx, value=True) -> "Bitset":
        """A new bitset with the bits at ``idx`` (scalar or 1-D) set to
        ``value`` (a bool, or one a position), through the unpacked mask
        as in the JAX package."""
        mask = self.to_mask().clone()
        idx = torch.atleast_1d(torch.as_tensor(
            idx, device=mask.device)).to(torch.int64)
        val = torch.as_tensor(value, dtype=torch.bool, device=mask.device)
        mask[idx] = val.expand(idx.shape)
        return Bitset.from_mask(mask)

    def flip(self) -> "Bitset":
        """Every bit inverted (those past ``n_bits`` stay clear)."""
        return Bitset(self.words ^ _WORD, self.n_bits)._masked()

    def to_mask(self) -> torch.Tensor:
        """Unpack to a boolean vector of shape (n_bits,)."""
        shifts = torch.arange(_BITS, dtype=torch.int64,
                              device=self.words.device)
        bits = (self.words[:, None] >> shifts[None, :]) & 1
        return bits.reshape(-1)[: self.n_bits].to(torch.bool)

    def count(self) -> torch.Tensor:
        """The set bits, as a 0-d int64 tensor on the words' device."""
        return self.to_mask().sum()

    def count_by_segments(self, ids: torch.Tensor, segment_ids: torch.Tensor,
                          num_segments: int) -> torch.Tensor:
        """Survivors a segment in one pass: ``out[s]`` = the number of j
        with ``segment_ids[j] == s`` and ``test(ids[j])`` (an IVF index's
        per-list survivor counts: ``ids`` its source ids in storage order,
        ``segment_ids`` each storage row's list). Ids out of range (slack
        rows' -1) never count. (num_segments,) int64."""
        bits = self.test(ids).to(torch.int64)
        out = torch.zeros(num_segments, dtype=torch.int64,
                          device=bits.device)
        return out.index_add_(0, torch.as_tensor(
            segment_ids, device=bits.device).to(torch.int64), bits)

    def fingerprint(self) -> str:
        """Content digest of the words and the length (a host read): two
        bitsets share it exactly when they select the same rows. Equal to
        the JAX package's digest of the same bits."""
        words = self._masked().words.cpu().numpy().astype("<u4")
        h = hashlib.blake2b(np.ascontiguousarray(words).tobytes(),
                            digest_size=16)
        h.update(str(int(self.n_bits)).encode())
        return h.hexdigest()

    def any(self) -> torch.Tensor:
        return (self._masked().words != 0).any()

    def all(self) -> torch.Tensor:
        return self.count() == self.n_bits

    def none(self) -> torch.Tensor:
        return ~self.any()
