"""Contract checks: counterpart of ``raft_tpu/core/errors.py``
(``RaftError``, ``CorruptIndexError``, ``ShardsDownError``, ``expects``)."""
from __future__ import annotations

__all__ = ["RaftError", "CorruptIndexError", "ShardsDownError", "expects"]


class RaftError(RuntimeError):
    """Base exception for raft_tpu_torch (analog of ``raft::exception``)."""


class CorruptIndexError(RaftError, ValueError):
    """A serialized index failed an integrity check (CRC mismatch,
    truncation, unparseable section). ``section`` names the file section
    that failed: ``"header"``, ``"array table"`` or an array name. Also a
    ValueError, as a malformed file is bad input."""

    def __init__(self, section: str, detail: str = ""):
        self.section = section
        msg = f"corrupt index file: section {section!r}"
        super().__init__(f"{msg} ({detail})" if detail else msg)


class ShardsDownError(RaftError):
    """A sharded search found dead shards and the caller did not opt into
    a degraded answer (``allow_partial=True``), or no shard is left.
    ``shards_ok`` is the per-shard validity mask observed at search
    time."""

    def __init__(self, shards_ok):
        self.shards_ok = [bool(x) for x in shards_ok]
        down = [i for i, ok in enumerate(self.shards_ok) if not ok]
        if not any(self.shards_ok):
            msg = (f"sharded search: all {len(self.shards_ok)} shards "
                   "unavailable — no surviving shard to degrade onto")
        else:
            msg = (f"sharded search: shard(s) {down} unavailable; pass "
                   "allow_partial=True to accept a degraded merged result")
        super().__init__(msg)


def expects(cond: bool, msg: str, *args) -> None:
    """Raise :class:`RaftError` with the formatted message when ``cond``
    is falsy (analog of ``RAFT_EXPECTS``)."""
    if not cond:
        raise RaftError(msg % args if args else msg)
