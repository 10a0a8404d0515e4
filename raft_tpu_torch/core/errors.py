"""Contract checks: counterpart of ``raft_tpu/core/errors.py``
(``RaftError``, ``expects``)."""
from __future__ import annotations

__all__ = ["RaftError", "expects"]


class RaftError(RuntimeError):
    """Base exception for raft_tpu_torch (analog of ``raft::exception``)."""


def expects(cond: bool, msg: str, *args) -> None:
    """Raise :class:`RaftError` with the formatted message when ``cond``
    is falsy (analog of ``RAFT_EXPECTS``)."""
    if not cond:
        raise RaftError(msg % args if args else msg)
