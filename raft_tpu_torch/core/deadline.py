"""Deadlines for the chunked searches: counterpart of
``raft_tpu/core/deadline.py`` (``Deadline``, ``DeadlineExceeded``,
``carried``, ``checkpoint``, ``partial_topk``).

A :class:`Deadline`, passed to a search as ``res`` (alone, or as the
``deadline`` attribute of any object), makes the search run its queries
in chunks and call :func:`checkpoint` before each chunk's launches: a
cancellation point (``core.interruptible``) and a deadline probe that
raises :class:`DeadlineExceeded` with the finished chunks' results
attached, so a query that ran out of time still gets what was computed.
A kernel that is running is not preempted: the grain is the query chunk.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from . import interruptible
from .errors import RaftError

__all__ = ["Deadline", "DeadlineExceeded", "carried", "checkpoint",
           "partial_topk"]


class DeadlineExceeded(RaftError):
    """Raised at a checkpoint once the deadline has passed. ``partial``
    holds the finished chunks' results: for a top-k search a
    ``(distances, indices)`` pair over the queries of the chunks that
    finished, None when none did."""

    def __init__(self, msg: str, partial=None):
        self.partial = partial
        super().__init__(msg)


class Deadline:
    """A wall-clock budget of ``seconds``, counted from construction.
    ``clock`` (default ``time.monotonic``) can be injected, for tests."""

    def __init__(self, seconds: float,
                 clock: Callable[[], float] = time.monotonic):
        self.seconds = float(seconds)
        self._clock = clock
        self._t0 = clock()

    @classmethod
    def after(cls, seconds: float, **kw) -> "Deadline":
        return cls(seconds, **kw)

    def elapsed(self) -> float:
        return self._clock() - self._t0

    def remaining(self) -> float:
        return self.seconds - self.elapsed()

    def expired(self) -> bool:
        return self.remaining() <= 0.0


def carried(res) -> Optional[Deadline]:
    """The Deadline ``res`` carries: ``res`` itself when it is one, else
    its ``deadline`` attribute, else None (``res`` None too). The one rule
    :func:`checkpoint` and the searches' chunking share."""
    if res is None:
        return None
    return res if isinstance(res, Deadline) else getattr(res, "deadline",
                                                         None)


def checkpoint(res=None, partial=None) -> None:
    """Cancellation and deadline point before a chunk's launches.
    ``partial``: the results to attach on expiry, a value or a callable
    of no arguments (called only when the deadline has passed)."""
    interruptible.check()
    dl = carried(res)
    if dl is None or not dl.expired():
        return
    p = partial() if callable(partial) else partial
    raise DeadlineExceeded(
        f"raft_tpu_torch: deadline of {dl.seconds:.4g}s exceeded "
        f"({dl.elapsed():.4g}s elapsed); partial results "
        f"{'attached' if p is not None else 'empty'}", partial=p)


def partial_topk(outs_d: list, outs_i: list):
    """The finished top-k chunks as one (distances, indices) pair, None
    when no chunk finished: the searches' ``partial``."""
    if not outs_d:
        return None
    if len(outs_d) == 1:
        return outs_d[0], outs_i[0]
    return torch.cat(outs_d), torch.cat(outs_i)
