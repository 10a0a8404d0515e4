"""Cooperative cross-thread cancellation: counterpart of
``raft_tpu/core/interruptible.py`` (``InterruptedException``, ``Token``,
``get_token``, ``cancel``, ``check``, ``synchronize``), the analog of
``raft::interruptible`` (raft/core/interruptible.hpp:71-94).

A per-thread token whose ``cancel()`` makes the target thread's next
cancellation point raise. The points sit on the host between launches
(the chunked searches check one before each chunk): a kernel that is
running is not preempted.
"""
from __future__ import annotations

import threading
import weakref
from typing import Optional

import torch

__all__ = ["InterruptedException", "Token", "get_token", "cancel", "check",
           "synchronize"]


class InterruptedException(RuntimeError):
    """Raised at the next cancellation point after ``cancel()``."""


class Token:
    """Shared cancellation flag for one logical thread of work."""

    def __init__(self):
        self._flag = threading.Event()

    def cancel(self) -> None:
        self._flag.set()

    def cancelled(self) -> bool:
        return self._flag.is_set()

    def check(self) -> None:
        """Cancellation point: raise (and reset) if cancelled."""
        if self._flag.is_set():
            self._flag.clear()
            raise InterruptedException("raft_tpu_torch: work interrupted")


# The thread-local holds the only strong reference to a thread's token
# (the reference's weak-pointer TLS, interruptible.hpp:226-233), so a
# token dies with its thread and a recycled thread ident cannot inherit a
# stale cancellation.
_local = threading.local()
_registry: "weakref.WeakValueDictionary[int, Token]" = \
    weakref.WeakValueDictionary()
_lock = threading.Lock()


def get_token(thread_id: Optional[int] = None) -> Token:
    """The token of a thread (default: the current one), made on first
    use. Another thread's token is found only while that thread is alive
    and has made one; otherwise a detached token is returned (cancelling
    it reaches no one)."""
    if thread_id is None or thread_id == threading.get_ident():
        tok = getattr(_local, "token", None)
        if tok is None:
            tok = Token()
            _local.token = tok
            with _lock:
                _registry[threading.get_ident()] = tok
        return tok
    with _lock:
        tok = _registry.get(thread_id)
    return tok if tok is not None else Token()


def cancel(thread_id: Optional[int] = None) -> None:
    get_token(thread_id).cancel()


def check() -> None:
    """Cancellation point for the current thread."""
    get_token().check()


def synchronize(value=None):
    """Wait for the card, honouring cancellation before and after
    (``interruptible::synchronize(stream)``): the device of ``value`` (a
    tensor, or a tuple or list of them) when it is on a card, else the
    current card when there is one."""
    check()
    tensors = value if isinstance(value, (tuple, list)) else [value]
    devs = {t.device for t in tensors if isinstance(t, torch.Tensor)
            and t.is_cuda}
    if devs:
        for dev in devs:
            torch.cuda.synchronize(dev)
    elif value is None and torch.cuda.is_available():
        torch.cuda.synchronize()
    check()
    return value
