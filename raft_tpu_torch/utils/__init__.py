"""Small integer/shape utilities and device resolution.

Counterpart of ``raft_tpu/utils/__init__.py`` (``cdiv``, ``round_up_to``,
``run_query_chunks``, ``env_float``, ``env_int``), plus two rules every
entry point of the port shares: ``resolve_device`` and ``query_chunks``.
"""
from __future__ import annotations

import os

import torch

from ..core.errors import RaftError

__all__ = ["cdiv", "round_up_to", "run_query_chunks", "query_chunks",
           "resolve_device", "env_float", "env_int"]


def cdiv(a: int, b: int) -> int:
    """Ceiling division."""
    return -(-a // b)


def env_float(name: str, default: float) -> float:
    """A float setting from the environment, ``default`` when it is unset
    or does not parse (a setting never fails a running process)."""
    raw = os.environ.get(name, "")
    try:
        return float(raw) if raw else default
    except ValueError:
        return default


def env_int(name: str, default: int) -> int:
    """The integer twin of :func:`env_float`."""
    raw = os.environ.get(name, "")
    try:
        return int(raw) if raw else default
    except ValueError:
        return default


def round_up_to(x: int, m: int) -> int:
    """Round ``x`` up to the nearest multiple of ``m``."""
    return cdiv(x, m) * m


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card. With no ``device`` and no card this raises — the
    port never carries on quietly on the CPU; callers that want the CPU
    (the tests) pass ``device="cpu"``."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RaftError("no CUDA device is available; pass device='cpu' "
                        "to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def query_chunks(m: int, query_chunk: int, res, default: int) -> int:
    """The rows a chunk of a search over ``m`` queries, or 0 for one
    unchunked call (the JAX package's rule): ``query_chunk`` when given,
    else ``default`` when ``res`` carries a deadline. A carried deadline
    chunks even a batch that fits one chunk, so that its checkpoint runs
    before any launch; without one, a chunk of ``m`` rows or more is one
    unchunked call."""
    from ..core.deadline import carried

    timed = carried(res) is not None
    if query_chunk <= 0:
        if not timed:
            return 0
        query_chunk = max(1, min(m, default))
    return query_chunk if query_chunk < m or timed else 0


def run_query_chunks(fn, q: torch.Tensor, chunk: int, res=None):
    """Apply ``fn((m_c, d) chunk, start_row)`` over row-chunks of ``q``
    and concatenate the (vals, ids) pairs. Before each chunk: a
    cancellation and deadline checkpoint (``core.deadline``) against
    ``res`` (a Deadline, or an object carrying one; None: cancellation
    only), so an expired budget raises ``DeadlineExceeded`` with the
    finished chunks' results before the next chunk launches anything."""
    from ..core import deadline

    outs_d, outs_i = [], []
    for s0 in range(0, q.shape[0], chunk):
        deadline.checkpoint(
            res, partial=lambda: deadline.partial_topk(outs_d, outs_i))
        d_c, i_c = fn(q[s0 : s0 + chunk], s0)
        outs_d.append(d_c)
        outs_i.append(i_c)
    if len(outs_d) == 1:
        return outs_d[0], outs_i[0]
    return torch.cat(outs_d), torch.cat(outs_i)
