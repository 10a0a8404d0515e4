"""The workspace budget of the chunked searches: counterpart of
``workspace_chunk_bytes`` and ``DEFAULT_WORKSPACE_BYTES`` of
``raft_tpu/core/resources.py``. The ``Resources`` registry itself is not
ported yet; a search's ``res`` may be any object (a :class:`~raft_tpu_torch.
core.deadline.Deadline` included), and a ``workspace_bytes`` attribute on
it sets the budget.
"""
from __future__ import annotations

__all__ = ["DEFAULT_WORKSPACE_BYTES", "workspace_chunk_bytes"]

# the JAX package's default workspace budget; a ``res`` that carries it
# unchanged keeps the 256 MB chunk bound below
DEFAULT_WORKSPACE_BYTES = 2 * 1024**3


def workspace_chunk_bytes(res) -> int:
    """Bytes a query chunk may take: ``res.workspace_bytes`` when it is
    set to something other than the default (clamped to [16 MB, 4 GB]),
    else 256 MB."""
    ws = getattr(res, "workspace_bytes", None) if res is not None else None
    if ws is not None and ws != DEFAULT_WORKSPACE_BYTES:
        return max(16 << 20, min(ws, 4 << 30))
    return 256 << 20
