"""Shards and the collectives between them: counterpart of
``raft_tpu/comms/comms.py`` (``AxisComms``: ``get_size``, ``get_rank``,
``allgather``, ``device_sendrecv``) and of the 1-D
``jax.sharding.Mesh`` the JAX package's sharded paths run on.

The port is single-controller, as ``shard_map`` is: one process drives
every shard. A :class:`Mesh` is an ordered list of p ``torch.device``s
named by the axis ``"shard"``; a device may repeat, so p shards can share
one card. :class:`AxisComms` takes and returns a list of p per-shard
tensors, each on its shard's device. Between shards of one device a
collective moves nothing; between cards it is a device-to-device copy.
Subgroups (``comm_split``), the reductions, and ``torch.distributed``
across processes are not ported yet.
"""
from __future__ import annotations

from typing import List, Sequence

import torch

from ..core.errors import RaftError, expects

__all__ = ["Mesh", "AxisComms"]


def _device(d) -> torch.device:
    """A shard's device; a bare "cuda" becomes the current card, so
    shards on one card compare equal."""
    dev = torch.device(d)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RaftError("no CUDA device is available; use a Mesh of "
                            "'cpu' devices to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """p shards, each named by its device, along the one axis (the JAX
    package names it ``"shard"``)."""

    def __init__(self, devices: Sequence):
        expects(len(devices) > 0, "a mesh needs at least one device")
        self.devices: List[torch.device] = [_device(d) for d in devices]

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


class AxisComms:
    """Collectives over the shards of a :class:`Mesh`. Each method takes
    one tensor per shard, in shard order, and returns one per shard."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def get_size(self) -> int:
        """Ranks in this communicator."""
        return self.mesh.size

    def get_rank(self) -> List[int]:
        """Each shard's rank, in shard order (JAX's traced axis index,
        one value per shard)."""
        return list(range(self.mesh.size))

    def _check(self, xs) -> None:
        expects(len(xs) == self.mesh.size,
                "%d tensors for a mesh of %d shards", len(xs),
                self.mesh.size)

    def allgather(self, xs) -> List[torch.Tensor]:
        """(…,) per rank → (size, …) on every rank, stacked in rank
        order."""
        self._check(xs)
        return [torch.stack([x.to(dev) for x in xs])
                for dev in self.mesh.devices]

    def device_sendrecv(self, xs, dest_offset: int = 1) -> List[torch.Tensor]:
        """Ring shift: rank r sends to (r + dest_offset) % size and
        receives from (r - dest_offset) % size."""
        self._check(xs)
        p = self.mesh.size
        return [xs[(r - dest_offset) % p].to(dev)
                for r, dev in enumerate(self.mesh.devices)]
