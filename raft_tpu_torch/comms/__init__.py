"""Communicator over the shards of a mesh: counterpart of
``raft_tpu/comms`` (``Mesh`` stands in for a 1-D ``jax.sharding.Mesh``)."""
from .comms import AxisComms, Mesh

__all__ = ["AxisComms", "Mesh"]
