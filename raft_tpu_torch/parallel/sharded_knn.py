"""Sharded exact kNN: counterpart of
``raft_tpu/parallel/sharded_knn.py`` (``ShardedIndex``, ``build``,
``search``, ``dryrun``).

Each shard of a :class:`~raft_tpu_torch.comms.Mesh` holds a contiguous
block of ``cdiv(n, p)`` rows as a port brute-force index on its device,
so global ids are ``rank·shard_rows + local``, as in the JAX package.
Queries go to every shard; each shard searches its rows with
``brute_force.search`` (kernel K2 + the K1 merge on CUDA), rebases its
ids and pads to k; the per-shard lists merge through
:func:`raft_tpu_torch.ops.ring_topk.merge` — only candidate lists move
between shards, never vectors. The JAX package pads the corpus to p
blocks and masks the padding rows; here the last shards may be short or
empty and contribute (±inf, -1) slots instead, which is the same
answer.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ..comms import Mesh
from ..core.errors import expects
from ..distance.distance_types import canonical_metric, is_min_close
from ..neighbors import brute_force
from ..ops import ring_topk
from ..utils import cdiv

__all__ = ["ShardedIndex", "build", "search", "shard_candidates", "dryrun"]


class ShardedIndex:
    """Brute-force index row-sharded over a mesh: ``shards[r]`` is the
    brute-force index of rows [r·shard_rows, (r+1)·shard_rows) on shard
    r's device (None for an empty shard)."""

    def __init__(self, mesh: Mesh, shards: list, n_total: int, shard_rows: int,
                 metric):
        self.mesh = mesh
        self.shards = shards
        self.n_total = n_total
        self.shard_rows = shard_rows
        self.metric = metric

    @property
    def n_shards(self) -> int:
        return self.mesh.size


def build(dataset, mesh: Mesh, metric="sqeuclidean") -> ShardedIndex:
    """Distribute the dataset in contiguous row blocks over ``mesh``."""
    x = torch.as_tensor(dataset)
    expects(x.dim() == 2, "dataset must be (n, d)")
    n = x.shape[0]
    p = mesh.size
    shard_rows = cdiv(n, p)
    shards = []
    for r, dev in enumerate(mesh.devices):
        lo, hi = min(n, r * shard_rows), min(n, (r + 1) * shard_rows)
        shards.append(brute_force.build(x[lo:hi], metric, device=dev)
                      if hi > lo else None)
    return ShardedIndex(mesh, shards, n, shard_rows, canonical_metric(metric))


def _pad(d: torch.Tensor, i: torch.Tensor, k: int, bad: float):
    """(m, k') lists → (m, k) with (bad, -1) slots appended."""
    m, kk = d.shape
    if kk == k:
        return d, i
    return (torch.cat([d, d.new_full((m, k - kk), bad)], dim=1),
            torch.cat([i, i.new_full((m, k - kk), -1)], dim=1))


def shard_candidates(index: ShardedIndex, queries, k: int
                     ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
    """Each shard's local top-k with GLOBAL ids, on its device → (p
    distance lists, p id lists), each (m, k); a shard with fewer than k
    rows fills its slots past them with (±inf, -1)."""
    q = torch.as_tensor(queries).to(torch.float32)
    bad = float("inf") if is_min_close(index.metric) else -float("inf")
    ds, gs = [], []
    for r, (dev, shard) in enumerate(zip(index.mesh.devices, index.shards)):
        qr = q.to(dev)
        if shard is None:
            d = torch.full((qr.shape[0], k), bad, device=dev)
            g = torch.full((qr.shape[0], k), -1, dtype=torch.int32,
                           device=dev)
        else:
            d, i = brute_force.search(shard, qr, min(k, shard.size))
            g = torch.where(i >= 0, i + r * index.shard_rows, -1).to(
                torch.int32)
            d = torch.where(g >= 0, d, bad)
            d, g = _pad(d, g, k, bad)
        ds.append(d.contiguous())
        gs.append(g.contiguous())
    return ds, gs


def search(index: ShardedIndex, queries, k: int,
           merge_engine: str | None = None):
    """Sharded search: per-shard top-k, then the cross-shard merge →
    (distances (m, k), int32 global ids (m, k)), the first shard's merged
    copy, on its device.

    ``merge_engine``: one of ``ring_topk.ENGINES`` (or ``"auto"``);
    default ``ring_pallas`` (K8) on CUDA shards where it can run,
    ``allgather`` elsewhere (``ring_topk.resolve_engine``)."""
    expects(0 < k <= index.n_total, "k=%d out of range for %d rows", k,
            index.n_total)
    ds, gs = shard_candidates(index, queries, k)
    eng = ring_topk.resolve_engine(ds[0].shape[0], k, index.n_shards,
                                   override=merge_engine, mesh=index.mesh)
    ring_topk.note_engine("knn", eng)
    out_d, out_g = ring_topk.merge(ds, gs, k, is_min_close(index.metric),
                                   index.mesh, engine=eng)
    return out_d[0], out_g[0]


def dryrun(n_devices: int, device="cpu") -> str:
    """One sharded search step on tiny shapes over ``n_devices`` shards of
    ``device``, every merge engine checked against the single-index
    answer; returns a one-line report."""
    mesh = Mesh([device] * n_devices)
    rng = np.random.default_rng(0)
    # integer-valued data: every distance is exact, so ids must be equal
    data = rng.integers(-4, 5, (1_000 * n_devices - 17, 16)).astype(
        np.float32)
    q = rng.integers(-4, 5, (32, 16)).astype(np.float32)
    index = build(data, mesh)
    ref_d, ref_i = brute_force.search(brute_force.build(data, device=device),
                                      q, 5)
    for eng in ring_topk.ENGINES:
        d, i = search(index, q, 5, merge_engine=eng)
        expects(torch.equal(i.cpu(), ref_i.cpu())
                and torch.equal(d.cpu(), ref_d.cpu()),
                "dryrun: the %s merge differs from the single index", eng)
    return (f"dryrun ok: sharded brute force over {n_devices} shards of "
            f"{device}, every merge engine equal to the single index")
