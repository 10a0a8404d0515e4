"""Sharded ANN indexes, the IVF-Flat and IVF-PQ families: counterpart of
``raft_tpu/parallel/sharded_ann.py`` (``ShardedIvfFlat``,
``build_ivf_flat``, ``search_ivf_flat``, ``ShardedIvfPq``,
``build_ivf_pq``, ``search_ivf_pq``).

Each shard of a :class:`~raft_tpu_torch.comms.Mesh` indexes its own
contiguous row block (``np.array_split``: balanced, none empty) as a port
``ivf_flat.Index`` or ``ivf_pq.Index`` on its device, its source ids
rebased to global row numbers at build. A search sends the queries to
every shard, runs the port's ``search`` there (kernel K3 or K4 plus K1 on
CUDA) and merges the per-shard lists through
:func:`raft_tpu_torch.ops.ring_topk.merge`; vectors never move between
shards. The JAX package stacks the shards' arrays into one (p, R, …)
array; here each shard keeps its own index (``convert`` carries JAX's
stacked arrays over shard by shard).

Shard health: ``mark_shard_failed`` flags a shard dead; a search then
raises :class:`~raft_tpu_torch.core.errors.ShardsDownError` unless
``allow_partial=True``, which merges the survivors (a dead shard
contributes (±inf, -1) slots) and also returns the health mask; with no
shard left it raises all the same. A ``filter`` is a sample bitset over
the GLOBAL ids, which every shard's search reads directly. A filter
prunes lists with no surviving row from each shard's probe (the JAX
package's sharded search scans them); the single-index search's adaptive
widen and crossover stay off (``filter_policy.suspended()``), as the JAX
package's sharded search has none.

Not ported yet: the CAGRA family, ``probe_shards`` / canaries / MTTR and
the fault sites, ``make_searcher``, ``warmup_searchers``, ``widen_rungs``,
``ops_snapshot``, ``health``, ``dispatch_cache``, and the multi-host
``topology`` / ``fleet`` / ``hier`` layers.
"""
from __future__ import annotations

import numpy as np
import torch

from ..comms import Mesh
from ..core.errors import ShardsDownError, expects
from ..distance.distance_types import is_min_close
from ..neighbors import ivf_flat, ivf_pq
from ..ops import filter_policy, ring_topk

__all__ = ["ShardedIvfFlat", "build_ivf_flat", "search_ivf_flat",
           "ShardedIvfPq", "build_ivf_pq", "search_ivf_pq"]


class _Sharded:
    """Per-shard indexes over a mesh, with sticky health flags."""

    family = ""

    def __init__(self, mesh: Mesh, shards: list, n_total: int, metric):
        self.mesh = mesh
        self.shards = shards        # one index a shard, global source ids
        self.n_total = n_total
        self.metric = metric
        self.shards_ok = np.ones(mesh.size, bool)

    @property
    def n_shards(self) -> int:
        return self.mesh.size

    def mark_shard_failed(self, i: int, ok: bool = False) -> None:
        """Flag shard ``i`` unhealthy: its results are masked out of every
        merge (search then needs ``allow_partial=True``) until re-marked
        ok."""
        self.shards_ok[i] = ok


class ShardedIvfFlat(_Sharded):
    """One IVF-Flat index per shard."""

    family = "ivf_flat"


class ShardedIvfPq(_Sharded):
    """One IVF-PQ index per shard."""

    family = "ivf_pq"


def _split_rows(n: int, p: int) -> list:
    """Balanced contiguous row ranges per shard; none empty for n >= p."""
    expects(n >= p, "cannot shard %d rows over %d shards", n, p)
    return np.array_split(np.arange(n), p)


def _build(family, dataset, mesh: Mesh, build, params):
    x = torch.as_tensor(dataset)
    expects(x.dim() == 2, "dataset must be (n, d)")
    parts = _split_rows(x.shape[0], mesh.size)
    expects(params.n_lists <= min(len(r) for r in parts),
            "n_lists %d > smallest shard %d", params.n_lists,
            min(len(r) for r in parts))
    shards = []
    for rows, dev in zip(parts, mesh.devices):
        lo = int(rows[0])
        s = build(x[lo:lo + len(rows)], params, device=dev)
        s.source_ids = torch.where(s.source_ids >= 0, s.source_ids + lo,
                                   -1).to(torch.int32)
        shards.append(s)
    return family(mesh, shards, x.shape[0], shards[0].metric)


def build_ivf_flat(dataset, mesh: Mesh,
                   params: ivf_flat.IndexParams | None = None
                   ) -> ShardedIvfFlat:
    """Build one IVF-Flat index per shard over its contiguous row block,
    each on its shard's device with the same ``params``."""
    return _build(ShardedIvfFlat, dataset, mesh, ivf_flat.build,
                  params or ivf_flat.IndexParams())


def build_ivf_pq(dataset, mesh: Mesh,
                 params: ivf_pq.IndexParams | None = None) -> ShardedIvfPq:
    """Build one IVF-PQ index per shard over its contiguous row block,
    each on its shard's device with the same ``params``."""
    return _build(ShardedIvfPq, dataset, mesh, ivf_pq.build,
                  params or ivf_pq.IndexParams())


def _health_gate(ok: np.ndarray, allow_partial: bool) -> None:
    """Dead shards without ``allow_partial`` are an error, not a quietly
    degraded answer; no shard left is an error either way."""
    if not ok.all() and (not allow_partial or not ok.any()):
        raise ShardsDownError(ok)


def _merged_shard_search(index: _Sharded, queries, k: int, local,
                         allow_partial: bool, merge_engine):
    """Every live shard's ``local(shard_index, queries_on_its_device)``,
    dead shards' (±inf, -1) lists, one cross-shard merge."""
    ok = index.shards_ok.copy()
    _health_gate(ok, allow_partial)
    q = torch.as_tensor(queries).to(torch.float32)
    select_min = is_min_close(index.metric)
    bad = float("inf") if select_min else -float("inf")
    ds, gs = [], []
    for r, (dev, shard) in enumerate(zip(index.mesh.devices, index.shards)):
        if ok[r]:
            d, i = local(shard, q.to(dev))
        else:
            d = torch.full((q.shape[0], k), bad, device=dev)
            i = torch.full((q.shape[0], k), -1, dtype=torch.int32,
                           device=dev)
        ds.append(d.contiguous())
        gs.append(i.to(torch.int32).contiguous())
    eng = ring_topk.resolve_engine(q.shape[0], k, index.n_shards,
                                   override=merge_engine, mesh=index.mesh)
    ring_topk.note_engine(index.family, eng)
    out_d, out_g = ring_topk.merge(ds, gs, k, select_min, index.mesh,
                                   engine=eng)
    res = (out_d[0], out_g[0])
    return res + (ok,) if allow_partial else res


def _prune_only(search, shard, q, k, sp, filter):  # noqa: A002
    """One shard's search with the filter as penalty and prune alone."""
    with filter_policy.suspended():
        return search(shard, q, k, sp, filter=filter)


def search_ivf_flat(index: ShardedIvfFlat, queries, k: int,
                    params: ivf_flat.SearchParams | None = None,
                    allow_partial: bool = False,
                    merge_engine: str | None = None, filter=None):  # noqa: A002
    """Queries to every shard → per-shard ``ivf_flat.search`` → the
    cross-shard merge → (distances (m, k), int32 global ids (m, k)), the
    first shard's merged copy, on its device. ``allow_partial=True``
    accepts dead shards and returns ``(distances, ids, shards_ok)``.
    ``merge_engine``: as in
    :func:`raft_tpu_torch.parallel.sharded_knn.search`. ``filter``: a
    sample bitset over the global ids."""
    sp = params or ivf_flat.SearchParams()
    return _merged_shard_search(
        index, queries, k,
        lambda s, q: _prune_only(ivf_flat.search, s, q, k, sp, filter),
        allow_partial, merge_engine)


def search_ivf_pq(index: ShardedIvfPq, queries, k: int,
                  params: ivf_pq.SearchParams | None = None,
                  allow_partial: bool = False,
                  merge_engine: str | None = None, filter=None):  # noqa: A002
    """Queries to every shard → per-shard ``ivf_pq.search`` (its LUT mode
    from ``params.lut_dtype``) → the cross-shard merge; the contract of
    :func:`search_ivf_flat`."""
    sp = params or ivf_pq.SearchParams()
    return _merged_shard_search(
        index, queries, k,
        lambda s, q: _prune_only(ivf_pq.search, s, q, k, sp, filter),
        allow_partial, merge_engine)
