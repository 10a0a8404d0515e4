"""Indexes carried over from the JAX package as numpy arrays.

Each function takes the fields of a ``raft_tpu`` index, read out as numpy
arrays (``np.asarray(index.<field>)``), and returns the port's index on
``device``. Search parity between the packages is checked on such a
carried index, since k-means randomness differs between ``jax.random``
and ``torch.Generator``.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .comms import Mesh
from .distance.distance_types import DistanceType, canonical_metric
from .neighbors import brute_force, cagra, ivf_flat, ivf_pq
from .parallel import sharded_ann
from .utils import resolve_device

__all__ = ["brute_force_index_from_numpy", "ivf_flat_index_from_numpy",
           "ivf_pq_index_from_numpy", "cagra_index_from_numpy",
           "sharded_ivf_flat_from_numpy", "sharded_ivf_pq_from_numpy"]


def _metric(arrays: Mapping, metric):
    """The metric given, else the one carried in ``arrays`` (a
    ``DistanceType`` value string, e.g. ``"l2_expanded"``)."""
    m = metric if metric is not None else arrays["metric"]
    return canonical_metric(getattr(m, "value", m))


def _tensor(a, dtype, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=dtype, device=dev)


def brute_force_index_from_numpy(arrays: Mapping, metric=None,
                                 device=None) -> brute_force.Index:
    """``arrays``: ``dataset`` (n, d) float32 and, for the L2 and cosine
    metrics, ``norms`` (n,) (derived when absent); ``metric`` as in
    :func:`_metric`."""
    dev = resolve_device(device)
    mt = _metric(arrays, metric)
    dataset = _tensor(arrays["dataset"], torch.float32, dev)
    norms = arrays.get("norms")
    if norms is not None:
        norms = _tensor(norms, torch.float32, dev)
    elif mt is not DistanceType.InnerProduct:
        norms = (dataset * dataset).sum(dim=1)
    return brute_force.Index(dataset, norms, mt)


def ivf_flat_index_from_numpy(arrays: Mapping, metric=None,
                              device=None) -> ivf_flat.Index:
    """``arrays``: ``data``, ``data_norms``, ``source_ids``, ``centers``,
    ``center_norms``, ``list_offsets`` and ``list_sizes_arr`` (the JAX
    index's field names); ``metric`` as in :func:`_metric`."""
    dev = resolve_device(device)
    return ivf_flat.Index(
        _tensor(arrays["data"], torch.float32, dev),
        _tensor(arrays["data_norms"], torch.float32, dev),
        _tensor(arrays["source_ids"], torch.int32, dev),
        _tensor(arrays["centers"], torch.float32, dev),
        _tensor(arrays["center_norms"], torch.float32, dev),
        np.asarray(arrays["list_offsets"], np.int64),
        np.asarray(arrays["list_sizes_arr"], np.int64),
        _metric(arrays, metric))


def ivf_pq_index_from_numpy(arrays: Mapping, metric=None,
                            device=None) -> ivf_pq.Index:
    """``arrays``: ``codes``, ``source_ids``, ``centers_rot``,
    ``codebooks``, ``rotation``, ``list_offsets``, ``list_sizes_arr``,
    ``pq_bits`` and ``codebook_kind`` (the JAX index's field names; the
    codebook kind as its enum or that enum's value); ``metric`` as in
    :func:`_metric`. The decoded row norms are computed here."""
    dev = resolve_device(device)
    kind = arrays.get("codebook_kind", ivf_pq.CodebookGen.PER_SUBSPACE)
    return ivf_pq.Index(
        _tensor(arrays["codes"], torch.uint8, dev),
        _tensor(arrays["source_ids"], torch.int32, dev),
        _tensor(arrays["centers_rot"], torch.float32, dev),
        _tensor(arrays["codebooks"], torch.float32, dev),
        _tensor(arrays["rotation"], torch.float32, dev),
        np.asarray(arrays["list_offsets"], np.int64),
        np.asarray(arrays["list_sizes_arr"], np.int64),
        _metric(arrays, metric), int(arrays["pq_bits"]),
        ivf_pq.CodebookGen(int(getattr(kind, "value", kind))))


def cagra_index_from_numpy(arrays: Mapping, metric=None,
                           device=None) -> cagra.Index:
    """``arrays``: ``dataset`` (n, d) float32, ``graph`` (n, degree) and,
    optionally, ``seed_nodes`` (s,) sorted unique rows (absent or None:
    random seeding only); ``metric`` as in :func:`_metric`. The traversal
    copies and the edge store are built on the port's side
    (``cagra.prepare_search`` / ``prepare_traversal``)."""
    dev = resolve_device(device)
    seeds = arrays.get("seed_nodes")
    return cagra.Index(
        _tensor(arrays["dataset"], torch.float32, dev),
        _tensor(arrays["graph"], torch.int32, dev), _metric(arrays, metric),
        None if seeds is None else _tensor(seeds, torch.int32, dev))


def _shard_arrays(arrays: Mapping, r: int, row_fields) -> dict:
    """Shard r of JAX's stacked (p, R, ...) arrays: its padding rows (past
    the end of its last list) stripped, its list offsets completed to
    (n_lists + 1,) and its sizes under the single index's names."""
    offsets = np.asarray(arrays["offsets"][r], np.int64)
    sizes = np.asarray(arrays["sizes"][r], np.int64)
    end = int((offsets + sizes).max())
    out = {f: np.asarray(arrays[f][r])[:end] for f in row_fields}
    out["list_offsets"] = np.append(offsets, end)
    out["list_sizes_arr"] = sizes
    return out


def sharded_ivf_flat_from_numpy(arrays: Mapping, mesh: Mesh,
                                metric=None) -> sharded_ann.ShardedIvfFlat:
    """``arrays``: the stacked fields of a JAX ``ShardedIvfFlat`` (float32
    store): ``data`` (p, R, d), ``data_norms``, ``source_ids`` (GLOBAL ids,
    -1 on padding), ``centers`` (p, L, d), ``center_norms``, ``offsets``,
    ``sizes`` (p, L), and ``n_total``; ``metric`` as in :func:`_metric`.
    One port index a shard, on ``mesh``'s devices."""
    shards = []
    for r, dev in enumerate(mesh.devices):
        a = _shard_arrays(arrays, r, ("data", "data_norms", "source_ids"))
        a.update(centers=arrays["centers"][r],
                 center_norms=arrays["center_norms"][r])
        shards.append(ivf_flat_index_from_numpy(a, _metric(arrays, metric),
                                                dev))
    return sharded_ann.ShardedIvfFlat(mesh, shards, int(arrays["n_total"]),
                                      shards[0].metric)


def sharded_ivf_pq_from_numpy(arrays: Mapping, mesh: Mesh,
                              metric=None) -> sharded_ann.ShardedIvfPq:
    """``arrays``: the stacked fields of a JAX ``ShardedIvfPq``: ``codes``
    (p, R, pq_dim), ``source_ids`` (GLOBAL ids, -1 on padding),
    ``centers_rot``, ``codebooks``, ``rotations``, ``offsets``, ``sizes``
    (p, L), ``pq_bits``, ``codebook_kind`` and ``n_total``; ``metric`` as
    in :func:`_metric`. One port index a shard, on ``mesh``'s devices."""
    shards = []
    for r, dev in enumerate(mesh.devices):
        a = _shard_arrays(arrays, r, ("codes", "source_ids"))
        a.update(centers_rot=arrays["centers_rot"][r],
                 codebooks=arrays["codebooks"][r],
                 rotation=arrays["rotations"][r], pq_bits=arrays["pq_bits"],
                 codebook_kind=arrays.get("codebook_kind",
                                          ivf_pq.CodebookGen.PER_SUBSPACE))
        shards.append(ivf_pq_index_from_numpy(a, _metric(arrays, metric),
                                              dev))
    return sharded_ann.ShardedIvfPq(mesh, shards, int(arrays["n_total"]),
                                    shards[0].metric)
