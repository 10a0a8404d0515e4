"""Indexes carried over from the JAX package as numpy arrays.

Each function takes the fields of a ``raft_tpu`` index, read out as numpy
arrays (``np.asarray(index.<field>)``), and returns the port's index on
``device``. Search parity between the packages is checked on such a
carried index, since k-means randomness differs between ``jax.random``
and ``torch.Generator``.

A low-precision store keeps its dtype: int8 and uint8 as they are, int4
as its packed int8 bytes with ``logical_dim``, and bfloat16, which numpy
has no type of, as 16-bit words (an ``ml_dtypes`` bfloat16 array, which
``np.asarray`` of a JAX bf16 array gives, or its ``.view(np.uint16)``),
viewed as ``torch.bfloat16`` on the port's side.
"""
from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from .comms import Mesh
from .distance.distance_types import DistanceType, canonical_metric
from .neighbors import brute_force, cagra, ivf_flat, ivf_pq
from .ops import quant
from .ops.quant import dequantize_store
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


_STORED = {np.dtype(np.float32): torch.float32, np.dtype(np.int8): torch.int8,
           np.dtype(np.uint8): torch.uint8}


def _rows(a, dev) -> torch.Tensor:
    """A store's rows as they are stored: float32, int8, uint8, or
    bfloat16 carried as 16-bit words."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        words = torch.from_numpy(np.array(a).view(np.int16))
        return words.view(torch.bfloat16).to(dev)
    if a.dtype not in _STORED:
        a = a.astype(np.float32)
    return torch.tensor(a, dtype=_STORED[a.dtype], device=dev)


def _optional(arrays: Mapping, name: str, dtype, dev):
    a = arrays.get(name)
    return None if a is None else _tensor(a, dtype, dev)


def brute_force_index_from_numpy(arrays: Mapping, metric=None,
                                 device=None) -> brute_force.Index:
    """``arrays``: ``dataset`` (n, d) in its store (:func:`_rows`; int4:
    the (n, half_p) bytes), ``scales`` (n,) for int8 and int4 stores,
    ``logical_dim`` for int4 and, for the L2 and cosine metrics, ``norms``
    (n,) (derived from the dequantized rows when absent); ``metric`` as
    in :func:`_metric`."""
    dev = resolve_device(device)
    mt = _metric(arrays, metric)
    dataset = _rows(arrays["dataset"], dev)
    scales = _optional(arrays, "scales", torch.float32, dev)
    dim = arrays.get("logical_dim")
    dim = None if dim is None else int(dim)
    norms = _optional(arrays, "norms", torch.float32, dev)
    if norms is None and mt is not DistanceType.InnerProduct:
        deq = dequantize_store(dataset, scales, dim)
        norms = (deq * deq).sum(dim=1)
    return brute_force.Index(dataset, norms, mt, scales, dim)


def ivf_flat_index_from_numpy(arrays: Mapping, metric=None,
                              device=None) -> ivf_flat.Index:
    """``arrays``: ``data`` (in its store, :func:`_rows`), ``data_norms``,
    ``source_ids``, ``centers``, ``center_norms``, ``list_offsets``,
    ``list_sizes_arr`` and, for an int8 store, ``scales`` (the JAX
    index's field names); ``metric`` as in :func:`_metric`."""
    dev = resolve_device(device)
    return ivf_flat.Index(
        _rows(arrays["data"], dev),
        _tensor(arrays["data_norms"], torch.float32, dev),
        _tensor(arrays["source_ids"], torch.int32, dev),
        _tensor(arrays["centers"], torch.float32, dev),
        _tensor(arrays["center_norms"], torch.float32, dev),
        np.asarray(arrays["list_offsets"], np.int64),
        np.asarray(arrays["list_sizes_arr"], np.int64),
        _metric(arrays, metric), _optional(arrays, "scales", torch.float32,
                                           dev))


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


def cagra_index_from_numpy(arrays: Mapping, metric=None, device=None,
                           edge_store: Optional[Mapping] = None
                           ) -> cagra.Index:
    """``arrays``: ``dataset`` (n, d) float32, ``graph`` (n, degree) and,
    optionally, ``seed_nodes`` (s,) sorted unique rows (absent or None:
    random seeding only); ``metric`` as in :func:`_metric`. The traversal
    copies are built on the port's side (``cagra.prepare_search``), and
    so is the edge store (``prepare_traversal``) unless ``edge_store``
    carries JAX's: ``mode`` ("int8", "bfloat16", "int4" or "pq"),
    ``degree``, ``vecs`` (n, deg_p, W), ``aux`` (n, 2, deg_p), ``gp``
    (n, deg_p) and, for pq, ``cb_mat`` — JAX's subspace-major decode
    table (pq_dim·book, dim_p), int8 or float32 — with ``cb_scale``, its
    (1, dim_p) rescale row, which become the port's compact codebook
    (``ops.quant.pq_compact_cb``)."""
    dev = resolve_device(device)
    seeds = arrays.get("seed_nodes")
    index = cagra.Index(
        _tensor(arrays["dataset"], torch.float32, dev),
        _tensor(arrays["graph"], torch.int32, dev), _metric(arrays, metric),
        None if seeds is None else _tensor(seeds, torch.int32, dev))
    if edge_store is not None:
        index.edge_store = _edge_store(edge_store, dev)
    return index


def _edge_store(es: Mapping, dev) -> cagra.EdgeStore:
    """JAX's edge store arrays → the port's :class:`cagra.EdgeStore`."""
    mode = es["mode"]
    vecs = np.asarray(es["vecs"])
    cb = cb_scale = None
    if mode == "pq":
        vecs_t = torch.tensor(vecs.astype(np.uint8), device=dev)
        table = np.asarray(es["cb_mat"])
        pq_dim = vecs.shape[2]
        dim_p = table.shape[1]
        if table.dtype == np.int8:
            cb, cb_scale = quant.pq_compact_cb(
                torch.tensor(table, device=dev),
                _tensor(es["cb_scale"], torch.float32, dev), pq_dim)
        else:
            cb, _ = quant.pq_compact_cb(
                _tensor(table, torch.float32, dev), None, pq_dim)
    elif mode == "int4":
        vecs_t = torch.tensor(vecs.astype(np.int8), device=dev)
        dim_p = 2 * vecs.shape[2]
    else:
        vecs_t = _rows(vecs, dev)
        dim_p = vecs.shape[2]
    return cagra.EdgeStore(
        mode, int(es["degree"]), vecs.shape[1], dim_p, vecs_t.contiguous(),
        _tensor(es["aux"], torch.float32, dev).contiguous(),
        _tensor(es["gp"], torch.int32, dev).contiguous(), cb, cb_scale)


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
