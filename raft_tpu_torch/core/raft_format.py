"""RAFT-native index files: counterpart of
``raft_tpu/core/raft_format.py`` (``load_raft_ivf_pq``,
``save_raft_ivf_pq``, ``load_raft_ivf_flat``, ``save_raft_ivf_flat``,
``load_raft_cagra``, ``save_raft_cagra``).

RAFT 24.02 serializes an index as a stream of ``.npy`` frames, one a
scalar or array (core/detail/mdspan_numpy_serializer.hpp), in the C++
field order:

* IVF-PQ, version 3 (detail/ivf_pq_serialize.cuh:60-87): version, size,
  dim, pq_bits, pq_dim, conservative_memory_allocation, metric,
  codebook_kind, n_lists; pq_centers (pq_dim, len, book), or (n_lists,
  len, book) for per-cluster codebooks, centers
  (n_lists, dim_ext), centers_rot, rotation_matrix; list_sizes (u32);
  then a list at a time its size, its interleaved codes and its ids.
* IVF-Flat, version 4 (detail/ivf_flat_serialize.cuh:54-92): a 4-byte
  dtype tag, then version, size, dim, n_lists, metric,
  adaptive_centers, conservative, centers, has_norms (+ norms),
  list_sizes; a list at a time its size rounded up to 32, a (rounded,
  dim) frame holding the interleaved rows and ``rounded`` ids (the tail
  ``kInvalidRecord``).
* CAGRA, version 3 (detail/cagra/cagra_serialize.cuh:33-83): the dtype
  tag, version, size, dim, graph_degree (u32 scalars), metric, the graph
  (u32), include_dataset (+ dataset).

List payloads use RAFT's interleaved group layout: rows in groups of 32,
components in 16-byte vectors, PQ codes a little-endian bitfield in each
16-byte chunk. Each writer gives the JAX package's writer's bytes for
the same index; each loader returns a port index on ``device`` (the CUDA
card by default), made by the family's own constructor. An int8
IVF-Flat file has no row scales (RAFT stores the raw int8 rows): its
index gets unit scales, which give the same values.
"""
from __future__ import annotations

from typing import BinaryIO, Optional

import numpy as np
import torch

from ..distance.distance_types import DistanceType
from ..neighbors import cagra, ivf_flat, ivf_pq
from ..neighbors._list_layout import dense_offsets, gather_dense
from ..ops.quant import dequantize_rows
from ..utils import resolve_device
from .errors import expects
from .serialize import device_tensor, host_array

__all__ = ["load_raft_ivf_pq", "save_raft_ivf_pq",
           "load_raft_ivf_flat", "save_raft_ivf_flat",
           "load_raft_cagra", "save_raft_cagra"]

_GROUP = 32          # kIndexGroupSize
_VEC = 16            # kIndexGroupVecLen (bytes)

# RAFT's enum values (distance/distance_types.hpp:26-66)
_METRIC_BY_INT = {
    0: DistanceType.L2Expanded,
    1: DistanceType.L2SqrtExpanded,
    2: DistanceType.CosineExpanded,
    3: DistanceType.L1,
    4: DistanceType.L2Unexpanded,
    5: DistanceType.L2SqrtUnexpanded,
    6: DistanceType.InnerProduct,
    7: DistanceType.Linf,
    8: DistanceType.Canberra,
    9: DistanceType.LpUnexpanded,
    10: DistanceType.CorrelationExpanded,
    11: DistanceType.JaccardExpanded,
    12: DistanceType.HellingerExpanded,
    13: DistanceType.Haversine,
    14: DistanceType.BrayCurtis,
    15: DistanceType.JensenShannon,
    16: DistanceType.HammingUnexpanded,
    17: DistanceType.KLDivergence,
    18: DistanceType.RusselRaoExpanded,
    19: DistanceType.DiceExpanded,
    100: DistanceType.Precomputed,
}
_INT_BY_METRIC = {m: i for i, m in _METRIC_BY_INT.items()}


def _read(f: BinaryIO):
    """One npy frame (a scalar frame as a numpy scalar)."""
    arr = np.lib.format.read_array(f, allow_pickle=False)
    return arr[()] if arr.ndim == 0 else arr


def _write(f: BinaryIO, value, dtype=None) -> None:
    """One npy frame, as serialize_scalar / serialize_mdspan write it."""
    np.lib.format.write_array(f, np.asarray(value, dtype=dtype),
                              allow_pickle=False)


def _open(path_or_file, mode: str):
    if hasattr(path_or_file, "read") or hasattr(path_or_file, "write"):
        return path_or_file, False
    return open(path_or_file, mode), True


def _read_dtype_tag(f: BinaryIO) -> np.dtype:
    """The 4-byte numpy dtype tag (``"%c%c%u"``, NUL-padded) before the
    first frame of IVF-Flat and CAGRA files."""
    raw = f.read(4)
    expects(len(raw) == 4, "truncated dtype tag")
    try:
        return np.dtype(raw.rstrip(b"\0").decode("ascii"))
    except (TypeError, ValueError, UnicodeDecodeError):
        expects(False, "bad dtype tag %r: not a RAFT-native file", raw)


def _write_dtype_tag(f: BinaryIO, dtype) -> None:
    dt = np.dtype(dtype)
    expects(dt.kind in "fiu", "no RAFT dtype tag for %s", dt)
    byteorder = "|" if dt.itemsize == 1 else "<"
    f.write(f"{byteorder}{dt.kind}{dt.itemsize}".encode("ascii")
            .ljust(4, b"\0"))


def _round_up(n: int, align: int) -> int:
    return -(-n // align) * align


# ------------------------------------------------- interleaved list codecs

def _unpack_interleaved_rows(data: np.ndarray, size: int) -> np.ndarray:
    """(ngroups, nchunks, 32, veclen) interleaved rows → (size, dim)."""
    ngroups, nchunks, g, veclen = data.shape
    rows = data.transpose(0, 2, 1, 3).reshape(ngroups * g, nchunks * veclen)
    return rows[:size]


def _pack_interleaved_rows(rows: np.ndarray, veclen: int) -> np.ndarray:
    """(size, dim) → (ngroups, dim // veclen, 32, veclen) interleaved."""
    size, dim = rows.shape
    expects(dim % veclen == 0, "dim %d not a multiple of veclen %d", dim,
            veclen)
    ngroups = -(-size // _GROUP)
    pad = np.zeros((ngroups * _GROUP, dim), rows.dtype)
    pad[:size] = rows
    return np.ascontiguousarray(
        pad.reshape(ngroups, _GROUP, dim // veclen, veclen)
        .transpose(0, 2, 1, 3))


def _pq_bit_positions(pq_dim: int, pq_bits: int) -> np.ndarray:
    """(pq_dim, pq_bits) positions of each code's bits, least significant
    first, in a row's chunks of 128 bits: code j sits in chunk j //
    (128 // pq_bits), at ``pq_bits`` times its rank there."""
    per_chunk = (_VEC * 8) // pq_bits
    j = np.arange(pq_dim)[:, None]
    return ((j // per_chunk) * (_VEC * 8) + (j % per_chunk) * pq_bits
            + np.arange(pq_bits)[None, :])


def _unpack_interleaved_pq(data: np.ndarray, size: int, pq_dim: int,
                           pq_bits: int) -> np.ndarray:
    """(ngroups, nchunks, 32, 16) bitfield chunks → (size, pq_dim) u8; a
    16-byte chunk holds ``128 // pq_bits`` codes, little-endian."""
    ngroups, nchunks, g, v = data.shape
    rows = data.transpose(0, 2, 1, 3).reshape(ngroups * g, nchunks * v)
    bits = np.unpackbits(rows[:size], axis=1, bitorder="little")
    weights = 1 << np.arange(pq_bits, dtype=np.uint16)
    picked = bits[:, _pq_bit_positions(pq_dim, pq_bits)]
    return np.ascontiguousarray((picked * weights).sum(axis=2), np.uint8)


def _pack_interleaved_pq(codes: np.ndarray, pq_bits: int) -> np.ndarray:
    """(size, pq_dim) u8 → interleaved bitfield chunks (the inverse)."""
    size, pq_dim = codes.shape
    nchunks = -(-pq_dim // ((_VEC * 8) // pq_bits))
    ngroups = -(-size // _GROUP)
    bits = np.zeros((ngroups * _GROUP, nchunks * _VEC * 8), np.uint8)
    bits[:size, _pq_bit_positions(pq_dim, pq_bits)] = (
        codes[:, :, None] >> np.arange(pq_bits, dtype=np.uint8)) & 1
    packed = np.packbits(bits, axis=1, bitorder="little")
    return np.ascontiguousarray(
        packed.reshape(ngroups, _GROUP, nchunks, _VEC).transpose(0, 2, 1, 3))


def _dense_rows(index, arrays):
    """The index's ``arrays`` (tensors in its layout) packed with no slack,
    as host numpy arrays."""
    return [host_array(a) for a in gather_dense(
        arrays, index.list_offsets, index.list_sizes)]


# ------------------------------------------------------------------ IVF-PQ

def load_raft_ivf_pq(path_or_file, device=None):
    """A RAFT ``ivf_pq`` file (version 3) → :class:`ivf_pq.Index` on
    ``device``."""
    f, close = _open(path_or_file, "rb")
    try:
        ver = int(_read(f))
        expects(ver == 3, "unsupported RAFT ivf_pq serialization version "
                "%d (expected 3, RAFT 24.02)", ver)
        n = int(_read(f))
        _dim = int(_read(f))
        pq_bits = int(_read(f))
        pq_dim = int(_read(f))
        _conservative = bool(_read(f))
        metric = _METRIC_BY_INT[int(_read(f))]
        kind = ivf_pq.CodebookGen(int(_read(f)))
        n_lists = int(_read(f))
        pq_centers = _read(f)           # (pq_dim | n_lists, len, book)
        _centers = _read(f)             # (n_lists, dim_ext), not kept
        centers_rot = _read(f)          # (n_lists, rot_dim)
        rotation = _read(f)             # (rot_dim, dim)
        list_sizes = np.asarray(_read(f), np.int64)
        codes_parts, ids_parts = [], []
        for label in range(n_lists):
            sz = int(_read(f))
            expects(sz == int(list_sizes[label]),
                    "list %d size mismatch (%d vs %d)", label, sz,
                    int(list_sizes[label]))
            if sz == 0:
                continue
            data = _read(f)
            inds = _read(f)
            codes_parts.append(_unpack_interleaved_pq(data, sz, pq_dim,
                                                      pq_bits))
            ids_parts.append(np.asarray(inds[:sz], np.int64))
        codes = (np.concatenate(codes_parts) if codes_parts
                 else np.zeros((0, pq_dim), np.uint8))
        ids = (np.concatenate(ids_parts) if ids_parts
               else np.zeros((0,), np.int64))
    finally:
        if close:
            f.close()
    expects(len(codes) == n, "row count mismatch (%d vs %d)", len(codes), n)
    expects(ids.size == 0 or ids.max() < 2 ** 31,
            "source ids exceed int32 (the port stores int32 ids)")
    dev = resolve_device(device)
    # RAFT's pq_centers are (pq_dim | n_lists, pq_len, book), the index's
    # (pq_dim | n_lists, book, pq_len)
    codebooks = np.ascontiguousarray(pq_centers.transpose(0, 2, 1))
    return ivf_pq.Index(
        device_tensor(codes, dev), device_tensor(ids.astype(np.int32), dev),
        device_tensor(np.asarray(centers_rot, np.float32), dev),
        device_tensor(codebooks.astype(np.float32), dev),
        device_tensor(np.asarray(rotation, np.float32), dev),
        dense_offsets(list_sizes), list_sizes, metric, pq_bits, kind)


def save_raft_ivf_pq(index, path_or_file) -> None:
    """:class:`ivf_pq.Index` → a RAFT ``ivf_pq`` file (version 3)."""
    sizes = index.list_sizes
    codes, ids = _dense_rows(index, (index.codes, index.source_ids))
    f, close = _open(path_or_file, "wb")
    try:
        _write(f, np.int32(3))
        _write(f, np.int64(index.size))
        _write(f, np.uint32(index.dim))
        _write(f, np.uint32(index.pq_bits))
        _write(f, np.uint32(index.pq_dim))
        _write(f, np.uint8(0))          # conservative_memory_allocation
        _write(f, np.int32(_INT_BY_METRIC[index.metric]))
        _write(f, np.int32(index.codebook_kind.value))
        _write(f, np.uint32(index.n_lists))
        cb = host_array(index.codebooks).astype(np.float32)
        _write(f, np.ascontiguousarray(cb.transpose(0, 2, 1)))
        centers_rot = host_array(index.centers_rot).astype(np.float32)
        rot = host_array(index.rotation).astype(np.float32)
        # the centers in the original space, RAFT's extended layout
        # (n_lists, dim_ext): dim_ext = round_up(dim + 1, 8), the norm last
        centers = centers_rot @ rot
        dim_ext = _round_up(index.dim + 1, 8)
        cent_ext = np.zeros((index.n_lists, dim_ext), np.float32)
        cent_ext[:, : index.dim] = centers
        cent_ext[:, index.dim] = (centers * centers).sum(1)
        _write(f, cent_ext)
        _write(f, centers_rot)
        _write(f, rot)
        _write(f, np.asarray(sizes, np.uint32))
        ids = ids.astype(np.int64)
        off = 0
        for label in range(index.n_lists):
            sz = int(sizes[label])
            _write(f, np.uint32(sz))
            if sz == 0:
                continue
            _write(f, _pack_interleaved_pq(codes[off : off + sz],
                                           index.pq_bits))
            _write(f, ids[off : off + sz])
            off += sz
    finally:
        if close:
            f.close()


# ---------------------------------------------------------------- IVF-Flat

def load_raft_ivf_flat(path_or_file, device=None):
    """A RAFT ``ivf_flat`` file (version 4) → :class:`ivf_flat.Index` on
    ``device``: float32 rows, int8 rows with unit scales, or uint8 rows;
    the row norms computed from the rows as ``ivf_flat.build`` does."""
    f, close = _open(path_or_file, "rb")
    try:
        dtype = _read_dtype_tag(f)
        ver = int(_read(f))
        expects(ver == 4, "unsupported RAFT ivf_flat serialization version "
                "%d (expected 4, RAFT 24.02)", ver)
        n = int(_read(f))
        dim = int(_read(f))
        n_lists = int(_read(f))
        metric = _METRIC_BY_INT[int(_read(f))]
        _adaptive = bool(_read(f))
        conservative = bool(_read(f))
        centers = _read(f)
        has_norms = bool(_read(f))
        center_norms = _read(f) if has_norms else None
        list_sizes = np.asarray(_read(f), np.int64)
        # calculate_veclen (ivf_flat_types.hpp:385-395)
        veclen = max(1, 16 // dtype.itemsize)
        if dim % veclen != 0:
            veclen = 1
        rows_parts, ids_parts = [], []
        for label in range(n_lists):
            rounded = int(_read(f))     # the list size rounded up to 32
            if rounded == 0:
                continue
            sz = int(list_sizes[label])
            expects(rounded == _round_up(sz, _GROUP),
                    "list %d rounded size %d inconsistent with list_sizes "
                    "%d", label, rounded, sz)
            data = _read(f)
            expects(data.shape == (rounded, dim),
                    "list %d data frame shape %s != (%d, %d)", label,
                    tuple(data.shape), rounded, dim)
            expects(data.dtype == dtype, "list %d frame dtype %s != tag %s",
                    label, data.dtype, dtype)
            inds = _read(f)
            # the frame's raw bytes are the interleaved group layout
            interleaved = np.ascontiguousarray(data).reshape(
                rounded // _GROUP, dim // veclen, _GROUP, veclen)
            rows_parts.append(_unpack_interleaved_rows(interleaved, sz))
            ids_parts.append(np.asarray(inds[:sz], np.int64))
        rows = (np.concatenate(rows_parts) if rows_parts
                else np.zeros((0, dim), dtype))
        ids = (np.concatenate(ids_parts) if ids_parts
               else np.zeros((0,), np.int64))
    finally:
        if close:
            f.close()
    expects(len(rows) == n, "row count mismatch (%d vs %d)", len(rows), n)
    expects(ids.size == 0 or ids.max() < 2 ** 31,
            "source ids exceed int32 (the port stores int32 ids)")
    expects(rows.dtype in (np.float32, np.int8, np.uint8),
            "RAFT ivf_flat rows of %s have no store in the port", rows.dtype)
    dev = resolve_device(device)
    data = device_tensor(rows, dev)
    scales = (torch.ones(n, dtype=torch.float32, device=dev)
              if rows.dtype == np.int8 else None)
    deq = dequantize_rows(data, scales)
    cen = device_tensor(np.asarray(centers, np.float32), dev)
    cn = (device_tensor(np.asarray(center_norms, np.float32), dev)
          if center_norms is not None else (cen * cen).sum(dim=1))
    ids = device_tensor(ids.astype(np.int32), dev)
    return ivf_flat.Index(
        data, (deq * deq).sum(dim=1), ids, cen, cn,
        dense_offsets(list_sizes), list_sizes, metric, scales,
        conservative_memory=conservative)


def save_raft_ivf_flat(index, path_or_file) -> None:
    """:class:`ivf_flat.Index` → a RAFT ``ivf_flat`` file (version 4).
    Only float32 stores: RAFT's T is the original dtype, and the port's
    low-precision stores have no RAFT file."""
    expects(index.data.dtype == torch.float32,
            "only float32 ivf_flat indexes serialize to the RAFT format "
            "(got %s)", index.store_name)
    rows, ids = _dense_rows(index, (index.data, index.source_ids))
    dim = index.dim
    # calculate_veclen: float32's 16 / 4 = 4, else 1
    veclen = 4 if dim % 4 == 0 else 1
    sizes = index.list_sizes
    f, close = _open(path_or_file, "wb")
    try:
        _write_dtype_tag(f, np.float32)
        _write(f, np.int32(4))
        _write(f, np.int64(index.size))
        _write(f, np.uint32(dim))
        _write(f, np.uint32(index.n_lists))
        _write(f, np.int32(_INT_BY_METRIC[index.metric]))
        _write(f, np.uint8(0))          # adaptive_centers
        _write(f, np.uint8(int(index.conservative_memory)))
        _write(f, host_array(index.centers).astype(np.float32))
        _write(f, np.uint8(1))
        _write(f, host_array(index.center_norms).astype(np.float32))
        _write(f, np.asarray(sizes, np.uint32))
        off = 0
        for label in range(index.n_lists):
            sz = int(sizes[label])
            rounded = _round_up(sz, _GROUP)
            _write(f, np.uint32(rounded))
            if sz == 0:
                continue
            # interleaved, framed as the flat (rounded, dim) array RAFT
            # copies (make_list_extents, ivf_flat_types.hpp:114)
            packed = _pack_interleaved_rows(rows[off : off + sz], veclen)
            _write(f, packed.reshape(rounded, dim))
            # ids padded with kInvalidRecord (-1 for a signed IdxT)
            inds = np.full(rounded, -1, np.int64)
            inds[:sz] = ids[off : off + sz]
            _write(f, inds)
            off += sz
    finally:
        if close:
            f.close()


# ------------------------------------------------------------------- CAGRA

def load_raft_cagra(path_or_file, dataset: Optional[np.ndarray] = None,
                    device=None):
    """A RAFT ``cagra`` file (version 3) → :class:`cagra.Index` on
    ``device``, with no seed set (RAFT keeps none). A file written with
    ``include_dataset=False`` needs ``dataset``."""
    f, close = _open(path_or_file, "rb")
    try:
        _read_dtype_tag(f)
        ver = int(_read(f))
        expects(ver == 3, "unsupported RAFT cagra serialization version %d "
                "(expected 3, RAFT 24.02)", ver)
        n = int(_read(f))
        dim = int(_read(f))
        _degree = int(_read(f))
        metric = _METRIC_BY_INT[int(_read(f))]
        graph = np.asarray(_read(f), np.int32)
        if bool(_read(f)):
            dataset = _read(f)
    finally:
        if close:
            f.close()
    expects(dataset is not None,
            "file has no dataset (include_dataset=false); pass one")
    expects(tuple(dataset.shape) == (n, dim), "dataset shape mismatch %s",
            tuple(dataset.shape))
    dev = resolve_device(device)
    return cagra.Index(device_tensor(np.asarray(dataset, np.float32), dev),
                       device_tensor(graph, dev), metric, None)


def save_raft_cagra(index, path_or_file, include_dataset: bool = True
                    ) -> None:
    """:class:`cagra.Index` → a RAFT ``cagra`` file (version 3)."""
    f, close = _open(path_or_file, "wb")
    try:
        n, degree = index.graph.shape
        _write_dtype_tag(f, np.float32)
        _write(f, np.int32(3))
        # pylibraft's cagra::index<T, uint32_t>: size is a u4 scalar
        _write(f, np.uint32(n))
        _write(f, np.uint32(index.dataset.shape[1]))
        _write(f, np.uint32(degree))
        _write(f, np.int32(_INT_BY_METRIC[index.metric]))
        _write(f, host_array(index.graph).astype(np.uint32))
        _write(f, np.uint8(int(include_dataset)))
        if include_dataset:
            _write(f, host_array(index.dataset).astype(np.float32))
    finally:
        if close:
            f.close()
