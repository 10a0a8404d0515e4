"""CAGRA frontier expansion: counterpart of ``raft_tpu/ops/graph_expand.py``
(``graph_expand``, ``edge_tile_widen``, ``score_dim``), with kernel K5
(``csrc/graph_expand.cuh``: one library a store mode,
``graph_expand{,_int4,_pq}.cu``).

``cagra.prepare_traversal`` packs, for every node, its ``degree``
neighbors' stored vectors into one contiguous ``(deg_p, W)`` tile of an
``(n, deg_p, W)`` edge store, beside an ``(n, 2, deg_p)`` float32 aux of
[per-edge scales, dequantized norms]. The store modes:

* ``"dense"`` — int8 rows with per-edge scales, or bf16 rows: W = dim_p;
* ``"int4"`` — split-half nibbles (``ops.quant`` layout: byte j holds
  dim j low and dim W + j high), int8 bytes: W = dim_p / 2, a multiple
  of 64;
* ``"pq"`` — uint8 PQ codes, W = pq_dim, decoded through the compact
  codebook ``cb`` (pq_dim, book, pq_len): int8 with ``cb_scale``
  (pq_dim,) float32 (``dec = float(cb) · scale``, one rounding, JAX's
  int8 table), or float32 (``dec = cb``).

:func:`widen_tile` turns a tile into its float32 (deg_p, dim_p) rows,
``dim_p`` being :func:`score_dim`. Expanding a parent reads its one tile
instead of ``degree`` scattered rows. For each (query, parent) pair,
:func:`graph_expand` scores the tile against the query —
``max(||q||² + ||v||² - 2·s·q·v, 0)`` ("l2") or ``-s·q·v`` ("ip"), plus
an optional per-edge penalty (+inf drops an edge, the bitset filter),
pad edges (position >= ``degree``) +inf — and returns the parent's
``k_out`` best as (value, edge position), best first, lowest position
on ties, (+inf, -1) for empty slots.

On a CUDA tensor it launches K5 (:func:`graph_expand_kernel`); on a CPU
tensor it takes the plain version, :func:`graph_expand_plain`, which
adds in the kernel's order (:func:`lane_order_dot`: 32 lane partial sums
over 4-dim groups of each 128-dim chunk, then an xor butterfly) over the
widened tile, so the two agree bit for bit on any input in every mode,
as do K6 and its plain version. K5 and K6 take tiles of up to 256 edges
(:func:`check_tile`). The TPU kernel's choices that serve its hardware
have no counterpart here: ``_pick_pq`` (queries per grid step), the
one-hot matmuls that route each parent its query row and decode the pq
codes, and the 128-lane output padding (``kp``).
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..matrix.select_k import smallest_k_plain
from . import _cuda
from .quant import int4_nibbles

__all__ = ["graph_expand", "graph_expand_plain", "graph_expand_kernel",
           "lane_order_dot", "widen_tile", "score_dim", "check_mode",
           "check_tile", "check_width", "check_codebook", "pad_queries",
           "card_info", "store_mode", "kernel_info", "MODES"]

# the counters are bumped under this lock: the serving worker and the
# recall sentinel launch from their own threads
_count_lock = threading.Lock()
launches = 0   # K5 launches since the last reset, every mode's
launches_dense = launches_int4 = launches_pq = 0   # by store mode

MODES = ("dense", "int4", "pq")
_METRIC_CODE = {"l2": 0, "ip": 1}
_STORE_DTYPES = {"dense": (torch.int8, torch.bfloat16),
                 "int4": (torch.int8,), "pq": (torch.uint8,)}
MAX_DEG_P = 256                   # the kernels sort at most 8 keys a lane
MAX_BOOK = 256                    # uint8 codes


def check_mode(mode: str) -> None:
    """A store mode of :data:`MODES`."""
    expects(mode in MODES, "unknown store mode %r", mode)


def score_dim(vecs: torch.Tensor, mode: str,
              cb: Optional[torch.Tensor] = None) -> int:
    """The width a tile is scored at: W (dense), 2·W (int4's two
    planes), or the codebook's pq_dim · pq_len (pq)."""
    check_mode(mode)
    if mode == "int4":
        return 2 * vecs.shape[2]
    if mode == "pq":
        expects(cb is not None and cb.dim() == 3,
                "a pq store needs its (pq_dim, book, pq_len) codebook")
        return cb.shape[0] * cb.shape[2]
    return vecs.shape[2]


def check_tile(deg_p: int, dim_p: int, mode: str = "dense",
               w: Optional[int] = None) -> None:
    """The tile shapes K5 and K6 take: (32·a, W) with deg_p <= 256 and a
    scored width dim_p = 128·b; int4: W = dim_p / 2, a multiple of 64;
    pq: W = pq_dim dividing dim_p, pq_len = dim_p / pq_dim from 2 to
    dim_p / 4."""
    expects(deg_p % 32 == 0 and deg_p <= MAX_DEG_P,
            "edge store tiles must be (32·a <= %d, 128·b), got (%d, %d)",
            MAX_DEG_P, deg_p, dim_p)
    check_width(dim_p, mode, w)


def check_width(dim_p: int, mode: str = "dense",
                w: Optional[int] = None) -> None:
    """The row rule of :func:`check_tile` (every version of K5 and K6
    holds to it): a scored width of 128·b, int4 rows of dim_p / 2 bytes
    (a multiple of 64), pq rows of pq_dim codes with pq_len from 2 to
    dim_p / 4."""
    expects(dim_p % 128 == 0, "edge store tiles must be (32·a <= %d, "
            "128·b), got a scored width of %d", MAX_DEG_P, dim_p)
    if mode == "int4":
        expects(w is None or (2 * w == dim_p and w % 64 == 0),
                "int4 tiles hold dim_p / 2 bytes a row, a multiple of 64; "
                "got %s for dim_p %d", w, dim_p)
    elif mode == "pq":
        expects(w is not None and w > 0 and dim_p % w == 0
                and 2 <= dim_p // w <= dim_p // 4,
                "pq tiles hold pq_dim codes a row, pq_dim dividing dim_p "
                "%d with pq_len from 2 to dim_p / 4; got pq_dim %s", dim_p, w)


def check_codebook(cb: Optional[torch.Tensor],
                   cb_scale: Optional[torch.Tensor], pq_dim: int) -> None:
    """A pq store's compact codebook: (pq_dim, book <= 256, pq_len) int8
    with (pq_dim,) float32 scales, or float32 (no scales)."""
    expects(cb is not None and cb.dim() == 3 and cb.shape[0] == pq_dim
            and 0 < cb.shape[1] <= MAX_BOOK
            and cb.dtype in (torch.int8, torch.float32),
            "a pq store needs a (pq_dim=%d, book <= %d, pq_len) int8 or "
            "float32 codebook", pq_dim, MAX_BOOK)
    expects(cb.dtype == torch.float32 or (
                cb_scale is not None and cb_scale.shape == (pq_dim,)
                and cb_scale.dtype == torch.float32),
            "an int8 codebook needs its (%d,) float32 subspace scales",
            pq_dim)


def pad_queries(queries: torch.Tensor, dim_p: int) -> torch.Tensor:
    """(m, dim) queries → contiguous float32 (m, dim_p), zero-padded."""
    q = queries.to(torch.float32)
    expects(q.dim() == 2 and q.shape[1] <= dim_p,
            "queries must be (m, <= %d), got %s", dim_p, tuple(q.shape))
    if q.shape[1] < dim_p:
        q = torch.nn.functional.pad(q, (0, dim_p - q.shape[1]))
    return q.contiguous()


def _butterfly(acc: torch.Tensor) -> torch.Tensor:
    """(..., 32) lane partial sums → (...,): the warp's xor butterfly,
    ``acc[l] + acc[l ^ off]`` for off = 16, 8, 4, 2, 1."""
    lane = torch.arange(32, device=acc.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    return acc[..., 0]


def lane_order_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of ``a * b`` over the last dim (a multiple of 128), in the
    order of the kernels' ``edge_score.cuh``: lane l adds the products of
    dims 128c + 4l + j for c, then j, in turn (from 0), then the 32 lane
    sums meet in an xor butterfly. Every product and add rounds on its
    own, as ``__fmul_rn`` / ``__fadd_rn`` do."""
    p = a * b
    lanes = p.reshape(*p.shape[:-1], p.shape[-1] // 128, 32, 4)
    acc = torch.zeros(lanes.shape[:-3] + (32,), dtype=torch.float32,
                      device=p.device)
    for c in range(lanes.shape[-3]):
        for j in range(4):
            acc = acc + lanes[..., c, :, j]
    return _butterfly(acc)


def widen_tile(tiles: torch.Tensor, mode: str = "dense",
               cb: Optional[torch.Tensor] = None,
               cb_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tiles (..., deg_p, W) as stored → their float32 rows (..., deg_p,
    dim_p), as the kernels widen them (``edge_tile_widen``): dense rows
    cast; int4 the low nibbles on dims [0, W) and the high ones on
    [W, 2W) (:func:`~raft_tpu_torch.ops.quant.int4_nibbles`); pq dim d of
    a row is ``cb[s, code_s, d - s·pq_len]`` with s = d // pq_len, times
    ``cb_scale[s]`` for an int8 codebook (one float32 product)."""
    check_mode(mode)
    if mode == "int4":
        low, high = int4_nibbles(tiles)
        return torch.cat([low, high], dim=-1)
    if mode == "pq":
        pq_dim, _, pq_len = cb.shape
        table = cb.to(torch.float32)
        if cb.dtype == torch.int8:
            table = table * cb_scale.to(torch.float32)[:, None, None]
        sub = torch.arange(pq_dim, device=tiles.device)
        dec = table[sub, tiles.long()]            # (..., deg_p, s, pq_len)
        return dec.reshape(*tiles.shape[:-1], pq_dim * pq_len)
    return tiles.to(torch.float32)


def graph_expand_plain(parents: torch.Tensor, queries: torch.Tensor,
                       vecs: torch.Tensor, aux: torch.Tensor, k_out: int,
                       metric: str = "l2", degree: Optional[int] = None,
                       pen: Optional[torch.Tensor] = None,
                       mode: str = "dense", cb: Optional[torch.Tensor] = None,
                       cb_scale: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: gather the parents' tiles, widen them to
    float32 (:func:`widen_tile`), multiply by the query, sum along dim in
    the kernel's order, scale, apply the epilogue and take a stable
    sort's first ``k_out`` per parent."""
    check_mode(mode)
    expects(metric in _METRIC_CODE, "unknown metric %r", metric)
    n, deg_p, w = vecs.shape
    dim_p = score_dim(vecs, mode, cb)
    check_width(dim_p, mode, w)
    degree = deg_p if degree is None else degree
    m, width = parents.shape
    q = pad_queries(queries, dim_p)
    pids = parents.long().clamp(0, n - 1)                  # (m, w)
    tiles = widen_tile(vecs[pids], mode, cb, cb_scale)  # (m, w, deg_p, dim_p)
    cross = lane_order_dot(q[:, None, None, :], tiles)   # (m, w, deg_p)
    a = aux[pids]                                         # (m, w, 2, deg_p)
    cross = cross * a[:, :, 0]
    if metric == "l2":
        qn = lane_order_dot(q, q)[:, None, None]
        dist = torch.clamp_min(qn + a[:, :, 1] - 2.0 * cross, 0.0)
    else:
        dist = -cross
    if pen is not None:
        dist = dist + pen[pids]
    dist[..., degree:] = float("inf")
    vals, pos = smallest_k_plain(dist, k_out)
    return vals, torch.where(torch.isfinite(vals), pos, -1)


def _store_code(vecs: torch.Tensor, mode: str) -> int:
    """The store argument of the dense and int4 libraries' C entries: 1
    for a bf16 store's raw bits, else 0."""
    return int(mode == "dense" and vecs.dtype == torch.bfloat16)


def graph_expand_kernel(parents: torch.Tensor, queries: torch.Tensor,
                        vecs: torch.Tensor, aux: torch.Tensor, k_out: int,
                        metric: str = "l2", degree: Optional[int] = None,
                        pen: Optional[torch.Tensor] = None,
                        mode: str = "dense", cb: Optional[torch.Tensor] = None,
                        cb_scale: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K5 on CUDA tensors → (vals, edge positions), each
    (m, width, k_out): the library of the store's ``mode``."""
    global launches
    check_mode(mode)
    expects(vecs.is_cuda, "graph_expand kernel needs a CUDA tensor, got %s",
            vecs.device)
    expects(metric in _METRIC_CODE, "unknown metric %r", metric)
    expects(vecs.dim() == 3 and vecs.dtype in _STORE_DTYPES[mode]
            and vecs.is_contiguous(),
            "a %s edge store must be a contiguous (n, deg_p, W) tensor of "
            "%s, got %s %s", mode, _STORE_DTYPES[mode], vecs.dtype,
            tuple(vecs.shape))
    n, deg_p, w = vecs.shape
    dim_p = score_dim(vecs, mode, cb)
    degree = deg_p if degree is None else degree
    check_tile(deg_p, dim_p, mode, w)
    expects(0 < degree <= deg_p and 0 < k_out <= deg_p,
            "degree %d / k_out %d out of range for deg_p %d", degree, k_out,
            deg_p)
    expects(aux.shape == (n, 2, deg_p) and aux.dtype == torch.float32
            and aux.is_contiguous() and aux.device == vecs.device,
            "aux must be a contiguous float32 (n, 2, deg_p) tensor")
    expects(pen is None or (pen.shape == (n, deg_p)
                            and pen.dtype == torch.float32
                            and pen.is_contiguous()
                            and pen.device == vecs.device),
            "pen must be a contiguous float32 (n, deg_p) tensor")
    m, width = parents.shape
    q = pad_queries(queries.to(vecs.device), dim_p)
    pids = parents.to(device=vecs.device, dtype=torch.int32).clamp(
        0, n - 1).contiguous()
    out_v = torch.empty((m, width, k_out), dtype=torch.float32,
                        device=vecs.device)
    out_i = torch.empty((m, width, k_out), dtype=torch.int32,
                        device=vecs.device)
    if mode == "pq":
        check_codebook(cb, cb_scale, w)
        lut_i8 = int(cb.dtype == torch.int8)
        book = cb.shape[1]
        cbt = cb.to(vecs.device).contiguous()
        sct = (cb_scale.to(vecs.device).contiguous() if lut_i8 else None)
        expects(cbt.data_ptr() % 16 == 0, "the codebook must start on a "
                "16-byte boundary (the kernel copies it 16 bytes at a time)")
        lib = _cuda.library("graph_expand_pq")
        smem = lib.raft_graph_expand_pq_smem(dim_p, w, book, lut_i8)
        expects(smem <= _cuda.SMEM_PER_BLOCK, "graph_expand (pq) needs %d "
                "bytes of shared memory for its codebook (%s, book %d, "
                "dim_p %d) and one warp, above the card's %d a block", smem,
                cb.dtype, book, dim_p, _cuda.SMEM_PER_BLOCK)
        if m * width == 0:
            return out_v, out_i
        status = lib.raft_graph_expand_pq(
            pids.data_ptr(), q.data_ptr(), vecs.data_ptr(), aux.data_ptr(),
            None if pen is None else pen.data_ptr(), cbt.data_ptr(),
            None if sct is None else sct.data_ptr(), m * width, width,
            deg_p, dim_p, w, book, degree, k_out, _METRIC_CODE[metric],
            lut_i8, out_v.data_ptr(), out_i.data_ptr(),
            _cuda.stream_of(vecs))
    else:
        lib = _cuda.library(_cuda.STORE_SOURCES["graph_expand"][mode])
        code = _store_code(vecs, mode)
        smem = lib.raft_graph_expand_smem(dim_p, code)
        expects(smem <= _cuda.SMEM_PER_BLOCK, "graph_expand needs %d bytes "
                "of shared memory a warp (dim_p %d), above the card's %d a "
                "block", smem, dim_p, _cuda.SMEM_PER_BLOCK)
        if m * width == 0:
            return out_v, out_i
        status = lib.raft_graph_expand(
            pids.data_ptr(), q.data_ptr(), vecs.data_ptr(), aux.data_ptr(),
            None if pen is None else pen.data_ptr(), m * width, width, deg_p,
            dim_p, degree, k_out, _METRIC_CODE[metric], code,
            out_v.data_ptr(), out_i.data_ptr(), _cuda.stream_of(vecs))
    _cuda.check(status, "graph_expand")
    with _count_lock:
        launches += 1
        globals()[f"launches_{mode}"] += 1
    return out_v, out_i


def card_info(lib, entry: str, *args) -> dict:
    """A kernel's registers a thread, local memory a thread (bytes:
    spills), resident warps an SM, warps a block and the shared memory an
    SM holds (bytes), as the card reports them."""
    info = (ctypes.c_int * 5)()
    _cuda.check(getattr(lib, entry)(*args, ctypes.addressof(info)), entry)
    return dict(registers=info[0], local_bytes=info[1],
                warps_per_sm=info[2], warps_per_block=info[3],
                smem_per_sm=info[4])


def store_mode(store: str) -> str:
    """The kernels' mode of an edge store by its name ("int8",
    "bfloat16", "int4", "pq")."""
    expects(store in ("int8", "bfloat16", "int4", "pq"),
            "unknown edge store %r", store)
    return store if store in ("int4", "pq") else "dense"


def kernel_info(deg_p: int, dim_p: int, store: str = "int8",
                pq_dim: int = 0, book: int = 0, lut_i8: bool = True) -> dict:
    """K5's :func:`card_info` at a store's tile shape, the store by name
    (pq: with its pq_dim, book and LUT type)."""
    mode = store_mode(store)
    if mode == "pq":
        return card_info(_cuda.library("graph_expand_pq"),
                         "raft_graph_expand_pq_info", deg_p, dim_p, pq_dim,
                         book, int(lut_i8))
    return card_info(_cuda.library(_cuda.STORE_SOURCES["graph_expand"][mode]),
                     "raft_graph_expand_info", deg_p, dim_p,
                     int(store == "bfloat16"))


def graph_expand(parents: torch.Tensor, queries: torch.Tensor,
                 vecs: torch.Tensor, aux: torch.Tensor, k_out: int,
                 metric: str = "l2", degree: Optional[int] = None,
                 pen: Optional[torch.Tensor] = None, mode: str = "dense",
                 cb: Optional[torch.Tensor] = None,
                 cb_scale: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every parent's edge tile; per parent, the ``k_out`` best.

    ``parents`` (m, width) node ids (clamped into range), ``queries``
    (m, dim <= dim_p) float32, ``vecs`` (n, deg_p, W) in the store
    ``mode`` (module docstring; pq with ``cb`` and ``cb_scale``), ``aux``
    (n, 2, deg_p) float32, ``pen`` optional (n, deg_p) float32. Returns
    (vals (m, width, k_out) float32, edge positions (m, width, k_out)
    int32). K5 on CUDA, the plain version on the CPU."""
    check_mode(mode)
    fn = graph_expand_plain if vecs.device.type == "cpu" \
        else graph_expand_kernel
    return fn(parents, queries, vecs, aux, k_out, metric, degree, pen, mode,
              cb, cb_scale)
