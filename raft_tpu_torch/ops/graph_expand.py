"""CAGRA frontier expansion: counterpart of ``raft_tpu/ops/graph_expand.py``
(``graph_expand``), with kernel K5 (``csrc/graph_expand.cu``).

``cagra.prepare_traversal`` packs, for every node, its ``degree``
neighbors' stored vectors into one contiguous ``(deg_p, dim_p)`` tile of
an ``(n, deg_p, dim_p)`` edge store (int8 with per-edge scales, or bf16),
beside an ``(n, 2, deg_p)`` float32 aux of [per-edge scales, dequantized
norms]. Expanding a parent reads its one tile instead of ``degree``
scattered rows. For each (query, parent) pair, :func:`graph_expand`
scores the tile against the query — ``max(||q||² + ||v||² - 2·s·q·v, 0)``
("l2") or ``-s·q·v`` ("ip"), plus an optional per-edge penalty (+inf
drops an edge, the bitset filter), pad edges (position >= ``degree``)
+inf — and returns the parent's ``k_out`` best as (value, edge position),
best first, lowest position on ties, (+inf, -1) for empty slots.

On a CUDA tensor it launches K5 (:func:`graph_expand_kernel`); on a CPU
tensor it takes the plain version, :func:`graph_expand_plain`, which adds
in the kernel's order (:func:`lane_order_dot`: 32 lane partial sums over
4-dim groups of each 128-dim chunk, then an xor butterfly), so the two
agree bit for bit on any input, as do K6 and its plain version. Only the
dense stores (int8, bf16) are ported: the int4 and PQ modes raise; K5
and K6 take tiles of up to 256 edges (:func:`check_tile`). The
TPU kernel's choices that serve its hardware have no counterpart here:
``_pick_pq`` (queries per grid step), the one-hot matmul that routes each
parent its query row, and the 128-lane output padding (``kp``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..matrix.select_k import smallest_k_plain
from . import _cuda

__all__ = ["graph_expand", "graph_expand_plain", "graph_expand_kernel",
           "lane_order_dot", "check_mode", "check_tile", "pad_queries",
           "kernel_info"]

launches = 0   # K5 launches since the last reset

_METRIC_CODE = {"l2": 0, "ip": 1}
_STORE_DTYPES = (torch.int8, torch.bfloat16)
MAX_DEG_P = 256                   # the kernels sort at most 8 keys a lane


def check_mode(mode: str) -> None:
    """Only the dense storage mode (int8 / bf16 rows) is ported."""
    expects(mode in ("dense", "int4", "pq"), "unknown store mode %r", mode)
    expects(mode == "dense", "store mode %r is not ported yet", mode)


def check_tile(deg_p: int, dim_p: int) -> None:
    """The tile shapes K5 and K6 take: (32·a, 128·b), deg_p <= 256."""
    expects(deg_p % 32 == 0 and dim_p % 128 == 0 and deg_p <= MAX_DEG_P,
            "edge store tiles must be (32·a <= %d, 128·b), got (%d, %d)",
            MAX_DEG_P, deg_p, dim_p)


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


def graph_expand_plain(parents: torch.Tensor, queries: torch.Tensor,
                       vecs: torch.Tensor, aux: torch.Tensor, k_out: int,
                       metric: str = "l2", degree: Optional[int] = None,
                       pen: Optional[torch.Tensor] = None,
                       mode: str = "dense"
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: gather the parents' tiles, widen to float32,
    multiply by the query, sum along dim in the kernel's order, scale,
    apply the epilogue and take a stable sort's first ``k_out`` per
    parent."""
    check_mode(mode)
    expects(metric in _METRIC_CODE, "unknown metric %r", metric)
    n, deg_p, dim_p = vecs.shape
    degree = deg_p if degree is None else degree
    m, width = parents.shape
    q = pad_queries(queries, dim_p)
    pids = parents.long().clamp(0, n - 1)                  # (m, w)
    tiles = vecs[pids].to(torch.float32)          # (m, w, deg_p, dim_p)
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


def graph_expand_kernel(parents: torch.Tensor, queries: torch.Tensor,
                        vecs: torch.Tensor, aux: torch.Tensor, k_out: int,
                        metric: str = "l2", degree: Optional[int] = None,
                        pen: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K5 on CUDA tensors → (vals, edge positions), each
    (m, width, k_out)."""
    global launches
    expects(vecs.is_cuda, "graph_expand kernel needs a CUDA tensor, got %s",
            vecs.device)
    expects(metric in _METRIC_CODE, "unknown metric %r", metric)
    expects(vecs.dim() == 3 and vecs.dtype in _STORE_DTYPES
            and vecs.is_contiguous(),
            "edge store must be a contiguous (n, deg_p, dim_p) int8 or "
            "bfloat16 tensor, got %s %s", vecs.dtype, tuple(vecs.shape))
    n, deg_p, dim_p = vecs.shape
    degree = deg_p if degree is None else degree
    check_tile(deg_p, dim_p)
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
    lib = _cuda.library("graph_expand")
    smem = lib.raft_graph_expand_smem(dim_p, int(vecs.dtype == torch.bfloat16))
    expects(smem <= _cuda.SMEM_PER_BLOCK, "graph_expand needs %d bytes of "
            "shared memory a warp (dim_p %d), above the card's %d a block",
            smem, dim_p, _cuda.SMEM_PER_BLOCK)
    m, width = parents.shape
    q = pad_queries(queries.to(vecs.device), dim_p)
    pids = parents.to(device=vecs.device, dtype=torch.int32).clamp(
        0, n - 1).contiguous()
    out_v = torch.empty((m, width, k_out), dtype=torch.float32,
                        device=vecs.device)
    out_i = torch.empty((m, width, k_out), dtype=torch.int32,
                        device=vecs.device)
    if m * width == 0:
        return out_v, out_i
    status = lib.raft_graph_expand(
        pids.data_ptr(), q.data_ptr(), vecs.data_ptr(), aux.data_ptr(),
        None if pen is None else pen.data_ptr(), m * width, width, deg_p,
        dim_p, degree, k_out, _METRIC_CODE[metric],
        int(vecs.dtype == torch.bfloat16), out_v.data_ptr(),
        out_i.data_ptr(), _cuda.stream_of(vecs))
    _cuda.check(status, "graph_expand")
    launches += 1
    return out_v, out_i


def card_info(lib, entry: str, *args) -> dict:
    """A kernel's registers a thread, local memory a thread (bytes:
    spills) and resident warps an SM, as the card reports them."""
    info = (ctypes.c_int * 3)()
    _cuda.check(getattr(lib, entry)(*args, ctypes.addressof(info)), entry)
    return dict(registers=info[0], local_bytes=info[1],
                warps_per_sm=info[2])


def kernel_info(deg_p: int, dim_p: int, dtype=torch.int8) -> dict:
    """K5's :func:`card_info` at a store's tile shape."""
    return card_info(_cuda.library("graph_expand"), "raft_graph_expand_info",
                     deg_p, dim_p, int(dtype == torch.bfloat16))


def graph_expand(parents: torch.Tensor, queries: torch.Tensor,
                 vecs: torch.Tensor, aux: torch.Tensor, k_out: int,
                 metric: str = "l2", degree: Optional[int] = None,
                 pen: Optional[torch.Tensor] = None, mode: str = "dense"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score every parent's edge tile; per parent, the ``k_out`` best.

    ``parents`` (m, width) node ids (clamped into range), ``queries``
    (m, dim <= dim_p) float32, ``vecs`` (n, deg_p, dim_p) int8 | bf16,
    ``aux`` (n, 2, deg_p) float32, ``pen`` optional (n, deg_p) float32.
    Returns (vals (m, width, k_out) float32, edge positions (m, width,
    k_out) int32). K5 on CUDA, the plain version on the CPU."""
    check_mode(mode)
    if vecs.device.type == "cpu":
        return graph_expand_plain(parents, queries, vecs, aux, k_out, metric,
                                  degree, pen)
    return graph_expand_kernel(parents, queries, vecs, aux, k_out, metric,
                               degree, pen)
