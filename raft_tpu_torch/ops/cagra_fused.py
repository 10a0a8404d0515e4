"""The CAGRA traversal in one launch: counterpart of
``raft_tpu/ops/cagra_fused.py`` (``fused_traverse``), with kernel K6
(``csrc/cagra_fused.cu``), and the hop body the edge engine and K6's
plain version share.

One hop (:func:`edge_hop`, the edge engine's body in
``raft_tpu/neighbors/cagra.py::_search_jit``): pick the ``width`` best
unexplored buffer entries as parents (lowest buffer position on ties;
a parent that is not finite is clamped to node 0 and its candidates are
masked), expand them through K5 (``graph_expand``) to their ``k'`` best
edges, map edge positions to node ids through the padded graph rows,
mask candidates already in the buffer or earlier in (parent, rank) order
(:func:`dup_mask`), and merge by one select over (buffer ++ candidates),
ties to the lower concat position, explored flags carried.

:func:`fused_traverse` runs ``max_iter`` such hops from the seeded
buffer: K6 on CUDA (:func:`fused_traverse_kernel`), the plain version
(:func:`fused_traverse_plain`, ``max_iter`` calls of :func:`edge_hop` on
the plain K5 and the plain select) on the CPU. A hop whose buffer has no
finite unexplored entry changes no distance or id, so K6 stops early and
the results agree. Dense stores (int8, bf16) only: the int4 mode raises;
K6 takes itopk and deg_p up to 256.
``fused_capable`` (the TPU's 8 MB VMEM cap) and ``one_dispatch_stats``
(a jaxpr walk) have no counterpart: K6 checks its own shared-memory need
and raises above the card's limit.
"""
from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..core.errors import expects
from ..matrix.select_k import select_k, select_k_plain
from . import _cuda
from .graph_expand import (MAX_DEG_P, card_info, check_mode, check_tile,
                           graph_expand, graph_expand_plain, pad_queries)

__all__ = ["fused_traverse", "fused_traverse_plain", "fused_traverse_kernel",
           "edge_hop", "pick_parents", "merge_candidates", "dup_mask",
           "kernel_info"]

launches = 0   # K6 launches since the last reset

_METRIC_CODE = {"l2": 0, "ip": 1}
_INF = float("inf")


def dup_mask(cand: torch.Tensor, keep: Optional[torch.Tensor] = None
             ) -> torch.Tensor:
    """(m, c) bool: ``cand[i, j]`` equals an entry of ``keep[i]`` or an
    earlier ``cand[i, j' < j]``. One stable sort of (keep ++ cand) brings
    equal ids together, a neighbor compare flags all but the first of each
    run, and the sort's permutation carries the flags back."""
    m, c = cand.shape
    allv = cand if keep is None else torch.cat([keep.to(cand.dtype), cand],
                                               dim=1)
    sv, order = torch.sort(allv, dim=1, stable=True)
    dup_s = torch.cat([torch.zeros((m, 1), dtype=torch.bool,
                                   device=cand.device),
                       sv[:, 1:] == sv[:, :-1]], dim=1)
    out = torch.empty_like(dup_s).scatter_(1, order, dup_s)
    return out[:, allv.shape[1] - c:]


def pick_parents(buf_d: torch.Tensor, buf_i: torch.Tensor,
                 explored: torch.Tensor, width: int, select: Callable
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The ``width`` best unexplored entries → (parent ids with the
    non-finite ones clamped to 0, parent_ok, explored with the picks
    marked)."""
    cand_d = torch.where(explored, _INF, buf_d)
    pv, psel = select(cand_d, width)
    psel = psel.long()
    parent_ok = torch.isfinite(pv)
    explored = explored.scatter(1, psel, True)
    psafe = torch.where(parent_ok, torch.gather(buf_i, 1, psel).long(), 0)
    return psafe, parent_ok, explored


def merge_candidates(buf_d, buf_i, explored, cand, cd, cand_ok, select):
    """Mask duplicate and not-ok candidates, then the ``itopk`` best of
    (buffer ++ candidates) by (value, concat position), explored flags
    carried (candidates unexplored)."""
    cand_ok = cand_ok & ~dup_mask(cand, keep=buf_i)
    cd = torch.where(cand_ok, cd, _INF)
    all_d = torch.cat([buf_d, cd], dim=1)
    all_i = torch.cat([buf_i, cand.to(buf_i.dtype)], dim=1)
    all_e = torch.cat([explored, torch.zeros_like(cand, dtype=torch.bool)],
                      dim=1)
    new_d, sel = select(all_d, buf_d.shape[1])
    sel = sel.long()
    return (new_d, torch.gather(all_i, 1, sel),
            torch.gather(all_e, 1, sel))


def edge_hop(queries, buf_d, buf_i, explored, vecs, aux, gph, pen=None, *,
             width: int, kprime: int, degree: int, metric: str = "l2",
             select: Callable = select_k, expand: Callable = graph_expand):
    """One hop of the edge engine → (buf_d, buf_i, explored). ``select``
    and ``expand`` default to the dispatching K1 and K5 wrappers; the
    plain K6 passes their plain versions (the same values, so the same
    result)."""
    m = buf_d.shape[0]
    psafe, parent_ok, explored = pick_parents(buf_d, buf_i, explored, width,
                                              select)
    pvals, pepos = expand(psafe, queries, vecs, aux, kprime, metric, degree,
                          pen)
    nbr = gph[psafe]                                      # (m, w, deg_p)
    cand = torch.gather(nbr, 2, pepos.clamp_min(0).long())
    # an empty slot must not alias a real id: it would mark a later
    # genuine occurrence as a duplicate
    cand = torch.where(pepos >= 0, cand, -1).reshape(m, width * kprime)
    cand_ok = (parent_ok.repeat_interleave(kprime, dim=1)
               & (pepos >= 0).reshape(m, width * kprime))
    return merge_candidates(buf_d, buf_i, explored, cand,
                            pvals.reshape(m, width * kprime), cand_ok,
                            select)


def fused_traverse_plain(queries, buf_d, buf_i, vecs, aux, gph, pen=None, *,
                         itopk: int, width: int, max_iter: int, kprime: int,
                         degree: int, metric: str = "l2",
                         mode: str = "dense"):
    """Plain version of K6: ``max_iter`` hops of :func:`edge_hop` on the
    plain K5 and the plain select."""
    check_mode(mode)
    expects(buf_d.shape[1] == itopk, "buffer must be (m, %d)", itopk)
    explored = torch.zeros(buf_d.shape, dtype=torch.bool,
                           device=buf_d.device)
    for _ in range(max_iter):
        buf_d, buf_i, explored = edge_hop(
            queries, buf_d, buf_i, explored, vecs, aux, gph, pen,
            width=width, kprime=kprime, degree=degree, metric=metric,
            select=select_k_plain, expand=graph_expand_plain)
    return buf_d, buf_i


def fused_traverse_kernel(queries, buf_d, buf_i, vecs, aux, gph, pen=None,
                          *, itopk: int, width: int, max_iter: int,
                          kprime: int, degree: int, metric: str = "l2"):
    """One launch of K6 on CUDA tensors → (buf_d (m, itopk) float32,
    buf_i (m, itopk) int32, hops (m,) int32, parents (m,) int32): the
    hops each query took before its frontier closed, and the parents it
    expanded. The rows of ``buf_d`` may come in any order: K6 sorts each
    by (value, position) as it loads it, the order in which the plain
    hop picks and folds."""
    global launches
    expects(vecs.is_cuda, "cagra_fused kernel needs a CUDA tensor, got %s",
            vecs.device)
    expects(metric in _METRIC_CODE, "unknown metric %r", metric)
    expects(vecs.dim() == 3 and vecs.dtype in (torch.int8, torch.bfloat16)
            and vecs.is_contiguous(),
            "edge store must be a contiguous (n, deg_p, dim_p) int8 or "
            "bfloat16 tensor, got %s %s", vecs.dtype, tuple(vecs.shape))
    n, deg_p, dim_p = vecs.shape
    dev = vecs.device
    check_tile(deg_p, dim_p)
    expects(0 < degree <= deg_p and 0 < kprime <= deg_p and width > 0,
            "degree %d / kprime %d / width %d out of range for deg_p %d",
            degree, kprime, width, deg_p)
    m = buf_d.shape[0]
    expects(buf_d.shape == (m, itopk) and buf_i.shape == (m, itopk)
            and 0 < itopk <= MAX_DEG_P,
            "buffers must be (m, %d), itopk at most %d", itopk, MAX_DEG_P)
    expects(aux.shape == (n, 2, deg_p) and aux.dtype == torch.float32
            and aux.is_contiguous() and aux.device == dev,
            "aux must be a contiguous float32 (n, 2, deg_p) tensor")
    expects(gph.shape == (n, deg_p) and gph.dtype == torch.int32
            and gph.is_contiguous() and gph.device == dev,
            "graph rows must be a contiguous int32 (n, deg_p) tensor")
    expects(pen is None or (pen.shape == (n, deg_p)
                            and pen.dtype == torch.float32
                            and pen.is_contiguous() and pen.device == dev),
            "pen must be a contiguous float32 (n, deg_p) tensor")
    lib = _cuda.library("cagra_fused")
    smem = lib.raft_cagra_fused_smem(itopk, width, kprime, deg_p, dim_p,
                                     int(vecs.dtype == torch.bfloat16))
    expects(smem <= _cuda.SMEM_PER_BLOCK, "cagra_fused needs %d bytes of "
            "shared memory a warp (itopk %d, width %d, k' %d, dim_p %d), "
            "above the card's %d a block", smem, itopk, width, kprime, dim_p,
            _cuda.SMEM_PER_BLOCK)
    q = pad_queries(queries.to(dev), dim_p)
    bd = buf_d.to(device=dev, dtype=torch.float32).contiguous()
    bi = buf_i.to(device=dev, dtype=torch.int32).contiguous()
    out_d = torch.empty_like(bd)
    out_i = torch.empty_like(bi)
    hops = torch.zeros((m,), dtype=torch.int32, device=dev)
    parents = torch.zeros((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return out_d, out_i, hops, parents
    # the persistent warps' query counter, zeroed by the library on the
    # stream
    counter = torch.empty((1,), dtype=torch.int32, device=dev)
    status = lib.raft_cagra_fused(
        q.data_ptr(), bd.data_ptr(), bi.data_ptr(), vecs.data_ptr(),
        aux.data_ptr(), gph.data_ptr(),
        None if pen is None else pen.data_ptr(), m, n, itopk, width,
        max_iter, kprime, deg_p, dim_p, degree, _METRIC_CODE[metric],
        int(vecs.dtype == torch.bfloat16), counter.data_ptr(),
        out_d.data_ptr(),
        out_i.data_ptr(), hops.data_ptr(), parents.data_ptr(),
        _cuda.stream_of(vecs))
    _cuda.check(status, "cagra_fused")
    launches += 1
    return out_d, out_i, hops, parents


def kernel_info(itopk: int, width: int, kprime: int, deg_p: int,
                dim_p: int, dtype=torch.int8) -> dict:
    """K6's :func:`~raft_tpu_torch.ops.graph_expand.card_info` at a
    traversal's shape."""
    return card_info(_cuda.library("cagra_fused"), "raft_cagra_fused_info",
                     itopk, width, kprime, deg_p, dim_p,
                     int(dtype == torch.bfloat16))


def fused_traverse(queries, buf_d, buf_i, vecs, aux, gph, pen=None, *,
                   itopk: int, width: int, max_iter: int, kprime: int,
                   degree: int, metric: str = "l2", mode: str = "dense"):
    """The whole traversal from the seeded buffer → the converged
    (buf_d (m, itopk), buf_i (m, itopk)). ``gph`` (n, deg_p) int32 is the
    store's padded graph rows, ``pen`` the optional (n, deg_p) edge
    penalty. K6 on CUDA, the plain version on the CPU."""
    check_mode(mode)
    kw = dict(itopk=itopk, width=width, max_iter=max_iter, kprime=kprime,
              degree=degree, metric=metric)
    if vecs.device.type == "cpu":
        return fused_traverse_plain(queries, buf_d, buf_i, vecs, aux, gph,
                                    pen, **kw)
    out_d, out_i, _, _ = fused_traverse_kernel(queries, buf_d, buf_i, vecs,
                                               aux, gph, pen, **kw)
    return out_d, out_i
