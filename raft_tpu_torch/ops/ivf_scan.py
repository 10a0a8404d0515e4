"""IVF-Flat probe selection and list scan: counterpart of
``raft_tpu/ops/ivf_scan.py`` (``coarse_probe``, ``pack_pairs``,
``merge_pairs`` semantics, ``ivf_flat_scan``), with kernel K3
(``csrc/ivf_flat_scan.cu``).

``ivf_flat_scan`` returns, for each query, the k best rows (ids into the
cluster-sorted data, -1 for empty slots) over its probed lists, in the
min-space of the metric ("l2", "cos", or "ip" as -dot). On a CUDA tensor
it launches K3 once (:func:`ivf_flat_scan_candidates`), each pair writing
its sorted k best into its own k columns of a (m, p*k) buffer in
probe-rank order, and merges each query's row with K1, the
``merge_pairs`` order: equal values go to the lower probe rank, then the
lower row. K3 has two forms; :func:`scan_form` takes the grouped one at
every k, as the JAX kernel takes any k:

- ``"group"``: the pairs are packed by list into group tiles
  (:func:`pack_pairs`, the JAX package's grouping) of
  :func:`group_queries` queries, and one block scans a list once for a
  whole group of its queries, on the tensor cores (:func:`group_plan`:
  the group's size, its k-lists' warp queue and candidate buffers by k,
  up to :data:`GROUP_MAX_K` = 512; past it the wide plan, no k-list:
  each pair's distances to a scratch of the wrapper's from
  ``torch.empty`` a call, sized by the longest list, and one selection a
  pair, :func:`wide_scratch_on_card`);
- ``"pair"`` (k up to :data:`PAIR_MAX_K` = 1024, by name): one block
  per (query, probe) pair, each reading its whole list.

The TPU kernel's aligned DMA padding (``pad_for_scan``, ``scan_window``)
serves VMEM and has no counterpart here: the kernels mask each list's
range themselves. Kernel K4 (``ivf_pq_scan``) shares the grouping and
the forms.

On a CPU tensor it takes the plain version, :func:`ivf_flat_scan_plain`:
gather every probed row of each query back to back in probe order, score
them, one stable select — the same order, since a stable select over the
concatenation breaks ties by probe rank and then by row.

The lists may be stored float32, bfloat16, int8 with per-row ``scales``
or uint8 (``ops/quant``); each store has its own form of K3 (one library a
store, ``_cuda.STORE_SOURCES``). Both K3 and the plain version compute
what the JAX package's ``algo="xla"`` engine computes for such lists: the
f32 query against the row widened to f32, the finished dot times the
row's scale, ``(q·r)·s`` (JAX's Pallas scan rounds the query to bf16 for
these stores, a throughput choice of the TPU).
"""
from __future__ import annotations

import ctypes
import weakref
from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..matrix.select_k import (SelectAlgo, kpass_select_k, select_k,
                               smallest_k_plain)
from ..utils import cdiv, round_up_to
from . import _cuda
from .fused_knn import corpus_norms, prepare_norms
from .quant import store_dtype

__all__ = ["coarse_probe", "pack_pairs", "scan_form", "check_form",
           "GROUP_MAX_K", "PAIR_MAX_K", "group_plan", "group_queries",
           "group_smem", "group_plan_on_card", "largest_list",
           "wide_scratch_bytes", "wide_scratch_on_card", "ivf_flat_scan",
           "ivf_flat_scan_plain",
           "ivf_flat_scan_candidates"]

launches = 0         # K3 launches since the last reset, both forms
group_launches = 0   # of them, the grouped form's
pair_launches = 0    # of them, the per-pair form's
wide_launches = 0    # of the grouped ones, the wide plan's (k > 512)
# of them, each low-precision store's form (both forms)
launches_bfloat16 = launches_int8 = launches_uint8 = 0

GROUP_MAX_K = 512  # up to it a group's k-lists share the block's shared
                   # memory; past it the wide plan
PAIR_MAX_K = 1024  # the per-pair forms' k-list in shared memory
# the grouped forms' plans (csrc/ivf_flat_scan.cuh::plan_for, and K4's up
# to k = 256; past it K4 keeps no k-list: csrc/ivf_pq_scan.cu's wide plan,
# 32 queries a group): (widest k, queries a group, warp-queue registers R:
# 32·R keys, candidate buffer keys CAP a query); past GROUP_MAX_K both
# kernels' wide plan, 32 queries a group and no k-list
_GROUP_PLANS = ((32, 128, 1, 32), (64, 128, 2, 64), (128, 64, 4, 128),
                (256, 64, 8, 64), (512, 32, 16, 128))
_WIDE_PLAN = (32, 0, 0)
# csrc/tf32_tile.cuh: a block's shared memory, a row tile, a stage's width
_SMEM_LIMIT, _BN, _BK = 232_448, 128, 32
# the wide plans (csrc/tf32_tile.cuh): a block's bytes where two fit an
# SM, the static bytes beside them, the warps' selection space
# (csrc/list_select.cuh: 512 64-bit keys and 1,024 bins a warp)
_TWO_BLOCKS, _STATIC_UNIT, _SELECT_BYTES = 115_712, 128, 8 * (512 * 8
                                                             + 1024 * 4)
_STORE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1, "uint8": 1}

_METRIC_CODE = {"l2": 0, "cos": 1, "ip": 2}
_INF = float("inf")


def coarse_probe(q: torch.Tensor, centers: torch.Tensor, n_probes: int,
                 metric: str = "l2",
                 center_norms: Optional[torch.Tensor] = None,
                 survivors: Optional[torch.Tensor] = None,
                 algo: SelectAlgo = SelectAlgo.AUTO) -> torch.Tensor:
    """(m, n_probes) int32 ids of the lists each query probes: one
    ``torch.matmul`` over the centers and a select (``algo``: K1 on CUDA
    by default). Scores are ranking-only (||q||² dropped).
    ``survivors``: optional (n_lists,) filter-survivor counts; lists with
    none score +inf."""
    q = q.to(torch.float32)
    cross = q @ centers.T
    cn = (center_norms if center_norms is not None
          else (centers * centers).sum(dim=1))
    if metric == "ip":
        score = -cross
    elif metric == "cos":
        score = -cross / torch.sqrt(torch.clamp_min(cn, 1e-30))[None, :]
    else:
        score = cn[None, :] - 2.0 * cross
    if survivors is not None:
        score = torch.where(survivors[None, :] > 0, score, _INF)
    return select_k(score.contiguous(), n_probes, select_min=True,
                    algo=algo)[1]


def _candidate_rows(probed, offsets, sizes, max_rows: int):
    """(m, p) probed lists → (m, max_rows) row ids, laid out back to back
    in probe order, their validity, and the probe rank of each slot."""
    sizes_p = sizes.long()[probed.long()]
    cum = sizes_p.cumsum(dim=1)
    m, p = probed.shape
    slots = torch.arange(max_rows, dtype=torch.int64, device=probed.device)
    probe_of = torch.searchsorted(cum, slots.expand(m, max_rows).contiguous(),
                                  right=True).clamp_max(p - 1)
    prev = torch.where(probe_of > 0,
                       torch.gather(cum, 1, (probe_of - 1).clamp_min(0)), 0)
    list_of = torch.gather(probed.long(), 1, probe_of)
    rows = offsets.long()[list_of] + (slots[None, :] - prev)
    valid = slots[None, :] < cum[:, -1:]
    return torch.where(valid, rows, 0), valid, probe_of


def ivf_flat_scan_plain(data: torch.Tensor, data_norms: torch.Tensor,
                        probed: torch.Tensor, offsets: torch.Tensor,
                        sizes: torch.Tensor, queries: torch.Tensor, k: int,
                        metric: str = "l2",
                        penalty: Optional[torch.Tensor] = None,
                        scales: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 (+ the K1 merge): gather, score (a store's rows
    widened to f32, the dot times the row's scale), stable select,
    chunked over queries so the gathered rows stay within 256 MiB."""
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    expects(store_dtype(data.dtype) not in ("int8", "int4")
            or scales is not None,
            "int8 lists require per-row dequant scales")
    q = queries.to(torch.float32)
    m, dim = q.shape
    dev = q.device
    out_v = torch.full((m, k), _INF, dtype=torch.float32, device=dev)
    out_i = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    if m == 0:
        return out_v, out_i
    max_rows = max(1, int(sizes.long()[probed.long()].sum(dim=1).max()))
    kk = min(k, max_rows)
    qn = prepare_norms(metric, q)
    dn = corpus_norms(metric, data, data_norms, scales, None)
    chunk = int(max(1, (256 << 20) // (max_rows * dim * 4)))
    for s0 in range(0, m, chunk):
        qc = q[s0 : s0 + chunk]
        rows, valid, _ = _candidate_rows(probed[s0 : s0 + chunk], offsets,
                                         sizes, max_rows)
        dot = torch.bmm(data[rows].to(torch.float32),
                        qc[:, :, None])[:, :, 0]
        if scales is not None:
            dot = dot * scales[rows]
        if metric == "l2":
            dist = torch.clamp_min(qn[s0 : s0 + chunk, None] + dn[rows]
                                   - 2.0 * dot, 0.0)
        elif metric == "cos":
            dist = 1.0 - dot / torch.clamp_min(
                qn[s0 : s0 + chunk, None] * dn[rows], 1e-30)
        else:
            dist = -dot
        if penalty is not None:
            dist = dist + penalty[rows]
        dist = torch.where(valid, dist, _INF)
        v, loc = smallest_k_plain(dist, kk)
        r = torch.gather(rows, 1, loc.long()).to(torch.int32)
        out_v[s0 : s0 + chunk, :kk] = v
        out_i[s0 : s0 + chunk, :kk] = torch.where(torch.isfinite(v), r, -1)
    return out_v, out_i


def pack_pairs(probed: torch.Tensor, n_lists: int, qg: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]:
    """Pack the (query, probe) pairs into group tiles of at most ``qg``
    pairs of one list, the JAX package's ``pack_pairs``: one stable sort of
    the pairs' list ids, each list's pairs cut into ``cdiv(count, qg)``
    tiles in sorted order. → int32 ``(glist, gstart, gcount, order)``:
    ``order`` (m*p,) the sorted pair order (pair = query·p + probe rank);
    for each of the static ``cdiv(m·p, qg) + n_lists`` group tiles its
    list, the index into ``order`` of its first pair, and its count of
    pairs — 0 past the live tiles, where ``glist`` and ``gstart`` are
    unspecified. No host synchronisation."""
    m, p = probed.shape
    dev = probed.device
    lids = probed.reshape(-1).long()
    order = torch.argsort(lids, stable=True)
    slids = lids[order]
    lists = torch.arange(n_lists, device=dev)
    starts = torch.searchsorted(slids, lists)
    ends = torch.searchsorted(slids, lists, right=True)
    gcounts = (ends - starts + qg - 1) // qg      # tiles of each list
    gbase = torch.cumsum(gcounts, 0) - gcounts    # its first tile
    gids = torch.arange(cdiv(m * p, qg) + n_lists, device=dev)
    glist = (torch.searchsorted(gbase, gids, right=True) - 1).clamp(
        0, n_lists - 1)
    within = gids - gbase[glist]
    gstart = starts[glist] + within * qg
    gcount = torch.where(within < gcounts[glist],
                         torch.clamp(ends[glist] - gstart, max=qg), 0)
    return (glist.to(torch.int32), gstart.to(torch.int32),
            gcount.to(torch.int32), order.to(torch.int32))


def group_plan(k: int) -> Tuple[int, int, int]:
    """(queries a group, warp-queue registers R, candidate-buffer keys CAP)
    of the grouped K3 and K4 at k (their ``plan_for``): 128 queries up to
    k = 64, 64 up to 256, 32 up to :data:`GROUP_MAX_K`, whose queue of
    512 keys beside buffers of 128 leaves room for the tile ring; past it
    the wide plan, 32 queries and no k-list (R = CAP = 0)."""
    expects(k > 0, "no grouped IVF scan plan for k=%d", k)
    if k > GROUP_MAX_K:
        return _WIDE_PLAN
    return next(plan[1:] for plan in _GROUP_PLANS if k <= plan[0])


def group_queries(k: int) -> int:
    """The queries a group tile of the grouped K3 and K4 holds at k: the
    ``qg`` of :func:`pack_pairs`, which the kernels check."""
    return group_plan(k)[0]


def group_smem(kernel: str, k: int, d: int, store: str = "float32"
               ) -> Tuple[int, int, int]:
    """(bytes, query-tile layout, ring stages) of one grouped block of
    ``kernel`` ("ivf_flat_scan": K3 over ``store`` lists of width d;
    "ivf_pq_scan": K4, d = rot_dim), as the kernels' ``prepare`` lays it
    out (``tf32_tile.cuh::fit_tiles``): the k-lists and buffers and the
    side arrays, then the first layout that fits in a block's 232,448
    bytes — the query tile resident and split into its TF32 parts (2),
    resident (1) or streamed through the ring (0), each with the most
    stages first (the wide plans: :func:`_wide_smem`). (0, -1, 0) when
    none fits."""
    bm, _, cap = group_plan(k)
    nk = -(-d // _BK)
    lists = 8 * bm * (k + cap) + 4 * bm
    if kernel == "ivf_flat_scan":
        raw = store != "float32"
        if k > GROUP_MAX_K:
            return _wide_smem(bm, nk, 4 * 4 * (3 if raw else 2) * _BN
                              + 4 * 2 * bm, _STORE_BYTES[store] * _BK * _BN,
                              (3, 2))
        fixed = lists + 4 * 4 * (3 if raw else 2) * _BN + 4 * 2 * bm
        ns_max, b_stage = 3, _STORE_BYTES[store] * _BK * _BN
    else:
        expects(kernel == "ivf_pq_scan" and store == "float32",
                "unknown grouped scan %r over %r", kernel, store)
        if k > 256:
            return _wide_smem(bm, nk, 4 * 3 * 2 * _BN + 4 * 6 * bm
                              + 4 * 2 * nk * _BK, 4 * _BK * _BN, (2,))
        fixed = lists + 4 * 2 * 2 * _BN + 4 * 4 * bm + 4 * 2 * nk * _BK
        ns_max, b_stage = 2, 4 * _BK * _BN
    for a_res in (2, 1, 0):
        for ns in range(ns_max, 1, -1):
            total = (4 * _BK * a_res * nk * bm
                     + ns * (4 * _BK * (0 if a_res else bm) + b_stage)
                     + fixed)
            if total <= _SMEM_LIMIT:
                return total, a_res, ns
    return 0, -1, 0


def _wide_smem(bm: int, nk: int, fixed: int, b_stage: int,
               stages) -> Tuple[int, int, int]:
    """The wide plans' layout (``prepare_wide`` of
    ``csrc/ivf_pq_scan.cu``, K4 past k = 256, and of
    ``csrc/ivf_flat_scan.cuh``, K3 past 512): the tiles (query tile split,
    resident or streamed, then each ring of ``stages``) or the warps'
    selection space, whichever is larger, beside ``fixed`` bytes (K4: three
    side slots, the group's pairs, queries, norms and key ranges, the
    columns' subspaces; K3: four side slots, the group's pairs and
    queries); the first layout with room for two blocks an SM, else
    one."""
    for limit in (_TWO_BLOCKS, _SMEM_LIMIT):
        for a_res in (2, 1, 0):
            for ns in stages:
                tiles = max(4 * a_res * nk * bm * _BK
                            + ns * (4 * (0 if a_res else bm * _BK)
                                    + b_stage), _SELECT_BYTES)
                if tiles + fixed + _STATIC_UNIT <= limit:
                    return tiles + fixed, a_res, ns
    return 0, -1, 0


def group_plan_on_card(kernel: str, k: int, d: int,
                       store: str = "float32") -> Tuple[int, int, int, int]:
    """The grouped form's plan as the card's library makes it: (queries a
    group, query-tile layout, ring stages, bytes), to hold against
    :func:`group_plan` and :func:`group_smem`."""
    if kernel == "ivf_flat_scan":
        lib = _cuda.library(_cuda.STORE_SOURCES[kernel][store])
        fn = lib.raft_ivf_flat_scan_group_plan
    else:
        fn = _cuda.library(kernel).raft_ivf_pq_scan_group_plan
    out = (ctypes.c_int * 4)()
    _cuda.check(fn(k, d, ctypes.addressof(out)), f"{kernel} group plan")
    return tuple(out)


def scan_form(k: int) -> str:
    """The form of K3 and K4 for k per pair: ``"group"`` at every k (past
    :data:`GROUP_MAX_K` its wide plan). A rule of shape: a form that fails
    to build, launch or fit raises."""
    expects(k > 0, "k=%d out of range", k)
    return "group"


def check_form(form: Optional[str], k: int) -> str:
    """``form`` (None: :func:`scan_form`), checked against k: the
    per-pair form, by name, takes k up to :data:`PAIR_MAX_K`."""
    form = scan_form(k) if form is None else form
    expects(k > 0 and form in ("group", "pair")
            and (form == "group" or k <= PAIR_MAX_K),
            "IVF scan kernel: no form %r for k=%d", form, k)
    return form


_LMAX = [(lambda: None, -1, 0)]  # the last sizes tensor read: (weak
                                 # reference, its version, longest list)


def largest_list(sizes: torch.Tensor) -> int:
    """The longest list of ``sizes`` (at least 1): read from the card once
    per tensor and kept while the tensor lives unchanged, so the graph
    pass's batches over one index synchronise the host once."""
    ref, version, lmax = _LMAX[0]
    if ref() is not sizes or version != sizes._version:
        lmax = max(1, int(sizes.max()))
        _LMAX[0] = (weakref.ref(sizes), sizes._version, lmax)
    return lmax


def wide_scratch_bytes(blocks: int, lmax: int) -> int:
    """The wide plans' scratch (K4 past k = 256, K3 past 512) for
    ``blocks`` persistent blocks over lists of at most ``lmax`` rows: a
    256-byte unit for the groups' counter, then 32 distance rows a block,
    each ``lmax`` rounded up to the 128-row tile; not a function of k."""
    return 256 + 4 * blocks * 32 * round_up_to(max(lmax, 1), _BN)


def wide_scratch_on_card(kernel: str, k: int, d: int, lmax: int,
                         store: str = "float32") -> Tuple[int, int, int]:
    """The wide plan's scratch of ``kernel`` (``"ivf_flat_scan"`` over
    ``store`` lists past k = 512, ``"ivf_pq_scan"`` past k = 256, ``d``
    its rotated dimension) on the current card, as its library states it
    (``csrc/wide_plan.cuh``): (bytes, :func:`wide_scratch_bytes`'s; the
    persistent blocks; the blocks an SM keeps resident). (0, 0, 0) where
    the plan for k keeps none."""
    out = (ctypes.c_longlong * 3)()
    if kernel == "ivf_flat_scan":
        lib = _cuda.library(_cuda.STORE_SOURCES[kernel][store])
        fn = lib.raft_ivf_flat_scan_wide_scratch
    else:
        fn = _cuda.library(kernel).raft_ivf_pq_scan_group_scratch
    _cuda.check(fn(k, d, lmax, ctypes.addressof(out)), f"{kernel} scratch")
    return tuple(out)


def ivf_flat_scan_candidates(data: torch.Tensor, dn: Optional[torch.Tensor],
                             penalty: Optional[torch.Tensor],
                             q: torch.Tensor, qn: Optional[torch.Tensor],
                             probed: torch.Tensor, offsets: torch.Tensor,
                             sizes: torch.Tensor, k: int, metric: str,
                             form: Optional[str] = None,
                             scales: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the form of K3 for the lists' store → per-pair
    (values, rows) (m, p*k), pairs in probe-rank order within each
    query's row. ``form`` (``"group"`` or ``"pair"``) overrides
    :func:`scan_form`; ``scales``: int8 lists' per-row factors (no
    other store takes them)."""
    global launches, group_launches, pair_launches, wide_launches
    expects(q.is_cuda, "ivf_flat_scan kernel needs CUDA tensors")
    store = store_dtype(data.dtype)
    expects(store != "int4", "IVF-Flat has no int4 store")
    m, dim = q.shape
    p = probed.shape[1]
    expects(data.dim() == 2 and data.shape[1] == dim
            and data.is_contiguous() and data.device == q.device,
            "data must be contiguous (rows, %d) on %s, got %s", dim,
            q.device, tuple(data.shape))
    expects(probed.shape[0] == m, "probed must be (%d, p)", m)
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    expects(store == "int8" or scales is None,
            "%s lists carry no scales", store)
    expects(store != "int8" or scales is not None,
            "int8 lists require per-row dequant scales")
    form = check_form(form, k)
    for t in (dn, penalty, q, qn, scales):
        if t is not None:
            expects(t.dtype == torch.float32 and t.is_contiguous()
                    and t.device == q.device,
                    "ivf_flat_scan kernel takes contiguous float32 queries, "
                    "norms, penalties and scales on %s", q.device)
    for t in (probed, offsets, sizes):
        expects(t.dtype == torch.int32 and t.is_contiguous()
                and t.device == q.device,
                "probed/offsets/sizes must be contiguous int32 on %s",
                q.device)
    expects(metric == "ip" or (qn is not None and dn is not None),
            "metric %s needs query and row norms", metric)
    out_v = torch.empty((m, p * k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, p * k), dtype=torch.int32, device=q.device)
    if m * p == 0:
        return out_v, out_i
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _cuda.library(_cuda.STORE_SOURCES["ivf_flat_scan"][store])
    if form == "group" and k > GROUP_MAX_K:
        qg = group_queries(k)
        glist, gstart, gcount, order = pack_pairs(probed, offsets.shape[0],
                                                  qg)
        # the blocks' distance rows, as long as the longest list, from
        # PyTorch's caching allocator (stream-ordered)
        lmax = largest_list(sizes)
        nbytes = wide_scratch_on_card("ivf_flat_scan", k, dim, lmax, store)[0]
        scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        status = lib.raft_ivf_flat_scan_wide(
            data.data_ptr(), ptr(dn), ptr(penalty), ptr(scales),
            q.data_ptr(), ptr(qn),
            order.data_ptr(), glist.data_ptr(), gstart.data_ptr(),
            gcount.data_ptr(), offsets.data_ptr(), sizes.data_ptr(),
            scratch.data_ptr(), glist.shape[0], qg, p, dim, k,
            _METRIC_CODE[metric], lmax, out_v.data_ptr(), out_i.data_ptr(),
            _cuda.stream_of(q))
    elif form == "group":
        qg = group_queries(k)
        glist, gstart, gcount, order = pack_pairs(probed, offsets.shape[0],
                                                  qg)
        status = lib.raft_ivf_flat_scan_group(
            data.data_ptr(), ptr(dn), ptr(penalty), ptr(scales),
            q.data_ptr(), ptr(qn),
            order.data_ptr(), glist.data_ptr(), gstart.data_ptr(),
            gcount.data_ptr(), offsets.data_ptr(), sizes.data_ptr(),
            glist.shape[0], qg, p, dim, k, _METRIC_CODE[metric],
            out_v.data_ptr(), out_i.data_ptr(), _cuda.stream_of(q))
    else:
        # the pairs in list order, so that blocks that run together read
        # the same list
        order = torch.argsort(probed.reshape(-1), stable=True).to(
            torch.int32)
        status = lib.raft_ivf_flat_scan_pair(
            data.data_ptr(), ptr(dn), ptr(penalty), ptr(scales),
            q.data_ptr(), ptr(qn),
            probed.data_ptr(), order.data_ptr(), offsets.data_ptr(),
            sizes.data_ptr(), m, p, dim, k, _METRIC_CODE[metric],
            out_v.data_ptr(), out_i.data_ptr(), _cuda.stream_of(q))
    _cuda.check(status, f"ivf_flat_scan ({form}, {store})")
    launches += 1
    if store != "float32":
        globals()[f"launches_{store}"] += 1
    if form == "group":
        group_launches += 1
        wide_launches += k > GROUP_MAX_K
    else:
        pair_launches += 1
    return out_v, out_i


def ivf_flat_scan(data: torch.Tensor, data_norms: torch.Tensor,
                  probed: torch.Tensor, offsets: torch.Tensor,
                  sizes: torch.Tensor, queries: torch.Tensor, k: int,
                  metric: str = "l2",
                  penalty: Optional[torch.Tensor] = None,
                  form: Optional[str] = None,
                  scales: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the probed lists → per-query k best (min-space values, int32
    rows of ``data``, -1 where fewer than k candidates). ``data`` is the
    cluster-sorted (rows, d) store (float32, bfloat16, int8 with
    ``scales``, or uint8), ``data_norms`` the squared norms of its
    dequantized rows, ``offsets``/``sizes`` (n_lists,) each list's first
    row and length, ``penalty`` an optional (rows,) additive row penalty.
    ``form`` overrides :func:`scan_form` on the card (one plain version
    serves both forms on the CPU)."""
    if data.device.type == "cpu":
        expects(form in (None, "group", "pair"), "unknown form %r", form)
        return ivf_flat_scan_plain(data, data_norms, probed, offsets, sizes,
                                   queries, k, metric, penalty, scales)
    dev = data.device
    q = queries.to(device=dev, dtype=torch.float32).contiguous()
    qn = prepare_norms(metric, q)
    dn = corpus_norms(metric, data, data_norms, scales, None)
    probed, offsets, sizes = (t.to(device=dev, dtype=torch.int32)
                              .contiguous() for t in (probed, offsets, sizes))
    cand_v, cand_i = ivf_flat_scan_candidates(
        data, None if dn is None else dn.contiguous(),
        None if penalty is None else penalty.contiguous(), q, qn, probed,
        offsets, sizes, k, metric, form,
        None if scales is None else scales.to(torch.float32).contiguous())
    vals, pos = kpass_select_k(cand_v, k)
    rows = torch.gather(cand_i, 1, pos.long())
    return vals, torch.where(torch.isfinite(vals), rows, -1)
