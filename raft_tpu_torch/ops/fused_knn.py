"""Fused pairwise distance + running top-k: counterpart of
``raft_tpu/ops/fused_knn.py``, with kernel K2 (``csrc/fused_knn.cu``).

``fused_knn`` returns the k nearest corpus rows of each query for the
expanded metrics ("l2" squared L2, "cos" 1 - cosine, "ip" -dot, which the
caller negates), with the filter as an additive penalty row (+inf drops a
row). The order is (value, smallest column); empty slots are (+inf, -1).

On a CUDA tensor it launches K2 over query tiles x corpus splits
(:func:`fused_knn_candidates`) and, when the corpus was split, merges the
splits' candidates with K1. K2 forms the distance block on the tensor
cores as 3xTF32 (each f32 operand split into two TF32 parts, three
products summed in f32), the counterpart of the JAX package's
``precision="highest"``. On a CPU tensor it takes the plain version,
:func:`fused_knn_plain`: ``torch.matmul`` + norms + stable sort, chunked
over queries, in full float32 (``torch.backends.cuda.matmul.allow_tf32``
must stay False).

Only float32 corpora are ported; the JAX kernel's bf16/int8/uint8/int4
stores are later work.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..matrix.select_k import kpass_select_k, smallest_k_plain
from ..utils import cdiv, round_up_to
from . import _cuda

__all__ = ["fused_knn", "fused_knn_plain", "fused_knn_candidates",
           "prepare_norms", "block_queries", "split_plan", "MAX_K"]

launches = 0   # K2 launches since the last reset

MAX_K = 256    # a K2 block keeps its queries' k-lists in shared memory
_TN = 128      # K2's corpus tile
_METRIC_CODE = {"l2": 0, "cos": 1, "ip": 2}


def prepare_norms(metric: str, vectors: torch.Tensor,
                  sq_norms: Optional[torch.Tensor] = None
                  ) -> Optional[torch.Tensor]:
    """The norm row the distance formula reads: squared L2 norms for
    "l2", L2 norms for "cos", nothing for "ip"."""
    if metric == "ip":
        return None
    if sq_norms is None:
        sq_norms = (vectors * vectors).sum(dim=1)
    sq_norms = sq_norms.to(torch.float32)
    return sq_norms if metric == "l2" else torch.sqrt(sq_norms)


def _distances(dot, qn, dn, metric: str, penalty):
    if metric == "l2":
        s = torch.clamp_min(qn[:, None] + dn[None, :] - 2.0 * dot, 0.0)
    elif metric == "cos":
        s = 1.0 - dot / torch.clamp_min(qn[:, None] * dn[None, :], 1e-30)
    else:
        s = -dot
    # the penalty row is always added, as in the JAX kernel: a zero row
    # turns -0.0 into +0.0, so no distance is -0.0
    return s + (0.0 if penalty is None else penalty[None, :])


def fused_knn_plain(queries: torch.Tensor, dataset: torch.Tensor, k: int,
                    metric: str = "l2",
                    data_norms: Optional[torch.Tensor] = None,
                    penalty: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: the (chunk, n) distance block by
    ``torch.matmul``, a stable sort per row, ids -1 on +inf slots. Query
    chunks keep one distance block within 1 GiB."""
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    q = queries.to(torch.float32)
    d = dataset.to(torch.float32)
    m, n = q.shape[0], d.shape[0]
    expects(0 < k <= n, "k=%d out of range for %d rows", k, n)
    qn = prepare_norms(metric, q)
    dn = prepare_norms(metric, d, data_norms)
    chunk = int(max(1, min(m, (1 << 30) // max(n * 4, 1))))
    outs_v, outs_i = [], []
    for s0 in range(0, m, chunk):
        qc = q[s0 : s0 + chunk]
        s = _distances(qc @ d.T, None if qn is None else qn[s0 : s0 + chunk],
                       dn, metric, penalty)
        v, i = smallest_k_plain(s, k)
        outs_v.append(v)
        outs_i.append(torch.where(torch.isfinite(v), i, -1))
    if m == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat(outs_v), torch.cat(outs_i)


def block_queries(k: int) -> int:
    """The queries one K2 block keeps for lists of width k: 128 up to
    k = 64, 64 above (``csrc/fused_knn.cu``: its k-lists and candidate
    buffers share the block's shared memory with the tile ring)."""
    return 128 if k <= 64 else 64


def split_plan(m: int, n: int, k: int, slots: int) -> Tuple[int, int]:
    """(splits, rows per split) of K2's grid on a card that keeps ``slots``
    of its blocks resident: about 4 waves of blocks, the split count taken
    in [half, twice] that aim where the last wave is fullest (the fewest
    splits among equals), at least 4 tiles a split."""
    tiles = cdiv(m, block_queries(k))
    most = max(1, cdiv(n, 4 * _TN))
    aim = max(1, min(most, cdiv(4 * slots, tiles)))
    best, fill = (1, round_up_to(n, _TN)), -1.0
    for s in range(max(1, aim // 2), min(most, 2 * aim) + 1):
        rows = round_up_to(cdiv(n, s), _TN)
        blocks = tiles * cdiv(n, rows)
        f = blocks / (cdiv(blocks, slots) * slots)
        if f > fill + 1e-12:
            best, fill = (cdiv(n, rows), rows), f
    return best


_slots: dict = {}   # (card, k, d, metric) -> resident K2 blocks


def _split_plan(m: int, n: int, k: int, d: int, metric: str,
                device) -> Tuple[int, int]:
    card = torch.device(device).index
    card = torch.cuda.current_device() if card is None else card
    key = (card, k, d, metric)
    if key not in _slots:
        with torch.cuda.device(card):
            got = _cuda.library("fused_knn").raft_fused_knn_slots(
                k, d, _METRIC_CODE[metric], card)
        if got < 0:
            _cuda.check(-got, "fused_knn occupancy")
        _slots[key] = got
    return split_plan(m, n, k, _slots[key])


def fused_knn_candidates(q: torch.Tensor, qn: Optional[torch.Tensor],
                         data: torch.Tensor, dn: Optional[torch.Tensor],
                         penalty: Optional[torch.Tensor], k: int,
                         metric: str
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One launch of K2 → (values, ids) (m, splits*k) and ``splits``: the
    sorted k best of each corpus split, side by side."""
    global launches
    expects(q.is_cuda and data.device == q.device,
            "fused_knn kernel needs queries and corpus on one CUDA device")
    m, dim = q.shape
    n = data.shape[0]
    expects(data.dim() == 2 and data.shape[1] == dim,
            "corpus must be (n, %d), got %s", dim, tuple(data.shape))
    expects(0 < k <= min(n, MAX_K), "k=%d out of range (n=%d, max %d)", k,
            n, MAX_K)
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    rows = [q, data] + [t for t in (qn, dn, penalty) if t is not None]
    for t in rows:
        expects(t.dtype == torch.float32 and t.is_contiguous()
                and t.device == q.device,
                "fused_knn kernel takes contiguous float32 tensors on %s",
                q.device)
    expects(metric == "ip" or (qn is not None and dn is not None),
            "metric %s needs query and corpus norms", metric)
    expects(penalty is None or penalty.shape == (n,), "penalty must be (n,)")
    splits, per_split = _split_plan(m, n, k, dim, metric, q.device)
    out_v = torch.empty((m, splits * k), dtype=torch.float32,
                        device=q.device)
    out_i = torch.empty((m, splits * k), dtype=torch.int32, device=q.device)
    if m == 0:
        return out_v, out_i, splits
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _cuda.library("fused_knn")
    status = lib.raft_fused_knn(q.data_ptr(), ptr(qn), data.data_ptr(),
                                ptr(dn), ptr(penalty), m, n, dim, k,
                                _METRIC_CODE[metric], splits, per_split,
                                out_v.data_ptr(), out_i.data_ptr(),
                                _cuda.stream_of(q))
    _cuda.check(status, "fused_knn")
    launches += 1
    return out_v, out_i, splits


def fused_knn(queries: torch.Tensor, dataset: torch.Tensor, k: int,
              metric: str = "l2",
              data_norms: Optional[torch.Tensor] = None,
              penalty: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``dataset`` (n, d) float32 for each query.

    ``data_norms``: optional (n,) squared L2 row norms (derived when
    absent). ``penalty``: optional (n,) additive row penalty. Returns
    (values (m, k), int32 ids (m, k)) best first; +inf slots carry -1."""
    if dataset.device.type == "cpu":
        return fused_knn_plain(queries, dataset, k, metric, data_norms,
                               penalty)
    q = queries.to(device=dataset.device, dtype=torch.float32).contiguous()
    qn = prepare_norms(metric, q)
    dn = prepare_norms(metric, dataset, data_norms)
    dn = None if dn is None else dn.contiguous()
    pen = None if penalty is None else penalty.to(torch.float32).contiguous()
    cand_v, cand_i, splits = fused_knn_candidates(q, qn, dataset, dn, pen, k,
                                                  metric)
    if splits == 1:
        return cand_v, cand_i
    vals, pos = kpass_select_k(cand_v, k)
    ids = torch.gather(cand_i, 1, pos.long())
    return vals, torch.where(torch.isfinite(vals), ids, -1)
