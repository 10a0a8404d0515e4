"""Fused pairwise distance + running top-k: counterpart of
``raft_tpu/ops/fused_knn.py``, with kernel K2 (``csrc/fused_knn.cu``).

``fused_knn`` returns the k nearest corpus rows of each query for the
expanded metrics ("l2" squared L2, "cos" 1 - cosine, "ip" -dot, which the
caller negates), with the filter as an additive penalty row (+inf drops a
row). The order is (value, smallest column); empty slots are (+inf, -1).

On a CUDA tensor it launches K2 over query tiles x corpus splits
(:func:`fused_knn_candidates`). It takes every k <= n, as the JAX kernel
does: up to :data:`LIST_MAX_K` each block keeps its queries' k-lists in
shared memory, and K1 merges the splits' candidates; past it the wide
form keeps each (query, split)'s candidates in a buffer of
:func:`wide_cap` keys in device memory (a scratch from ``torch.empty`` a
call) behind a bound that every split of the query shares, and selects
each query's k from its splits' buffers at the end, so nothing is merged
after it. K2 forms the distance block on the tensor
cores as 3xTF32 (each f32 operand split into two TF32 parts, three
products summed in f32), the counterpart of the JAX package's
``precision="highest"``. On a CPU tensor it takes the plain version,
:func:`fused_knn_plain`: ``torch.matmul`` + norms + stable sort, chunked
over queries, in full float32 (``torch.backends.cuda.matmul.allow_tf32``
must stay False).

The corpus may be stored low-precision, as in the JAX kernel (``ops/quant``
codes): bfloat16 (the query rounded to bf16, each product exact in f32,
the sums in f32), int8 with per-row ``scales`` or uint8 (the f32 query
against the row widened to f32, the finished dot times the row's scale),
or int4 split-half nibbles (``int4_dim`` the logical width: the query's
low and high halves against the two nibble planes, the two half-dots
summed, then times the scale). Each store has its own form of K2 (one
library a store, ``_cuda.STORE_SOURCES``); a CUDA corpus of a store goes
to that form or the call raises.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..matrix.select_k import kpass_select_k, smallest_k_plain
from ..utils import cdiv, round_up_to
from . import _cuda
from .quant import STORES, int4_nibbles, store_dtype

__all__ = ["fused_knn", "fused_knn_plain", "fused_knn_candidates",
           "prepare_norms", "corpus_norms", "store_sq_norms", "store_of",
           "kernel_queries", "block_queries", "split_plan", "wide_cap",
           "wide_scratch_bytes", "LIST_MAX_K", "WIDE_BUDGET"]

# the counters are bumped under this lock: the serving worker and the
# recall sentinel launch from their own threads
_count_lock = threading.Lock()
launches = 0   # K2 launches since the last reset, every store's form
wide_launches = 0   # of them, the wide form's (k > LIST_MAX_K)
# of them, each low-precision store's form
launches_bfloat16 = launches_int8 = launches_uint8 = launches_int4 = 0

LIST_MAX_K = 24   # up to it a K2 block keeps its queries' k-lists in
                  # shared memory; past it the wide form (the kernel's
                  # kListMaxK)
# the wide form's buffers (m x splits·cap keys of 8 bytes, cap about 2k)
# at most this many bytes: splits shrink as k grows
WIDE_BUDGET = 2 << 30
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


def store_of(dataset: torch.Tensor, int4_dim: Optional[int] = None) -> str:
    """The store of a corpus: ``"int4"`` when ``int4_dim`` is given (its
    bytes are int8), else the name of its dtype."""
    if int4_dim is not None:
        expects(dataset.dtype == torch.int8, "an int4 corpus is packed "
                "int8 bytes, got %s", dataset.dtype)
        expects(2 * dataset.shape[1] >= int4_dim, "int4 corpus width %d "
                "cannot hold dim %d", dataset.shape[1], int4_dim)
        return "int4"
    return store_dtype(dataset.dtype)


def store_sq_norms(dataset: torch.Tensor, scales: Optional[torch.Tensor],
                   int4_dim: Optional[int] = None) -> torch.Tensor:
    """Squared L2 norms of the dequantized rows, as the JAX kernel derives
    them when none are given: the stored values' sum of squares times the
    row's squared scale (int4: both nibble planes)."""
    if int4_dim is not None:
        low, high = int4_nibbles(dataset)
        sq = (low * low + high * high).sum(dim=1)
    else:
        d = dataset.to(torch.float32)
        sq = (d * d).sum(dim=1)
    return sq if scales is None else sq * scales.to(torch.float32) ** 2


def corpus_norms(metric: str, dataset: torch.Tensor,
                 data_norms: Optional[torch.Tensor],
                 scales: Optional[torch.Tensor],
                 int4_dim: Optional[int]) -> Optional[torch.Tensor]:
    """:func:`prepare_norms` of a corpus in any store."""
    if metric == "ip":
        return None
    if data_norms is None:
        data_norms = store_sq_norms(dataset, scales, int4_dim)
    return prepare_norms(metric, None, data_norms)


def kernel_queries(q: torch.Tensor, store: str,
                   width: int) -> torch.Tensor:
    """The f32 queries K2 multiplies against a corpus of ``store``
    ``width`` elements wide: rounded to bf16 for a bf16 corpus, as the JAX
    kernel does; padded with zeros to the two halves (``2·width``) for an
    int4 corpus; as they are otherwise."""
    if store == "bfloat16":
        return q.to(torch.bfloat16).to(torch.float32)
    if store == "int4":
        return torch.nn.functional.pad(q, (0, 2 * width - q.shape[1]))
    return q


def _store_dots(q: torch.Tensor, rows, store: str,
                scales: Optional[torch.Tensor]) -> torch.Tensor:
    """(m, n) dots of f32 queries (:func:`kernel_queries`) with a corpus
    widened once (``rows``: the f32 rows, or the int4 (low, high)
    planes), then times the rows' scales."""
    if store == "int4":
        low, high = rows
        half = low.shape[1]
        dot = q[:, :half] @ low.T + q[:, half:] @ high.T
    else:
        dot = q @ rows.T
    return dot if scales is None else dot * scales[None, :]


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
                    penalty: Optional[torch.Tensor] = None,
                    scales: Optional[torch.Tensor] = None,
                    int4_dim: Optional[int] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K2: the (chunk, n) distance block by
    ``torch.matmul`` (a store's rows widened to f32 once, the store's
    contract of the module docstring), a stable sort per row, ids -1 on
    +inf slots. Query chunks keep one distance block within 1 GiB."""
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    store = store_of(dataset, int4_dim)
    expects(scales is not None or store not in ("int8", "int4"),
            "int8/int4 corpora require per-row dequant scales")
    q = queries.to(torch.float32)
    m, n = q.shape[0], dataset.shape[0]
    expects(0 < k <= n, "k=%d out of range for %d rows", k, n)
    if store == "int4":
        rows = int4_nibbles(dataset)
    else:
        rows = dataset.to(torch.float32)
    if scales is not None:
        scales = scales.to(torch.float32)
    qn = prepare_norms(metric, q)
    dn = corpus_norms(metric, dataset, data_norms, scales, int4_dim)
    qk = kernel_queries(q, store, dataset.shape[1])
    chunk = int(max(1, min(m, (1 << 30) // max(n * 4, 1))))
    outs_v, outs_i = [], []
    for s0 in range(0, m, chunk):
        dot = _store_dots(qk[s0 : s0 + chunk], rows, store, scales)
        s = _distances(dot, None if qn is None else qn[s0 : s0 + chunk],
                       dn, metric, penalty)
        v, i = smallest_k_plain(s, k)
        outs_v.append(v)
        outs_i.append(torch.where(torch.isfinite(v), i, -1))
    if m == 0:
        return (torch.empty((0, k), dtype=torch.float32, device=q.device),
                torch.empty((0, k), dtype=torch.int32, device=q.device))
    return torch.cat(outs_v), torch.cat(outs_i)


def block_queries(k: int) -> int:
    """The queries one K2 block keeps for lists of width k: 128 at every
    k (``csrc/fused_knn.cu``: the k-list plans up to :data:`LIST_MAX_K`,
    whose k-lists share the block's shared memory with the tile ring, and
    the wide form past it, which keeps a bound a query there)."""
    return 128


def wide_cap(k: int) -> int:
    """Keys of a wide K2 candidate buffer (one a query and split): 2k,
    and at least k + 128, rounded up to the 128-row tile, so a buffer
    shrunk to its k best has room for another tile's 128 keys
    (``csrc/fused_knn.cuh``)."""
    return round_up_to(max(2 * k, k + _TN), _TN)


def wide_scratch_bytes(m: int, splits: int, k: int) -> int:
    """The wide form's scratch for one launch: the candidate buffers (a
    64-bit key for each of :func:`wide_cap` slots a (query, split)), then
    a 64-bit bound a query and a 32-bit count a (query, split)."""
    return 8 * m * splits * wide_cap(k) + 8 * m + 4 * m * splits


def split_plan(m: int, n: int, k: int, slots: int,
               queries: Optional[int] = None) -> Tuple[int, int]:
    """(splits, rows per split) of K2's grid on a card that keeps ``slots``
    of its blocks resident: about 4 waves of blocks, the split count taken
    in [half, twice] that aim where the last wave is fullest (the fewest
    splits among equals), at least 4 tiles a split. Past
    :data:`LIST_MAX_K` also at least 2k rows a split, and the wide form's
    buffers (``m·splits·wide_cap(k)`` keys of 8 bytes) within
    :data:`WIDE_BUDGET`. ``queries``: a block's queries, if not
    :func:`block_queries`' (another tree's plan, timed beside this one's
    by ``tools/knn_ab.py``)."""
    tiles = cdiv(m, queries or block_queries(k))
    most = max(1, cdiv(n, 4 * _TN))
    if k > LIST_MAX_K:
        most = max(1, min(most, n // (2 * k),
                          WIDE_BUDGET // max(1, 8 * m * wide_cap(k))))
    aim = max(1, min(most, cdiv(4 * slots, tiles)))
    best, fill = (1, round_up_to(n, _TN)), -1.0
    for s in range(max(1, aim // 2), min(most, 2 * aim) + 1):
        rows = round_up_to(cdiv(n, s), _TN)
        blocks = tiles * cdiv(n, rows)
        f = blocks / (cdiv(blocks, slots) * slots)
        if f > fill + 1e-12:
            best, fill = (cdiv(n, rows), rows), f
    return best


_slots: dict = {}   # (card, k, d, metric, store) -> resident K2 blocks


def _split_plan(m: int, n: int, k: int, d: int, metric: str,
                device, store: str = "float32") -> Tuple[int, int]:
    card = torch.device(device).index
    card = torch.cuda.current_device() if card is None else card
    key = (card, k, d, metric, store)
    if key not in _slots:
        with torch.cuda.device(card):
            lib = _cuda.library(_cuda.STORE_SOURCES["fused_knn"][store])
            got = lib.raft_fused_knn_slots(k, d, _METRIC_CODE[metric], card)
        if got < 0:
            _cuda.check(-got, "fused_knn occupancy")
        _slots[key] = got
    return split_plan(m, n, k, _slots[key])


def fused_knn_candidates(q: torch.Tensor, qn: Optional[torch.Tensor],
                         data: torch.Tensor, dn: Optional[torch.Tensor],
                         penalty: Optional[torch.Tensor], k: int,
                         metric: str, scales: Optional[torch.Tensor] = None,
                         store: Optional[str] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """One launch of K2's form for the corpus's store → (values, ids)
    (m, parts·k) and ``parts``: the sorted k best of each part of the
    corpus, side by side (the k-list plans: each corpus split a part, for
    K1 to merge; the wide form: one part, the splits having met in its
    selection). ``store``: the corpus's store (its dtype's name unless
    given; ``"int4"`` must be named, and ``q`` is then (m, 2·half_p), see
    :func:`kernel_queries`); ``scales``: a low-precision store's per-row
    factors."""
    global launches, wide_launches
    expects(q.is_cuda and data.device == q.device,
            "fused_knn kernel needs queries and corpus on one CUDA device")
    store = store_dtype(data.dtype) if store is None else store
    expects(data.dtype == STORES.get(store),
            "a %s corpus cannot be stored as %s", store, data.dtype)
    m, dim = q.shape
    n = data.shape[0]
    width = dim // 2 if store == "int4" else dim
    expects(data.dim() == 2 and data.shape[1] == width
            and data.is_contiguous(),
            "corpus must be contiguous (n, %d), got %s", width,
            tuple(data.shape))
    expects(store != "int4" or dim % 128 == 0,
            "int4 queries must be (m, 2·half_p), half_p a multiple of 64, "
            "got %d", dim)
    expects(0 < k <= n, "k=%d out of range for %d rows", k, n)
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    expects(scales is not None or store not in ("int8", "int4"),
            "int8/int4 corpora require per-row dequant scales")
    expects(store != "float32" or scales is None,
            "a float32 corpus carries no scales")
    rows = [q] + [t for t in (qn, dn, penalty, scales) if t is not None]
    for t in rows:
        expects(t.dtype == torch.float32 and t.is_contiguous()
                and t.device == q.device,
                "fused_knn kernel takes contiguous float32 queries, norms, "
                "penalties and scales on %s", q.device)
    expects(metric == "ip" or (qn is not None and dn is not None),
            "metric %s needs query and corpus norms", metric)
    expects(penalty is None or penalty.shape == (n,), "penalty must be (n,)")
    expects(scales is None or scales.shape == (n,), "scales must be (n,)")
    splits, per_split = _split_plan(m, n, k, dim, metric, q.device, store)
    wide = k > LIST_MAX_K
    parts = 1 if wide else splits
    out_v = torch.empty((m, parts * k), dtype=torch.float32,
                        device=q.device)
    out_i = torch.empty((m, parts * k), dtype=torch.int32, device=q.device)
    if m == 0:
        return out_v, out_i, parts
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _cuda.library(_cuda.STORE_SOURCES["fused_knn"][store])
    if not wide:
        status = lib.raft_fused_knn(q.data_ptr(), ptr(qn), data.data_ptr(),
                                    ptr(dn), ptr(penalty), ptr(scales), m,
                                    n, dim, k, _METRIC_CODE[metric], splits,
                                    per_split, out_v.data_ptr(),
                                    out_i.data_ptr(), _cuda.stream_of(q))
    else:
        # the (query, split)s' buffers, the queries' bounds, the counts
        cap = wide_cap(k)
        scratch = torch.empty(wide_scratch_bytes(m, splits, k),
                              dtype=torch.uint8, device=q.device)
        status = lib.raft_fused_knn_wide(
            q.data_ptr(), ptr(qn), data.data_ptr(), ptr(dn), ptr(penalty),
            ptr(scales), m, n, dim, k, _METRIC_CODE[metric], splits,
            per_split, cap, scratch.data_ptr(), out_v.data_ptr(),
            out_i.data_ptr(), _cuda.stream_of(q))
    _cuda.check(status, f"fused_knn ({store})")
    with _count_lock:
        launches += 1
        wide_launches += wide
        if store != "float32":
            globals()[f"launches_{store}"] += 1
    return out_v, out_i, parts


def fused_knn(queries: torch.Tensor, dataset: torch.Tensor, k: int,
              metric: str = "l2",
              data_norms: Optional[torch.Tensor] = None,
              penalty: Optional[torch.Tensor] = None,
              scales: Optional[torch.Tensor] = None,
              int4_dim: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest rows of ``dataset`` for each query: (n, d) float32,
    bfloat16, int8 (with ``scales``) or uint8, or (n, half_p) int4 bytes
    with ``scales`` when ``int4_dim`` names the logical width.

    ``data_norms``: optional (n,) squared L2 norms of the dequantized rows
    (derived when absent). ``penalty``: optional (n,) additive row
    penalty. Returns (values (m, k), int32 ids (m, k)) best first; +inf
    slots carry -1."""
    if dataset.device.type == "cpu":
        return fused_knn_plain(queries, dataset, k, metric, data_norms,
                               penalty, scales, int4_dim)
    store = store_of(dataset, int4_dim)
    q = queries.to(device=dataset.device, dtype=torch.float32).contiguous()
    qn = prepare_norms(metric, q)
    sc = None if scales is None else scales.to(torch.float32).contiguous()
    dn = corpus_norms(metric, dataset, data_norms, sc, int4_dim)
    dn = None if dn is None else dn.contiguous()
    pen = None if penalty is None else penalty.to(torch.float32).contiguous()
    qk = kernel_queries(q, store, dataset.shape[1]).contiguous()
    cand_v, cand_i, splits = fused_knn_candidates(qk, qn, dataset, dn, pen,
                                                  k, metric, sc, store)
    if splits == 1:
        return cand_v, cand_i
    vals, pos = kpass_select_k(cand_v, k)
    ids = torch.gather(cand_i, 1, pos.long())
    return vals, torch.where(torch.isfinite(vals), ids, -1)
