"""IVF-Flat probe selection and list scan: counterpart of
``raft_tpu/ops/ivf_scan.py`` (``coarse_probe``, ``merge_pairs`` semantics,
``ivf_flat_scan``), with kernel K3 (``csrc/ivf_flat_scan.cu``).

``ivf_flat_scan`` returns, for each query, the k best rows (ids into the
cluster-sorted data, -1 for empty slots) over its probed lists, in the
min-space of the metric ("l2", "cos", or "ip" as -dot). On a CUDA tensor
it launches K3 once — one block per (query, probe) pair, each writing the
pair's sorted k best into its own k columns of a (m, p*k) buffer in
probe-rank order (:func:`ivf_flat_scan_candidates`) — and merges each
query's row with K1, the ``merge_pairs`` order: equal values go to the
lower probe rank, then the lower row. The TPU kernel's packing of pairs
into 128-query groups per list (``pack_pairs``) and its aligned DMA
padding (``pad_for_scan``, ``scan_window``) serve the MXU and VMEM and
have no counterpart here: the kernel masks each list's range itself.

On a CPU tensor it takes the plain version, :func:`ivf_flat_scan_plain`:
gather every probed row of each query back to back in probe order, score
them, one stable select — the same order, since a stable select over the
concatenation breaks ties by probe rank and then by row.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.errors import expects
from ..matrix.select_k import (SelectAlgo, kpass_select_k, select_k,
                               select_k_plain)
from . import _cuda
from .fused_knn import prepare_norms

__all__ = ["coarse_probe", "ivf_flat_scan", "ivf_flat_scan_plain",
           "ivf_flat_scan_candidates"]

launches = 0   # K3 launches since the last reset

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
                        penalty: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3 (+ the K1 merge): gather, score, stable select,
    chunked over queries so the gathered rows stay within 256 MiB."""
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
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
    dn = prepare_norms(metric, data, data_norms)
    chunk = int(max(1, (256 << 20) // (max_rows * dim * 4)))
    for s0 in range(0, m, chunk):
        qc = q[s0 : s0 + chunk]
        rows, valid, _ = _candidate_rows(probed[s0 : s0 + chunk], offsets,
                                         sizes, max_rows)
        dot = torch.bmm(data[rows], qc[:, :, None])[:, :, 0]
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
        v, loc = select_k_plain(dist, kk)
        r = torch.gather(rows, 1, loc.long()).to(torch.int32)
        out_v[s0 : s0 + chunk, :kk] = v
        out_i[s0 : s0 + chunk, :kk] = torch.where(torch.isfinite(v), r, -1)
    return out_v, out_i


def ivf_flat_scan_candidates(data: torch.Tensor, dn: Optional[torch.Tensor],
                             penalty: Optional[torch.Tensor],
                             q: torch.Tensor, qn: Optional[torch.Tensor],
                             probed: torch.Tensor, offsets: torch.Tensor,
                             sizes: torch.Tensor, k: int, metric: str
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K3 → per-pair (values, rows) (m, p*k), pairs in
    probe-rank order within each query's row."""
    global launches
    expects(q.is_cuda, "ivf_flat_scan kernel needs CUDA tensors")
    m, dim = q.shape
    p = probed.shape[1]
    expects(data.dim() == 2 and data.shape[1] == dim,
            "data must be (rows, %d), got %s", dim, tuple(data.shape))
    expects(probed.shape[0] == m, "probed must be (%d, p)", m)
    expects(0 < k <= 1024, "k=%d out of range (max 1024)", k)
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    for t in (data, dn, penalty, q, qn):
        if t is not None:
            expects(t.dtype == torch.float32 and t.is_contiguous()
                    and t.device == q.device,
                    "ivf_flat_scan kernel takes contiguous float32 tensors "
                    "on %s", q.device)
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
    # launch the pairs in list order: blocks that run together share a
    # list, so its rows come from L2 after the first read
    order = torch.argsort(probed.reshape(-1), stable=True).to(torch.int32)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _cuda.library("ivf_flat_scan")
    status = lib.raft_ivf_flat_scan(
        data.data_ptr(), ptr(dn), ptr(penalty), q.data_ptr(), ptr(qn),
        probed.data_ptr(), order.data_ptr(), offsets.data_ptr(),
        sizes.data_ptr(), m, p, dim, k, _METRIC_CODE[metric],
        out_v.data_ptr(), out_i.data_ptr(), _cuda.stream_of(q))
    _cuda.check(status, "ivf_flat_scan")
    launches += 1
    return out_v, out_i


def ivf_flat_scan(data: torch.Tensor, data_norms: torch.Tensor,
                  probed: torch.Tensor, offsets: torch.Tensor,
                  sizes: torch.Tensor, queries: torch.Tensor, k: int,
                  metric: str = "l2",
                  penalty: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the probed lists → per-query k best (min-space values, int32
    rows of ``data``, -1 where fewer than k candidates). ``data`` is the
    cluster-sorted (rows, d) float32 store, ``data_norms`` its squared row
    norms, ``offsets``/``sizes`` (n_lists,) each list's first row and
    length, ``penalty`` an optional (rows,) additive row penalty."""
    if data.device.type == "cpu":
        return ivf_flat_scan_plain(data, data_norms, probed, offsets, sizes,
                                   queries, k, metric, penalty)
    dev = data.device
    q = queries.to(device=dev, dtype=torch.float32).contiguous()
    qn = prepare_norms(metric, q)
    dn = prepare_norms(metric, data, data_norms)
    probed, offsets, sizes = (t.to(device=dev, dtype=torch.int32)
                              .contiguous() for t in (probed, offsets, sizes))
    cand_v, cand_i = ivf_flat_scan_candidates(
        data, None if dn is None else dn.contiguous(),
        None if penalty is None else penalty.contiguous(), q, qn, probed,
        offsets, sizes, k, metric)
    vals, pos = kpass_select_k(cand_v, k)
    rows = torch.gather(cand_i, 1, pos.long())
    return vals, torch.where(torch.isfinite(vals), rows, -1)
