"""IVF-PQ list scan: counterpart of ``raft_tpu/ops/ivf_pq_scan.py``
(``pq_chunk_rows``, ``decoded_row_norms``, the LUT-mode codebook
preparation of ``_ivf_pq_scan_jit``, ``ivf_pq_scan``), with kernel K4
(``csrc/ivf_pq_scan.cu``).

The scan scores a probed list's PQ-coded rows in the JAX package's
*expanded* form, in which the lookup table depends on the query alone::

    l2:  d(q, i) = max(||q||² + ||c_l + dec_i||² - 2·q·c_l - 2·Σ_s lut[s, code_is], 0)
    ip:  d(q, i) = -q·c_l - Σ_s lut[s, code_is]
    lut[s, b] = Σ_l q[s·pq_len + l] · cb[s, b, l]

plus the additive penalty row; rows outside the list are +inf. With
per-cluster codebooks (``per_cluster=True``: one (book, pq_len) codebook
a list, (n_lists, book, pq_len) in all) every subspace of a list's rows
decodes through its list's codebook, ``lut[s, b] = Σ_l q[s·pq_len + l] ·
cb[L, b, l]`` for the probed list L, so the table depends on the
(query, probe) pair. The row
norms ``||c_l + dec_i||²`` come from the unrounded float32 codebook
(:func:`decoded_row_norms`, once per index); only the ``q·decode`` term
reads the codebook of the LUT mode (:func:`lut_codebook`): ``"f32"`` as
it is, ``"bf16"`` rounded to bfloat16, ``"int8"`` quantized per subspace
with a symmetric scale and decoded back to float32 (per-subspace
codebooks only: the JAX package's gather path, which serves per-cluster
codebooks, takes bf16 for an int8 request, and so does the port's
``ivf_pq.search``).

On a CUDA tensor :func:`ivf_pq_scan` launches K4 once
(:func:`ivf_pq_scan_candidates`), each pair writing its sorted k best
into its own k columns of a (m, p*k) buffer in probe-rank order, and
merges each query's row with K1, the ``merge_pairs`` order: equal values
go to the lower probe rank, then the lower row. K4 has K3's two forms
(``ivf_scan.scan_form`` takes the grouped one at every k): the grouped
form (K3's plans: ``ivf_scan.group_plan``; CAGRA's IVF-PQ graph pass asks for
k = 257) takes the pairs packed by list (``ivf_scan.pack_pairs``), decodes a
list's codes into rows once per group tile and multiplies the group's
queries by them on the tensor cores, as the TPU kernel does, so
``Σ_s lut[s, code_is]`` becomes a dot of q with the decoded row over the
rotated dimensions (past k = 256 its own plan keeps each pair's distances
in a scratch that the wrapper takes from ``torch.empty`` a call, sized by
the longest list and not by k, and selects each pair's k once, by a
radix select, in rounds of 512 keys past k = 512:
``csrc/list_select.cuh``; so the grouped form takes every k); the
per-pair form (k up to 1024, by name) builds each pair's
lookup table in shared memory and sums it subspace by subspace; it takes
per-subspace codebooks only. The grouped form takes either kind: with
per-cluster codebooks it decodes a group tile through the codebook of
the tile's list (one more argument and one base pointer a tile, its
own entry ``raft_ivf_pq_scan_group_per_cluster`` and its own counter,
``per_cluster_launches``). On a CPU
tensor it takes the plain version, :func:`ivf_pq_scan_plain`, which
gathers every probed row of each query back to back in probe order, sums
LUT entries subspace by subspace and makes one stable select. On
integer-valued inputs every order gives the same sums.

``make_cb_matrix``, ``pad_codes_for_scan`` and ``scan_window`` have no
counterpart: the block-diagonal codebook matrix feeds the TPU's one-hot
decode GEMM on the MXU, and the padding serves its aligned DMA windows
and VMEM. The CUDA kernels decode from the codebook and mask each list's
range themselves.
"""
from __future__ import annotations

import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import expects
from ..matrix.select_k import kpass_select_k, smallest_k_plain
from . import _cuda
from .ivf_scan import (GROUP_MAX_K, _candidate_rows, check_form,
                       group_queries, largest_list, pack_pairs,
                       wide_scratch_on_card)

__all__ = ["pq_chunk_rows", "decoded_row_norms", "int8_codebook",
           "lut_codebook", "pq_lut", "pq_lut_per_cluster", "ivf_pq_scan",
           "ivf_pq_scan_plain",
           "ivf_pq_scan_candidates", "largest_list"]

# the counters are bumped under this lock: the serving worker and the
# recall sentinel launch from their own threads
_count_lock = threading.Lock()
launches = 0         # K4 launches since the last reset, both forms
group_launches = 0   # of them, the grouped form's
per_cluster_launches = 0  # of the grouped ones, on per-cluster codebooks
pair_launches = 0    # of them, the per-pair form's
wide_launches = 0    # of the grouped ones, past k = 512 (in rounds)

_METRIC_CODE = {"l2": 0, "ip": 1}
_LUT_MODES = ("f32", "bf16", "int8")
_INF = float("inf")
_THREADS = 256                 # rows per tile = threads of a per-pair block
_TF32_LOW = 0x1FFF             # the f32 mantissa bits TF32 drops
WIDE_K = 256                   # past it the grouped K4 keeps a scratch


def pq_chunk_rows(pq_dim: int, book: int,
                  budget_bytes: int = 2 << 30) -> int:
    """Row-chunk bound for passes whose per-row cost is a (pq_dim, book)
    float32 plane (the encode argmin, the codebook Lloyd steps, the row
    norms): at most ``budget_bytes`` of that plane, and 256k rows."""
    return max(4096, min(1 << 18, budget_bytes // max(pq_dim * book * 4, 1)))


def decoded_row_norms(codes: torch.Tensor, centers_rot: torch.Tensor,
                      codebooks: torch.Tensor, list_offsets: np.ndarray,
                      per_cluster: bool = False) -> torch.Tensor:
    """(rows,) ``||c_l(i) + decode(i)||²`` for every row of the
    cluster-sorted ``codes``, slack rows included (their list is the one
    whose capacity span holds them). Subspaces are orthogonal, so this is
    ``||c||² + 2 Σ_s c_s·cb[s, code] + Σ_s ||cb[s, code]||²``, with
    ``cb[l(i), code]`` in every subspace for per-cluster codebooks;
    computed in row chunks of :func:`pq_chunk_rows`."""
    _, book, pq_len = codebooks.shape
    pq_dim = codes.shape[1]
    dev = codes.device
    n = codes.shape[0]
    spans = torch.as_tensor(np.diff(np.asarray(list_offsets)), device=dev)
    labels = torch.repeat_interleave(
        torch.arange(len(spans), device=dev), spans)
    cb = codebooks.to(torch.float32)
    sub = torch.arange(pq_dim, device=dev)[None, :]
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    chunk = pq_chunk_rows(pq_dim, book)
    for b0 in range(0, n, chunk):
        lab = labels[b0 : b0 + chunk]
        c = centers_rot[lab].to(torch.float32)
        books = lab[:, None] if per_cluster else sub
        dec = cb[books, codes[b0 : b0 + chunk].long()]  # (b, pq_dim, pq_len)
        cs = c.reshape(c.shape[0], pq_dim, pq_len)
        cross = 2.0 * (cs * dec).sum(dim=(1, 2))
        dec2 = (dec * dec).sum(dim=(1, 2))
        out[b0 : b0 + chunk] = (c * c).sum(dim=1) + cross + dec2
    return out


def int8_codebook(codebooks: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-subspace symmetric int8 quantization of a (pq_dim, book,
    pq_len) codebook → (int8 values, (pq_dim,) float32 scales):
    ``scale = max(absmax_s, 1e-12) / 127``, values
    ``clip(round(cb / scale), -127, 127)`` (round half to even)."""
    cb = codebooks.to(torch.float32)
    absmax = cb.abs().amax(dim=(1, 2))
    scales = torch.clamp_min(absmax, 1e-12) / 127.0
    vals = torch.clamp(torch.round(cb / scales[:, None, None]), -127, 127)
    return vals.to(torch.int8), scales


def lut_codebook(codebooks: torch.Tensor, mode: str) -> torch.Tensor:
    """The float32 codebook the ``q·decode`` term reads in LUT ``mode``:
    "f32" as it is, "bf16" rounded to bfloat16 (nearest even), "int8"
    quantized by :func:`int8_codebook` and decoded as ``q_int·scale``."""
    expects(mode in _LUT_MODES, "unknown LUT mode %r", mode)
    cb = codebooks.to(torch.float32)
    if mode == "bf16":
        return cb.to(torch.bfloat16).to(torch.float32)
    if mode == "int8":
        vals, scales = int8_codebook(cb)
        return vals.to(torch.float32) * scales[:, None, None]
    return cb


def pq_lut(q_rot: torch.Tensor, cb_mode: torch.Tensor) -> torch.Tensor:
    """(m, pq_dim, book) lookup table ``lut[s, b] = Σ_l q[s·pq_len + l] ·
    cb[s, b, l]``, summed over l in order (the plain version's order; the
    per-pair kernel's too)."""
    pq_dim, book, pq_len = cb_mode.shape
    qs = q_rot.reshape(q_rot.shape[0], pq_dim, pq_len)
    lut = torch.zeros((q_rot.shape[0], pq_dim, book), dtype=torch.float32,
                      device=q_rot.device)
    for l in range(pq_len):
        lut = lut + qs[:, :, l, None] * cb_mode[None, :, :, l]
    return lut


def pq_lut_per_cluster(q_rot: torch.Tensor, cb_mode: torch.Tensor,
                       probed: torch.Tensor, pq_dim: int) -> torch.Tensor:
    """(m, p, pq_dim, book) lookup tables of per-cluster codebooks, one a
    (query, probe) pair: ``lut[i, j, s, b] = Σ_l q_i[s·pq_len + l] ·
    cb[probed[i, j], b, l]``, summed over l in order."""
    _, book, pq_len = cb_mode.shape
    m, p = probed.shape
    qs = q_rot.reshape(m, 1, pq_dim, 1, pq_len)
    books = cb_mode[probed.long()][:, :, None]     # (m, p, 1, book, pq_len)
    lut = torch.zeros((m, p, pq_dim, book), dtype=torch.float32,
                      device=q_rot.device)
    for l in range(pq_len):
        lut = lut + qs[..., l] * books[..., l]
    return lut


def _scan_smem_bytes(pq_dim: int, book: int, rot_dim: int, k: int) -> int:
    """Dynamic shared memory of one per-pair K4 block: the float32 LUT,
    the query, one tile of candidate distances and the pair's k-best
    list."""
    return 4 * (pq_dim * book + rot_dim + _THREADS) + 8 * k


def ivf_pq_scan_plain(codes: torch.Tensor, row_norms: torch.Tensor,
                      centers_rot: torch.Tensor, cb_mode: torch.Tensor,
                      probed: torch.Tensor, offsets: torch.Tensor,
                      sizes: torch.Tensor, q_rot: torch.Tensor, k: int,
                      metric: str = "l2",
                      penalty: Optional[torch.Tensor] = None,
                      per_cluster: bool = False
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K4 (+ the K1 merge): gather each query's probed
    rows back to back in probe order, sum their LUT entries subspace by
    subspace (per-cluster codebooks: the LUT of the row's probe), apply
    the epilogue, one stable select. Chunked over queries so the gathered
    codes and the per-cluster LUTs stay within 256 MiB."""
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    q = q_rot.to(torch.float32)
    m = q.shape[0]
    pq_dim = codes.shape[1]
    book = cb_mode.shape[1]
    dev = q.device
    out_v = torch.full((m, k), _INF, dtype=torch.float32, device=dev)
    out_i = torch.full((m, k), -1, dtype=torch.int32, device=dev)
    if m == 0:
        return out_v, out_i
    probed = probed.long()
    max_rows = max(1, int(sizes.long()[probed].sum(dim=1).max()))
    kk = min(k, max_rows)
    qn = (q * q).sum(dim=1)
    per_q = max_rows * (pq_dim + 24)
    if per_cluster:
        per_q += probed.shape[1] * (pq_dim + cb_mode.shape[2]) * book * 4
    chunk = int(max(1, (256 << 20) // per_q))
    for s0 in range(0, m, chunk):
        qc = q[s0 : s0 + chunk]
        pr = probed[s0 : s0 + chunk]
        rows, valid, probe_of = _candidate_rows(pr, offsets, sizes, max_rows)
        cross = torch.bmm(centers_rot[pr].to(torch.float32),
                          qc[:, :, None])[:, :, 0]        # (mc, p) q·c_l
        qcl = torch.gather(cross, 1, probe_of)
        cg = codes[rows]                                   # (mc, S, pq_dim)
        acc = torch.zeros(rows.shape, dtype=torch.float32, device=dev)
        if per_cluster:
            lut = pq_lut_per_cluster(qc, cb_mode, pr, pq_dim).reshape(
                qc.shape[0], -1)
            base = probe_of * (pq_dim * book)
            for s in range(pq_dim):
                acc = acc + torch.gather(
                    lut, 1, base + s * book + cg[:, :, s].long())
        else:
            lut = pq_lut(qc, cb_mode)
            for s in range(pq_dim):
                acc = acc + torch.gather(lut[:, s, :], 1,
                                         cg[:, :, s].long())
        if metric == "l2":
            dist = torch.clamp_min(qn[s0 : s0 + chunk, None] + row_norms[rows]
                                   - 2.0 * qcl + (-2.0) * acc, 0.0)
        else:
            dist = -qcl + (-1.0) * acc
        if penalty is not None:
            dist = dist + penalty[rows]
        dist = torch.where(valid, dist, _INF)
        v, loc = smallest_k_plain(dist, kk)
        r = torch.gather(rows, 1, loc.long()).to(torch.int32)
        out_v[s0 : s0 + chunk, :kk] = v
        out_i[s0 : s0 + chunk, :kk] = torch.where(torch.isfinite(v), r, -1)
    return out_v, out_i


def ivf_pq_scan_candidates(codes: torch.Tensor, dn: torch.Tensor,
                           penalty: Optional[torch.Tensor],
                           cb_mode: torch.Tensor, centers_rot: torch.Tensor,
                           q: torch.Tensor, probed: torch.Tensor,
                           offsets: torch.Tensor, sizes: torch.Tensor,
                           k: int, metric: str, form: Optional[str] = None,
                           per_cluster: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of K4 → per-pair (values, rows) (m, p*k), pairs in
    probe-rank order within each query's row. ``form`` (``"group"`` or
    ``"pair"``) overrides ``ivf_scan.scan_form``; ``per_cluster``:
    ``cb_mode`` is (n_lists, book, pq_len), which the grouped form alone
    takes."""
    global launches, group_launches, pair_launches, wide_launches
    global per_cluster_launches
    expects(q.is_cuda, "ivf_pq_scan kernel needs CUDA tensors")
    m, rot_dim = q.shape
    p = probed.shape[1]
    expects(cb_mode.dim() == 3, "codebook must be (pq_dim | n_lists, book, "
            "pq_len)")
    _, book, pq_len = cb_mode.shape
    pq_dim = codes.shape[1] if codes.dim() == 2 else -1
    expects(not per_cluster or cb_mode.shape[0] == offsets.shape[0],
            "per-cluster codebooks must be (n_lists=%d, book, pq_len), got "
            "%s", offsets.shape[0], tuple(cb_mode.shape))
    expects(per_cluster or cb_mode.shape[0] == pq_dim,
            "per-subspace codebooks must be (pq_dim=%d, book, pq_len), got "
            "%s", pq_dim, tuple(cb_mode.shape))
    expects(pq_dim * pq_len == rot_dim and centers_rot.dim() == 2
            and centers_rot.shape[1] == rot_dim,
            "rot_dim %d != pq_dim %d x pq_len %d or centers %s", rot_dim,
            pq_dim, pq_len, tuple(centers_rot.shape))
    expects(codes.dim() == 2 and codes.shape[1] == pq_dim
            and codes.dtype == torch.uint8 and codes.is_contiguous()
            and codes.device == q.device,
            "codes must be contiguous uint8 (rows, %d) on %s", pq_dim,
            q.device)
    expects(1 <= book <= 256, "book size %d out of range (max 256)", book)
    expects(probed.shape[0] == m, "probed must be (%d, p)", m)
    expects(metric in _METRIC_CODE, "unknown metric %s", metric)
    form = check_form(form, k)
    expects(form == "group" or not per_cluster,
            "the per-pair ivf_pq_scan form takes per-subspace codebooks "
            "only")
    if form == "pair":
        smem = _scan_smem_bytes(pq_dim, book, rot_dim, k)
        expects(smem <= _cuda.SMEM_PER_BLOCK,
                "ivf_pq_scan kernel needs %d bytes of shared memory for a "
                "pq_dim=%d x book=%d LUT and k=%d (max %d)", smem, pq_dim,
                book, k, _cuda.SMEM_PER_BLOCK)
    for t in (dn, penalty, cb_mode, centers_rot, q):
        if t is not None:
            expects(t.dtype == torch.float32 and t.is_contiguous()
                    and t.device == q.device,
                    "ivf_pq_scan kernel takes contiguous float32 tensors "
                    "on %s", q.device)
    for t in (probed, offsets, sizes):
        expects(t.dtype == torch.int32 and t.is_contiguous()
                and t.device == q.device,
                "probed/offsets/sizes must be contiguous int32 on %s",
                q.device)
    expects(metric == "ip" or dn is not None, "l2 needs the row norms")
    out_v = torch.empty((m, p * k), dtype=torch.float32, device=q.device)
    out_i = torch.empty((m, p * k), dtype=torch.int32, device=q.device)
    if m * p == 0:
        return out_v, out_i
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    lib = _cuda.library("ivf_pq_scan")
    if form == "group":
        qg = group_queries(k)
        glist, gstart, gcount, order = pack_pairs(probed, offsets.shape[0],
                                                  qg)
        # on the card, without a host sync: is every codebook value exact
        # in TF32 (the bf16 LUT mode)? Then K4 skips the products of the
        # decoded rows' lo parts, which are zero
        exact = ((cb_mode.view(torch.int32) & _TF32_LOW) == 0).all().to(
            torch.int32)
        # past k = 256: the blocks' distance rows, as long as the longest
        # list, from PyTorch's caching allocator (stream-ordered)
        lmax, scratch = 0, None
        if k > WIDE_K:
            lmax = largest_list(sizes)
            nbytes = wide_scratch_on_card("ivf_pq_scan", k, rot_dim, lmax)[0]
            scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device)
        entry = (lib.raft_ivf_pq_scan_group_per_cluster if per_cluster
                 else lib.raft_ivf_pq_scan_group)
        status = entry(
            codes.data_ptr(), ptr(dn), ptr(penalty), cb_mode.data_ptr(),
            centers_rot.data_ptr(), q.data_ptr(), exact.data_ptr(),
            order.data_ptr(), glist.data_ptr(), gstart.data_ptr(),
            gcount.data_ptr(), offsets.data_ptr(), sizes.data_ptr(),
            ptr(scratch), glist.shape[0], qg, p, pq_dim, pq_len, book, k,
            _METRIC_CODE[metric], lmax, out_v.data_ptr(), out_i.data_ptr(),
            _cuda.stream_of(q))
    else:
        # the pairs in list order, so that blocks that run together read
        # the same list
        order = torch.argsort(probed.reshape(-1), stable=True).to(
            torch.int32)
        status = lib.raft_ivf_pq_scan_pair(
            codes.data_ptr(), ptr(dn), ptr(penalty), cb_mode.data_ptr(),
            centers_rot.data_ptr(), q.data_ptr(), probed.data_ptr(),
            order.data_ptr(), offsets.data_ptr(), sizes.data_ptr(), m, p,
            pq_dim, pq_len, book, k, _METRIC_CODE[metric], out_v.data_ptr(),
            out_i.data_ptr(), _cuda.stream_of(q))
    _cuda.check(status, f"ivf_pq_scan ({form})")
    with _count_lock:
        launches += 1
        if form == "group":
            group_launches += 1
            wide_launches += k > GROUP_MAX_K
            per_cluster_launches += per_cluster
        else:
            pair_launches += 1
    return out_v, out_i


def ivf_pq_scan(codes: torch.Tensor, row_norms: torch.Tensor,
                centers_rot: torch.Tensor, cb_mode: torch.Tensor,
                probed: torch.Tensor, offsets: torch.Tensor,
                sizes: torch.Tensor, q_rot: torch.Tensor, k: int,
                metric: str = "l2",
                penalty: Optional[torch.Tensor] = None,
                form: Optional[str] = None, per_cluster: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan the probed PQ lists → per-query k best (min-space values,
    int32 rows of ``codes``, -1 where fewer than k candidates).
    ``codes`` is the cluster-sorted (rows, pq_dim) uint8 store,
    ``row_norms`` its decoded squared norms, ``cb_mode`` the
    (pq_dim, book, pq_len) codebook of the LUT mode (:func:`lut_codebook`),
    (n_lists, book, pq_len) with ``per_cluster``,
    ``offsets``/``sizes`` (n_lists,) each list's first row and length,
    ``q_rot`` the rotated queries, ``penalty`` an optional (rows,)
    additive row penalty. ``form`` overrides ``ivf_scan.scan_form`` on
    the card (one plain version serves both forms on the CPU)."""
    if codes.device.type == "cpu":
        expects(form in (None, "group", "pair"), "unknown form %r", form)
        return ivf_pq_scan_plain(codes, row_norms, centers_rot, cb_mode,
                                 probed, offsets, sizes, q_rot, k, metric,
                                 penalty, per_cluster)
    dev = codes.device
    f32 = lambda t: t.to(device=dev, dtype=torch.float32).contiguous()  # noqa: E731
    probed, offsets, sizes = (t.to(device=dev, dtype=torch.int32)
                              .contiguous() for t in (probed, offsets, sizes))
    cand_v, cand_i = ivf_pq_scan_candidates(
        codes, f32(row_norms) if metric == "l2" else None,
        None if penalty is None else f32(penalty), f32(cb_mode),
        f32(centers_rot), f32(q_rot), probed, offsets, sizes, k, metric,
        form, per_cluster)
    vals, pos = kpass_select_k(cand_v, k)
    rows = torch.gather(cand_i, 1, pos.long())
    return vals, torch.where(torch.isfinite(vals), rows, -1)
