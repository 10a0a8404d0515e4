"""Per-row storage coding: counterpart of ``raft_tpu/ops/quant.py``
(``quantize_rows`` / ``dequantize_rows``, the int4 codec, the health
report's scale summary) for the float32, bfloat16, int8, uint8 and int4
rungs. The codes and scales are the JAX package's bit for bit:

* int8 is symmetric per row: ``scale = max(absmax, 1e-30) / 127`` and
  ``clip(round(x / scale), -127, 127)``, with ``torch.round`` rounding
  half to even as ``jnp.round`` does;
* uint8 stores byte-valued rows exactly (``clip(round(x), 0, 255)``, no
  scales) and refuses data that is not integral in [0, 255];
* int4 packs value ``j`` of a row in the low nibble of byte ``j`` and
  value ``j + half_p`` in its high nibble (split-half layout, ``half_p =``
  :func:`int4_half_width`), with ``scale = max(absmax, 1e-30) / 7`` and
  codes in [-7, 7]; the bytes are packed in int32 and reinterpreted, as
  JAX's ``astype(uint8).astype(int8)``, and unpacked by arithmetic
  shifts (:func:`int4_nibbles`).

The PQ row codecs of CAGRA's pq edge store code whole rows, zero-padded
to ``dim_p = round_up(dim, 128)``, against ``pq_dim`` per-subspace
codebooks of ``pq_len = dim_p / pq_dim`` dims (:func:`train_pq_rows`,
:func:`encode_pq_rows`, :func:`pq_decoded_norms`). JAX's kernels read
the codebooks as the block-diagonal decode table (:func:`pq_decode_table`,
int8 by :func:`pq_int8_cb`); K5 reads the same numbers in the compact
form (:func:`pq_compact_cb`: ``(pq_dim, book, pq_len)`` int8 with
``(pq_dim,)`` scales, or float32), which fits a block's shared memory;
:func:`pq_int8_books` quantizes the codebooks straight into it.
The codebooks' random init draws from a ``torch.Generator``, so it is
not JAX's threefry draw; everything after it is JAX's arithmetic.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import expects
from ..utils import cdiv, round_up_to

__all__ = ["STORES", "store_dtype", "quantize_rows", "dequantize_rows",
           "int8_scale_report", "int4_half_width", "quantize_int4",
           "int4_nibbles", "dequantize_int4", "dequantize_store",
           "default_pq_dim", "train_pq_rows", "encode_pq_rows",
           "pq_decoded_norms", "pq_decode_table", "pq_int8_cb",
           "pq_compact_cb", "pq_int8_books"]

# store name -> the stored tensor's dtype (int4 bytes are int8)
STORES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int8": torch.int8, "uint8": torch.uint8, "int4": torch.int8}


def store_dtype(dtype) -> str:
    """The store name of ``dtype``: a name of :data:`STORES` (``"i4"``
    too) or a torch dtype."""
    if dtype == "i4":
        return "int4"
    if isinstance(dtype, str):
        expects(dtype in STORES, "store dtype must be float32/bfloat16/"
                "int8/uint8/int4, got %s", dtype)
        return dtype
    names = {v: k for k, v in STORES.items() if k != "int4"}
    expects(dtype in names, "store dtype must be float32/bfloat16/int8/"
            "uint8/int4, got %s", dtype)
    return names[dtype]


def quantize_rows(dataset: torch.Tensor, dtype=torch.float32
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """f32 rows → (stored rows, per-row scales | None). ``dtype``: a
    torch dtype or a store name (float32, bfloat16, int8, uint8, int4);
    int8 and int4 carry scales, int4 rows are ``(n, half_p)`` packed
    bytes (:func:`quantize_int4`)."""
    store = store_dtype(dtype)
    dataset = dataset.to(torch.float32)
    if store == "int4":
        return quantize_int4(dataset)
    if store in ("float32", "bfloat16"):
        return dataset.to(STORES[store]), None
    if store == "uint8":
        q = torch.clamp(torch.round(dataset), 0, 255)
        # clamping float data silently would collapse recall; scaled
        # float data belongs in int8
        expects(bool(((dataset - q).abs() < 1e-3).all()),
                "uint8 storage expects byte-valued data (integral in "
                "[0, 255]); use dtype='int8' for scaled float data")
        return q.to(torch.uint8), None
    amax = dataset.abs().amax(dim=1)
    scale = torch.clamp_min(amax, 1e-30) / 127.0
    q = torch.clamp(torch.round(dataset / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(rows: torch.Tensor,
                    scales: Optional[torch.Tensor]) -> torch.Tensor:
    """Stored rows (not int4-packed) → f32, applying per-row scales when
    present."""
    out = rows.to(torch.float32)
    if scales is not None:
        out = out * scales[..., None]
    return out


def int8_scale_report(scales) -> dict:
    """Sampled per-row scale stats for a health report: the quantization
    step bound ``max_scale / 2`` per component (the f32 originals are not
    kept), as the JAX package reports it."""
    sc = np.asarray(torch.as_tensor(scales).cpu(), np.float64)
    return {"int8": {
        "mean_scale": round(float(sc.mean()), 6),
        "max_scale": round(float(sc.max()), 6),
        "max_abs_err_bound": round(float(sc.max()) / 2.0, 6)}}


def int4_half_width(dim: int) -> int:
    """Packed byte width of a ``dim``-wide int4 row: ``ceil(dim / 2)``
    rounded up to a multiple of 64, so the query split into its (low,
    high) halves is ``2·half_p`` wide, a multiple of 128."""
    return round_up_to(cdiv(dim, 2), 64)


def quantize_int4(dataset: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 rows → (packed (n, half_p) int8, per-row scales (n,) f32), the
    split-half layout of the module docstring (missing tail components
    are zero)."""
    dataset = dataset.to(torch.float32)
    n, dim = dataset.shape
    half = int4_half_width(dim)
    amax = dataset.abs().amax(dim=1)
    scale = torch.clamp_min(amax, 1e-30) / 7.0
    q = torch.clamp(torch.round(dataset / scale[:, None]), -7, 7)
    q = torch.nn.functional.pad(q, (0, 2 * half - dim)).to(torch.int32)
    packed = (q[:, :half] & 0xF) | ((q[:, half:] & 0xF) << 4)
    return packed.to(torch.uint8).view(torch.int8), scale


def int4_nibbles(packed: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed int4 bytes → (low, high) f32 nibble planes, sign-extended:
    ``(w << 28) >> 28`` and ``(w << 24) >> 28`` on the bytes widened to
    int32 (arithmetic shifts)."""
    w = packed.to(torch.int32)
    low = ((w << 28) >> 28).to(torch.float32)
    high = ((w << 24) >> 28).to(torch.float32)
    return low, high


def dequantize_int4(packed: torch.Tensor, scales: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Packed (n, half_p) int4 rows → (n, dim) f32."""
    low, high = int4_nibbles(packed)
    full = torch.cat([low, high], dim=-1)[..., :dim]
    return full * scales[..., None]


def dequantize_store(rows: torch.Tensor, scales: Optional[torch.Tensor],
                     logical_dim: Optional[int] = None) -> torch.Tensor:
    """Any store's rows → f32: int4-packed rows when ``logical_dim`` is
    given, else :func:`dequantize_rows`."""
    if logical_dim is not None:
        return dequantize_int4(rows, scales, logical_dim)
    return dequantize_rows(rows, scales)


def default_pq_dim(dim: int) -> int:
    """The pq edge store's subspace count: about 8 dims a subspace of the
    padded dim, at least 4 and at most 64 (16 at d = 128)."""
    dim_p = round_up_to(dim, 128)
    return max(4, min(64, dim_p // 8))


def train_pq_rows(dataset, pq_dim: int, book: int = 256, iters: int = 20,
                  seed: int = 0, train_rows: int = 65536) -> torch.Tensor:
    """Per-subspace codebooks (pq_dim, book, pq_len) trained on whole rows
    zero-padded to dim_p: every ``n // train_rows``-th row when there are
    more than ``train_rows``, then ``iters`` fixed Lloyd steps a subspace
    (``neighbors.ivf_pq._kmeans_fixed``, its init drawn from a generator
    seeded with ``seed``). ``book`` is cut to the rows there are."""
    from ..neighbors.ivf_pq import _kmeans_fixed

    x = torch.as_tensor(dataset).to(torch.float32)
    n, dim = x.shape
    dim_p = round_up_to(dim, 128)
    expects(pq_dim > 0 and dim_p % pq_dim == 0,
            "pq_dim %d must divide the padded dim %d", pq_dim, dim_p)
    pq_len = dim_p // pq_dim
    if n > train_rows:
        x = x[::max(1, n // train_rows)]
    x = torch.nn.functional.pad(x, (0, dim_p - dim))
    slices = x.reshape(x.shape[0], pq_dim, pq_len).transpose(0, 1)
    gen = torch.Generator(device=x.device).manual_seed(seed)
    return _kmeans_fixed(slices.contiguous(), min(book, x.shape[0]), iters,
                         gen)


def encode_pq_rows(dataset, codebooks: torch.Tensor,
                   chunk: int = 1 << 16) -> torch.Tensor:
    """Rows → (n, pq_dim) uint8 codes: per subspace the argmin of
    ``||s||² - 2 s·cb + ||cb||²`` (ties to the lower code), in row chunks
    of at most ``ops.ivf_pq_scan.pq_chunk_rows``."""
    from .ivf_pq_scan import pq_chunk_rows

    x = torch.as_tensor(dataset).to(torch.float32)
    n, dim = x.shape
    pq_dim, book, pq_len = codebooks.shape
    dim_p = pq_dim * pq_len
    cb = codebooks.to(device=x.device, dtype=torch.float32)
    cn = (cb * cb).sum(dim=2)[None, :, :]
    chunk = min(chunk, pq_chunk_rows(pq_dim, book))
    out = torch.empty((n, pq_dim), dtype=torch.uint8, device=x.device)
    for r0 in range(0, n, chunk):
        xb = torch.nn.functional.pad(x[r0:r0 + chunk], (0, dim_p - dim))
        s = xb.reshape(xb.shape[0], pq_dim, pq_len)
        d2 = ((s * s).sum(dim=2)[:, :, None]
              - 2.0 * torch.einsum("nsl,sbl->nsb", s, cb) + cn)
        out[r0:r0 + chunk] = d2.argmin(dim=2).to(torch.uint8)
    return out


def _ordered_sum(terms) -> torch.Tensor:
    """The sum of a list of equal-shaped tensors in XLA's CPU order for a
    reduction: in order within each run of 32 terms, then the runs' sums
    in order."""
    runs = []
    for r0 in range(0, len(terms), 32):
        acc = terms[r0].clone()
        for t in terms[r0 + 1:r0 + 32]:
            acc += t
        runs.append(acc)
    out = runs[0]
    for r in runs[1:]:
        out = out + r
    return out


def pq_decoded_norms(codes: torch.Tensor, codebooks: torch.Tensor
                     ) -> torch.Tensor:
    """(n,) ``||decode(codes)||²``: the sum over subspaces of the chosen
    codewords' squared norms (subspaces are disjoint blocks of dims). Both
    sums run in XLA's CPU order (:func:`_ordered_sum`), so the norms are
    the JAX package's bit for bit."""
    pq_dim, _, pq_len = codebooks.shape
    sq = codebooks.to(torch.float32).square()
    cb2 = _ordered_sum([sq[:, :, j] for j in range(pq_len)])    # (s, b)
    c = codes.long()
    return _ordered_sum([cb2[s][c[:, s]] for s in range(pq_dim)])


def pq_decode_table(codebooks: torch.Tensor) -> torch.Tensor:
    """(pq_dim, book, pq_len) codebooks → the subspace-major decode table
    (pq_dim·book, dim_p): row ``s·book + b`` is codeword b of subspace s
    at dims ``[s·pq_len, (s+1)·pq_len)``, zeros elsewhere (JAX's
    layout)."""
    pq_dim, book, pq_len = codebooks.shape
    tbl = torch.zeros((pq_dim, book, pq_dim, pq_len), dtype=torch.float32,
                      device=codebooks.device)
    sub = torch.arange(pq_dim, device=codebooks.device)
    tbl[sub, :, sub] = codebooks.to(torch.float32)
    return tbl.reshape(pq_dim * book, pq_dim * pq_len)


def pq_int8_cb(table: torch.Tensor, pq_dim: int, book: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Decode table → (int8 table, (1, dim_p) float32 rescale row): each
    subspace quantized symmetrically, ``scale = max(absmax, 1e-12) /
    127`` and ``clip(round(t / scale), -127, 127)``; column d's rescale is
    its subspace's scale."""
    dim_p = table.shape[1]
    absmax = table.abs().reshape(pq_dim, book * dim_p).amax(dim=1)
    scales = torch.clamp_min(absmax, 1e-12) / 127.0
    t8 = torch.clamp(torch.round(table.reshape(pq_dim, book, dim_p)
                                 / scales[:, None, None]), -127, 127)
    return (t8.to(torch.int8).reshape(pq_dim * book, dim_p),
            scales.repeat_interleave(dim_p // pq_dim)[None, :])


def pq_compact_cb(table: torch.Tensor, scale_row: Optional[torch.Tensor],
                  pq_dim: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A decode table (float32, or int8 with its (1, dim_p) rescale row)
    → its non-zero blocks: (pq_dim, book, pq_len) in the table's dtype,
    and for int8 the (pq_dim,) subspace scales (None for float32). The
    same numbers, 1/pq_dim of the bytes."""
    rows, dim_p = table.shape
    book, pq_len = rows // pq_dim, dim_p // pq_dim
    sub = torch.arange(pq_dim, device=table.device)
    cb = table.reshape(pq_dim, book, pq_dim, pq_len)[sub, :, sub]
    if table.dtype != torch.int8:
        return cb.to(torch.float32).contiguous(), None
    return (cb.contiguous(),
            scale_row.reshape(pq_dim, pq_len)[:, 0].to(torch.float32)
            .contiguous())


def pq_int8_books(codebooks: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pq_dim, book, pq_len) codebooks → the compact int8 form with its
    (pq_dim,) scales: :func:`pq_int8_cb` of the decode table cut to its
    non-zero blocks (:func:`pq_compact_cb`), the same bits without the
    pq_dim-times larger table (a subspace's absmax is its codebook's, the
    table's other entries being zeros)."""
    books = codebooks.to(torch.float32)
    absmax = books.abs().reshape(books.shape[0], -1).amax(dim=1)
    scales = torch.clamp_min(absmax, 1e-12) / 127.0
    t8 = torch.clamp(torch.round(books / scales[:, None, None]), -127, 127)
    return t8.to(torch.int8).contiguous(), scales.contiguous()
