"""Exact brute-force kNN: counterpart of
``raft_tpu/neighbors/brute_force.py`` (``Index``, ``build``, ``search``,
``knn``, ``knn_merge_parts``, ``health``, ``quantization_error``,
``make_searcher``, ``save``, ``load``).

Engines (``algo``):

* ``"auto"`` / ``"pallas"`` — :func:`raft_tpu_torch.ops.fused_knn.fused_knn`:
  kernel K2 (+ the K1 merge) on CUDA, its plain version on the CPU.
* ``"matmul"`` — the plain engine
  (:func:`raft_tpu_torch.ops.fused_knn.fused_knn_plain`): the explicit
  choice of ``torch.matmul`` + norms + stable sort on any device.

The corpus is stored in any rung of ``ops/quant`` (``build(dtype=...)``):
float32, bfloat16, int8 with per-row scales, uint8 (byte-valued corpora)
or int4 split-half nibbles; both engines compute the JAX package's
contract for each store (``ops/fused_knn``). Expanded metrics only
(squared L2, L2, cosine, inner product); the JAX package's composed
``scan`` engine for the other metrics is not ported yet. Every matrix
product runs in full float32 (``torch.backends.cuda.matmul.allow_tf32``
False), as the JAX package's ``precision="highest"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.bitset import Bitset
from ..core.errors import expects
from ..core.serialize import device_tensor, load_arrays, save_arrays
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..ops.fused_knn import fused_knn, fused_knn_plain
from ..ops.quant import (dequantize_store, int8_scale_report, quantize_rows,
                         store_dtype)
from ..utils import query_chunks, resolve_device, run_query_chunks

__all__ = ["Index", "build", "search", "knn", "knn_merge_parts", "health",
           "health_sample_rows", "quantization_error", "make_searcher",
           "save", "load"]

# a search under a deadline with no query_chunk runs this many queries a
# chunk (the JAX package's)
DEADLINE_CHUNK = 4096

# the file version save writes (the JAX package's); load reads 1 and 2
_SERIAL_VERSION = 2

# metric → the kernels' metric code (shared with ivf_flat)
_KERNEL_METRICS = {
    DistanceType.L2Expanded: "l2",
    DistanceType.L2SqrtExpanded: "l2",
    DistanceType.CosineExpanded: "cos",
    DistanceType.InnerProduct: "ip",
}


@dataclasses.dataclass
class Index:
    """Brute-force index: the stored dataset plus the squared norms of its
    dequantized rows (for the L2 and cosine metrics). ``scales``: the
    per-row factors of an int8 or int4 store; ``logical_dim``: the row
    width of an int4 store (its bytes are (n, half_p))."""

    dataset: torch.Tensor           # (n, d) f32 | bf16 | int8 | uint8
    norms: Optional[torch.Tensor]   # (n,) squared L2 norms
    metric: DistanceType
    scales: Optional[torch.Tensor] = None   # (n,) f32, int8/int4 only
    logical_dim: Optional[int] = None       # int4 only

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return (self.logical_dim if self.logical_dim is not None
                else self.dataset.shape[1])

    @property
    def store_name(self) -> str:
        """The store: "float32", "bfloat16", "int8", "uint8" or "int4"
        (whose bytes are int8)."""
        return ("int4" if self.logical_dim is not None
                else store_dtype(self.dataset.dtype))

    @property
    def device(self) -> torch.device:
        return self.dataset.device


def build(dataset, metric="sqeuclidean", dtype="float32",
          device=None) -> Index:
    """Store the dataset on ``device`` (the CUDA card by default) in the
    store ``dtype`` (float32, bfloat16, int8, uint8 or int4, as
    ``ops.quant.quantize_rows``) and precompute the norms of the
    dequantized rows."""
    dev = resolve_device(device)
    dataset = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    expects(dataset.dim() == 2, "dataset must be (n, d)")
    mt = canonical_metric(metric)
    expects(mt in _KERNEL_METRICS,
            "brute force supports L2/cosine/IP metrics, got %s", mt.name)
    int4 = store_dtype(dtype) == "int4"
    stored, scales = quantize_rows(dataset.contiguous(), dtype)
    logical_dim = dataset.shape[1] if int4 else None
    norms = None
    if mt is not DistanceType.InnerProduct:
        deq = dequantize_store(stored, scales, logical_dim)
        norms = (deq * deq).sum(dim=1)
    return Index(stored.contiguous(), norms, mt, scales, logical_dim)


def health_sample_rows(n: int, sample: int) -> np.ndarray:
    """An evenly spread, deterministic sample of ``sample`` of ``n`` rows
    for the health reports (empty for an empty index)."""
    if n <= 0:
        return np.zeros((0,), np.int64)
    take = max(1, min(int(sample), int(n)))
    return np.unique(np.linspace(0, n - 1, take).astype(np.int64))


def quantization_error(original, dequantized) -> dict:
    """The measured error of a quantized copy against its float32
    original on sampled rows, as the JAX package reports it: the relative
    RMS error and the largest absolute error of a component, each rounded
    to 6 decimals. Either argument may be a tensor or an array."""
    o, dq = (torch.as_tensor(a).detach().to("cpu", torch.float32).numpy()
             for a in (original, dequantized))
    err = o - dq
    denom = max(float(np.sqrt((o * o).mean())), 1e-30)
    return {"rel_rmse": round(float(np.sqrt((err * err).mean())) / denom, 6),
            "max_abs_err": round(float(np.abs(err).max()), 6)}


def health(index: Index, sample: int = 256) -> dict:
    """Index health report: geometry, the store and, for int8 / int4
    stores, the sampled per-row scale stats
    (``ops.quant.int8_scale_report``), as the JAX package reports them."""
    report = {"family": "brute_force", "n": int(index.size),
              "dim": int(index.dim), "metric": index.metric.name,
              "store_dtype": index.store_name}
    store = index.store_name
    if store in ("int8", "int4") and index.scales is not None:
        rows = health_sample_rows(index.size, sample)
        if rows.size:
            rep = int8_scale_report(index.scales[torch.as_tensor(
                rows, device=index.device)])
            report["quant"] = {store: rep["int8"]}
    elif store == "bfloat16":
        report["quant"] = {"bfloat16": {"rel_step": 2.0 ** -8}}
    elif store == "uint8":
        report["quant"] = {"uint8": {"exact": True}}
    return report


def _penalty_row(index: Index, filter):
    """(n,) additive min-space penalty: +inf on filtered-out rows, else 0
    (``None`` without a filter)."""
    if filter is None:
        return None
    keep = filter.to(index.device).to_mask()
    return torch.where(keep, 0.0, float("inf")).to(torch.float32)


def _postprocess(mt: DistanceType, vals: torch.Tensor) -> torch.Tensor:
    """Min-space kernel values → the metric's distances (sqrt for L2,
    the raw inner product, -inf on empty slots, for IP)."""
    if mt is DistanceType.L2SqrtExpanded:
        return torch.sqrt(torch.clamp_min(vals, 0.0))
    if mt is DistanceType.InnerProduct:
        return torch.where(torch.isfinite(vals), -vals, -float("inf"))
    return vals


def search(index: Index, queries, k: int,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           algo: str = "auto", query_chunk: int = 0, res=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbors of each query → (distances (m, k), int32
    indices (m, k)), on the index's device.

    ``filter``: optional sample bitset; cleared bits are excluded.
    ``algo``: "auto" or "pallas" — K2 + the K1 merge on CUDA, their
    plain versions on the CPU; "matmul" — the plain engine (GEMM + norms
    + stable sort) on any device. ``query_chunk``: run queries in chunks
    of this many rows. ``res``: a ``core.deadline.Deadline`` (or an
    object carrying one as ``deadline``): the queries run in chunks
    (``query_chunk``, else :data:`DEADLINE_CHUNK`) with a checkpoint
    before each, which raises ``DeadlineExceeded`` with the finished
    chunks' results once the budget is spent. A chunked search equals
    the unchunked one. On CUDA the kernel takes every k <= the index's
    size (past ``fused_knn.LIST_MAX_K`` its wide form)."""
    q = torch.as_tensor(queries).to(device=index.device,
                                    dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be (m, %d), got %s", index.dim, tuple(q.shape))
    expects(0 < k <= index.size, "k=%d out of range for index of size %d",
            k, index.size)
    chunk = query_chunks(q.shape[0], query_chunk, res, DEADLINE_CHUNK)
    if chunk:
        return run_query_chunks(
            lambda qc, _s0: search(index, qc, k, filter, algo), q, chunk,
            res)
    expects(algo in ("auto", "pallas", "matmul"),
            "unknown brute-force algo %r", algo)
    engine = fused_knn_plain if algo == "matmul" else fused_knn
    mt = index.metric
    vals, idxs = engine(q, index.dataset, k, _KERNEL_METRICS[mt],
                        index.norms, _penalty_row(index, filter),
                        index.scales, index.logical_dim)
    return _postprocess(mt, vals), idxs


def make_searcher(index: Index, params=None, **opts):
    """``fn(queries, k, res=None) -> (distances, indices)`` with the
    search options ``opts`` (``algo``, ``filter``, ``query_chunk``)
    frozen: the serving signature the four families share. Brute force
    has no search parameters, so ``params`` must be None."""
    expects(params is None, "brute_force has no SearchParams; pass engine "
            "options as keywords")

    def _fn(queries, k, res=None):
        return search(index, queries, k, res=res, **opts)

    return _fn


def knn(dataset, queries, k, metric="sqeuclidean", device=None):
    """One-shot build + search (the reference's free function)."""
    return search(build(dataset, metric, device=device), queries, k)


def knn_merge_parts(part_distances: torch.Tensor, part_indices: torch.Tensor,
                    select_min: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k results: (p, m, k) → (m, k); ties go to the
    lower shard."""
    p, m, k = part_distances.shape
    d = part_distances.permute(1, 0, 2).reshape(m, p * k)
    i = part_indices.permute(1, 0, 2).reshape(m, p * k)
    return select_k(d.contiguous(), k, select_min=select_min, indices=i)


def save(index: Index, path) -> None:
    """Write the index in the JAX package's file format (kind
    "brute_force", version 2): meta ``metric``, ``metric_arg`` (2.0, the
    only one the port has), ``store_dtype`` and, for int4,
    ``logical_dim``; arrays ``dataset`` (bfloat16 as its uint16 words),
    ``norms`` and ``scales`` where the index has them. Byte-equal to the
    JAX package's file of the same index."""
    meta = {"metric": index.metric.value, "metric_arg": 2.0,
            "store_dtype": index.store_name}
    if index.logical_dim is not None:
        meta["logical_dim"] = int(index.logical_dim)
    arrays = {"dataset": index.dataset}
    if index.norms is not None:
        arrays["norms"] = index.norms
    if index.scales is not None:
        arrays["scales"] = index.scales
    save_arrays(path, "brute_force", _SERIAL_VERSION, meta, arrays)


def load(path, device=None) -> Index:
    """Read a brute-force file of either package onto ``device`` (the CUDA
    card by default). A metric other than the expanded four, or a
    ``metric_arg`` other than 2.0, raises: the JAX package's scan engine
    for them is not ported yet."""
    _, version, meta, arrays = load_arrays(path, "brute_force")
    expects(version in (1, 2), "unsupported serialization version %d",
            version)
    mt = DistanceType(meta["metric"])
    expects(mt in _KERNEL_METRICS, "brute force with metric %s is not "
            "ported yet (the scan engine)", mt.name)
    expects(float(meta["metric_arg"]) == 2.0, "metric_arg %r is not ported "
            "yet (the scan engine)", meta["metric_arg"])
    dev = resolve_device(device)
    dataset = device_tensor(arrays["dataset"], dev,
                            meta.get("store_dtype") == "bfloat16")
    norms, scales = (device_tensor(arrays[a], dev) if a in arrays else None
                     for a in ("norms", "scales"))
    return Index(dataset, norms, mt, scales, meta.get("logical_dim"))
