"""Exact brute-force kNN: counterpart of
``raft_tpu/neighbors/brute_force.py`` (``Index``, ``build``, ``search``,
``knn``, ``knn_merge_parts``).

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
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..ops.fused_knn import fused_knn, fused_knn_plain
from ..ops.quant import (dequantize_store, int8_scale_report, quantize_rows,
                         store_dtype)
from ..utils import resolve_device, run_query_chunks

__all__ = ["Index", "build", "search", "knn", "knn_merge_parts", "health",
           "health_sample_rows"]

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
           algo: str = "auto", query_chunk: int = 0
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbors of each query → (distances (m, k), int32
    indices (m, k)), on the index's device.

    ``filter``: optional sample bitset; cleared bits are excluded.
    ``algo``: "auto" or "pallas" — K2 + the K1 merge on CUDA, their
    plain versions on the CPU; "matmul" — the plain engine (GEMM + norms
    + stable sort) on any device. ``query_chunk``: run queries in chunks
    of this many rows. On CUDA the kernel takes k <= 256
    (``fused_knn.MAX_K``: its per-query lists live in shared memory)."""
    q = torch.as_tensor(queries).to(device=index.device,
                                    dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be (m, %d), got %s", index.dim, tuple(q.shape))
    expects(0 < k <= index.size, "k=%d out of range for index of size %d",
            k, index.size)
    if 0 < query_chunk < q.shape[0]:
        return run_query_chunks(
            lambda qc, _s0: search(index, qc, k, filter, algo), q,
            query_chunk)
    expects(algo in ("auto", "pallas", "matmul"),
            "unknown brute-force algo %r", algo)
    engine = fused_knn_plain if algo == "matmul" else fused_knn
    mt = index.metric
    vals, idxs = engine(q, index.dataset, k, _KERNEL_METRICS[mt],
                        index.norms, _penalty_row(index, filter),
                        index.scales, index.logical_dim)
    return _postprocess(mt, vals), idxs


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
