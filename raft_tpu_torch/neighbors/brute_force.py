"""Exact brute-force kNN: counterpart of
``raft_tpu/neighbors/brute_force.py`` (``Index``, ``build``, ``search``,
``knn``, ``knn_merge_parts``).

Engines (``algo``):

* ``"auto"`` / ``"pallas"`` — :func:`raft_tpu_torch.ops.fused_knn.fused_knn`:
  kernel K2 (+ the K1 merge) on CUDA, its plain version on the CPU.
* ``"matmul"`` — the plain engine
  (:func:`raft_tpu_torch.ops.fused_knn.fused_knn_plain`): the explicit
  choice of ``torch.matmul`` + norms + stable sort on any device.

Expanded metrics only (squared L2, L2, cosine, inner product); the JAX
package's composed ``scan`` engine for the other metrics, and its
bf16/int8/int4 stores, are not ported yet. Every matrix product runs in
full float32 (``torch.backends.cuda.matmul.allow_tf32`` False), as the
JAX package's ``precision="highest"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from ..core.bitset import Bitset
from ..core.errors import expects
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import select_k
from ..ops.fused_knn import fused_knn, fused_knn_plain
from ..ops.quant import quantize_rows
from ..utils import resolve_device, run_query_chunks

__all__ = ["Index", "build", "search", "knn", "knn_merge_parts"]

# metric → the kernels' metric code (shared with ivf_flat)
_KERNEL_METRICS = {
    DistanceType.L2Expanded: "l2",
    DistanceType.L2SqrtExpanded: "l2",
    DistanceType.CosineExpanded: "cos",
    DistanceType.InnerProduct: "ip",
}


@dataclasses.dataclass
class Index:
    """Brute-force index: the dataset plus its squared row norms (for the
    L2 and cosine metrics)."""

    dataset: torch.Tensor           # (n, d) float32
    norms: Optional[torch.Tensor]   # (n,) squared L2 norms
    metric: DistanceType

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def device(self) -> torch.device:
        return self.dataset.device


def build(dataset, metric="sqeuclidean", device=None) -> Index:
    """Store the dataset on ``device`` (the CUDA card by default) and
    precompute its norms."""
    dev = resolve_device(device)
    dataset = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    expects(dataset.dim() == 2, "dataset must be (n, d)")
    mt = canonical_metric(metric)
    expects(mt in _KERNEL_METRICS,
            "brute force supports L2/cosine/IP metrics, got %s", mt.name)
    stored, _ = quantize_rows(dataset.contiguous())
    norms = None
    if mt is not DistanceType.InnerProduct:
        norms = (stored * stored).sum(dim=1)
    return Index(stored, norms, mt)


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
                        index.norms, _penalty_row(index, filter))
    return _postprocess(mt, vals), idxs


def knn(dataset, queries, k, metric="sqeuclidean", device=None):
    """One-shot build + search (the reference's free function)."""
    return search(build(dataset, metric, device), queries, k)


def knn_merge_parts(part_distances: torch.Tensor, part_indices: torch.Tensor,
                    select_min: bool = True
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-shard top-k results: (p, m, k) → (m, k); ties go to the
    lower shard."""
    p, m, k = part_distances.shape
    d = part_distances.permute(1, 0, 2).reshape(m, p * k)
    i = part_indices.permute(1, 0, 2).reshape(m, p * k)
    return select_k(d.contiguous(), k, select_min=select_min, indices=i)
