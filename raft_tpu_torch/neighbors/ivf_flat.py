"""IVF-Flat index: counterpart of ``raft_tpu/neighbors/ivf_flat.py``
(``IndexParams``, ``SearchParams``, ``Index``, ``build``, ``extend``,
``search``, ``reconstruct``, ``health``).

Lists are contiguous row ranges of one cluster-sorted array
(``_list_layout``), stored float32, bfloat16, int8 with per-row scales or
uint8 (``IndexParams.dtype``, ``ops/quant``), with the squared norms of the
dequantized rows beside them. Search is two stages: a coarse probe (one
``torch.matmul`` over the centers and a select, kernel K1 on CUDA) picks
``n_probes`` lists per query, then the list scan (kernel K3 on CUDA, with
the K1 merge) returns each query's k best rows, mapped to source ids.

Engines (``algo``): ``"auto"`` / ``"pallas"`` run the kernels on CUDA and
their plain versions on the CPU; ``"plain"`` (the JAX package's
``"xla"``) asks for the plain versions on any device: a stable sort for
the probe and gather + score + stable select for the scan
(:func:`raft_tpu_torch.ops.ivf_scan.ivf_flat_scan_plain`).

A filter removes rows through an additive penalty row in sorted row
order, and lists with no surviving row are pruned from the probe — the
JAX package's search under ``filter_policy.suspended()``. Its adaptive
widen/crossover policy, ``extend`` into a non-empty index, host streaming
and serialization are not ported yet. Every matrix product runs in full
float32 (``torch.backends.cuda.matmul.allow_tf32`` False), as the JAX
package's ``precision="highest"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..cluster import kmeans_balanced
from ..core.bitset import Bitset
from ..core.errors import expects
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import SelectAlgo
from ..ops.ivf_scan import coarse_probe, ivf_flat_scan, ivf_flat_scan_plain
from ..ops.quant import (STORES, dequantize_rows, int8_scale_report,
                         quantize_rows, store_dtype)
from ..utils import resolve_device, run_query_chunks
from ._list_layout import list_skew, scatter_build
from .brute_force import _KERNEL_METRICS, _postprocess, health_sample_rows

__all__ = ["IndexParams", "SearchParams", "Index", "build", "extend",
           "search", "reconstruct", "health"]

@dataclasses.dataclass
class IndexParams:
    """Mirror of ivf_flat::index_params (ivf_flat_types.hpp)."""

    n_lists: int = 1024
    metric: DistanceType | str = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    seed: int = 0
    # the lists' store: float32 | bfloat16 | int8 (per-row scales) |
    # uint8 (byte-valued corpora, exact)
    dtype: str = "float32"


@dataclasses.dataclass
class SearchParams:
    """Mirror of ivf_flat::search_params."""

    n_probes: int = 20


@dataclasses.dataclass
class Index:
    """Cluster-sorted IVF-Flat index.

    ``data``: (cap_total, d) rows sorted by list, in the store (rows in
    [offset + size, next offset) are unread slack); ``data_norms`` the
    squared norms of the dequantized rows; ``scales`` (cap_total,) the
    per-row factors of an int8 store (1.0 on slack); ``source_ids``:
    (cap_total,) int32 original ids (-1 on slack);
    ``centers``/``center_norms``: the coarse quantizer;
    ``list_offsets`` (n_lists + 1,) and ``list_sizes`` (n_lists,) host
    int64 arrays. ``offsets_dev``/``sizes_dev`` are their int32 copies on
    the index's device, made once for the scan."""

    data: torch.Tensor
    data_norms: torch.Tensor
    source_ids: torch.Tensor
    centers: torch.Tensor
    center_norms: torch.Tensor
    list_offsets: np.ndarray
    list_sizes: np.ndarray
    metric: DistanceType
    scales: Optional[torch.Tensor] = None
    offsets_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    sizes_dev: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        dev = self.data.device
        self.offsets_dev = torch.as_tensor(
            self.list_offsets[:-1], dtype=torch.int32, device=dev)
        self.sizes_dev = torch.as_tensor(self.list_sizes, dtype=torch.int32,
                                         device=dev)

    @property
    def size(self) -> int:
        """Number of indexed vectors (slack excluded)."""
        return int(self.list_sizes.sum())

    @property
    def dim(self) -> int:
        return self.data.shape[1]

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def store_name(self) -> str:
        return store_dtype(self.data.dtype)


def build(dataset, params: IndexParams | None = None, device=None) -> Index:
    """Train the coarse quantizer on a strided subsample and fill the lists
    (detail/ivf_flat_build.cuh:123), on ``device`` (the CUDA card by
    default)."""
    p = params or IndexParams()
    dev = resolve_device(device)
    dataset = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    expects(dataset.dim() == 2, "dataset must be (n, d)")
    n, d = dataset.shape
    mt = canonical_metric(p.metric)
    expects(mt in _KERNEL_METRICS,
            "ivf_flat supports L2/IP/cosine metrics, got %s", mt.name)
    expects(p.n_lists <= n, "n_lists %d > n %d", p.n_lists, n)
    store = store_dtype(p.dtype)
    expects(store != "int4", "IVF-Flat has no int4 store")

    n_train = max(p.n_lists, int(n * p.kmeans_trainset_fraction))
    stride = max(1, n // n_train)
    centers = kmeans_balanced.fit(
        dataset[::stride], p.n_lists,
        kmeans_balanced.BalancedKMeansParams(n_iters=p.kmeans_n_iters,
                                             seed=p.seed))
    index = Index(
        torch.zeros((0, d), dtype=STORES[store], device=dev),
        torch.zeros((0,), dtype=torch.float32, device=dev),
        torch.zeros((0,), dtype=torch.int32, device=dev), centers,
        (centers * centers).sum(dim=1), np.zeros(p.n_lists + 1, np.int64),
        np.zeros(p.n_lists, np.int64), mt,
        torch.zeros((0,), dtype=torch.float32, device=dev)
        if store == "int8" else None)
    return extend(index, dataset)


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Fill an empty index with vectors (ids 0..n-1 unless ``new_ids``):
    assign each to its nearest center, code them in the index's store and
    scatter the lists, the scales with their rows. Adding to a non-empty
    index is not ported yet."""
    expects(index.size == 0,
            "extend of a non-empty index is not ported yet")
    dev = index.device
    new_vectors = torch.as_tensor(new_vectors).to(device=dev,
                                                  dtype=torch.float32)
    expects(new_vectors.dim() == 2 and new_vectors.shape[1] == index.dim,
            "dim mismatch")
    n_new = new_vectors.shape[0]
    if new_ids is None:
        new_ids = torch.arange(n_new, dtype=torch.int32, device=dev)
    else:
        new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
    labels, _ = kmeans_balanced.predict(new_vectors, index.centers)
    stored, scales = quantize_rows(new_vectors, index.data.dtype)
    deq = dequantize_rows(stored, scales)
    norms = (deq * deq).sum(dim=1)      # the norms of the stored rows
    arrays, fills = [stored, norms, new_ids], [0, 0.0, -1]
    if scales is not None:
        arrays.append(scales)
        fills.append(1.0)
    out, offsets, sizes = scatter_build(labels, arrays, fills, index.n_lists)
    return Index(out[0], out[1], out[2], index.centers, index.center_norms,
                 offsets, sizes, index.metric,
                 out[3] if scales is not None else None)


def _filter_rows(index: Index, filter: Bitset):
    """Sample filter → ((cap_total,) penalty row in sorted row order, +inf
    on filtered-out and slack rows; (n_lists,) survivors per list)."""
    mask = filter.to(index.device).to_mask()
    ids = index.source_ids.long()
    keep = (ids >= 0) & mask[ids.clamp_min(0)]
    pen = torch.where(keep, 0.0, float("inf")).to(torch.float32)
    spans = torch.as_tensor(np.diff(index.list_offsets), device=index.device)
    labels = torch.repeat_interleave(
        torch.arange(index.n_lists, device=index.device), spans)
    survivors = torch.bincount(labels[keep], minlength=index.n_lists)
    return pen, survivors


def search(index: Index, queries, k: int,
           params: SearchParams | None = None,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           query_chunk: int = 0, algo: str = "auto"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the ``n_probes`` nearest lists of each query and return the
    exact top-k over their members → (distances (m, k), int32 source ids
    (m, k)); slots past the candidates hold (+inf, -1) (-inf for inner
    product). ``query_chunk``: run queries in chunks of this many rows.
    On CUDA the scan kernel takes k <= 1024."""
    p = params or SearchParams()
    q = torch.as_tensor(queries).to(device=index.device, dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "bad query shape %s", tuple(q.shape))
    expects(index.size > 0, "index is empty")
    expects(algo in ("auto", "pallas", "plain"),
            "unknown ivf_flat algo %r", algo)
    if 0 < query_chunk < q.shape[0]:
        return run_query_chunks(
            lambda qc, _s0: search(index, qc, k, p, filter, 0, algo),
            q, query_chunk)
    n_probes = min(p.n_probes, index.n_lists)
    mt = index.metric
    metric = _KERNEL_METRICS[mt]
    pen = survivors = None
    sizes = index.sizes_dev
    if filter is not None:
        pen, survivors = _filter_rows(index, filter)
        sizes = torch.where(survivors > 0, sizes, 0).to(torch.int32)
    plain = algo == "plain"
    probed = coarse_probe(q, index.centers, n_probes, metric,
                          index.center_norms, survivors,
                          SelectAlgo.TOPK if plain else SelectAlgo.AUTO)
    scan = ivf_flat_scan_plain if plain else ivf_flat_scan
    vals, rows = scan(index.data, index.data_norms, probed,
                      index.offsets_dev, sizes, q, k, metric, pen,
                      scales=index.scales)
    ids = torch.where(rows >= 0, index.source_ids[rows.clamp_min(0).long()],
                      -1)
    return _postprocess(mt, vals), ids


def reconstruct(index: Index, row_ids) -> torch.Tensor:
    """Stored rows back to f32 vectors by physical row id (positions in
    the cluster-sorted ``index.data``, what the scan returns before the
    source-id remap): exact for float32 and uint8 stores, dequantized
    (times the row's scale) for int8, widened for bfloat16. Raises on ids
    out of range or on slack rows."""
    rid = torch.as_tensor(row_ids).to(device=index.device,
                                      dtype=torch.int64).reshape(-1)
    cap = index.data.shape[0]
    expects(rid.numel() == 0 or (int(rid.min()) >= 0
                                 and int(rid.max()) < cap),
            "row_ids out of range [0, %d)", cap)
    expects(bool((index.source_ids[rid] >= 0).all()),
            "row_ids hit capacity-slack rows (source_id -1)")
    scales = None if index.scales is None else index.scales[rid]
    return dequantize_rows(index.data[rid], scales)


def health(index: Index, sample: int = 256) -> dict:
    """Index health report: list-size skew and the store; an int8 store
    adds the sampled per-row scale stats over real rows (slack rows hold
    no data), as the JAX package reports them."""
    report = {"family": "ivf_flat", "n": int(index.size),
              "dim": int(index.dim), "metric": index.metric.name,
              "store_dtype": index.store_name,
              "lists": list_skew(index.list_sizes)}
    store = index.store_name
    if store == "int8" and index.scales is not None:
        rows = torch.as_tensor(health_sample_rows(index.data.shape[0],
                                                  sample),
                               device=index.device)
        sc = index.scales[rows][index.source_ids[rows] >= 0]
        if sc.numel():
            report["quant"] = int8_scale_report(sc)
    elif store == "bfloat16":
        report["quant"] = {"bfloat16": {"rel_step": 2.0 ** -8}}
    elif store == "uint8":
        report["quant"] = {"uint8": {"exact": True}}
    return report
