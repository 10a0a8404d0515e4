"""Exact brute-force kNN: counterpart of
``raft_tpu/neighbors/brute_force.py`` (``Index``, ``build``, ``search``,
``knn``, ``knn_merge_parts``, ``health``, ``quantization_error``,
``make_searcher``, ``tune_search``, ``save``, ``load``).

Engines (``algo``):

* ``"auto"`` — ``"pallas"`` for the metrics K2 serves and ``"scan"`` for
  every other, whatever a :func:`tune_search` verdict says: the scan
  engine computes K2's metrics with library products, which may serve no
  main path, so the verdict is a calibration record.
* ``"pallas"`` — :func:`raft_tpu_torch.ops.fused_knn.fused_knn`: kernel
  K2 (+ the K1 merge) on CUDA, its plain version on the CPU.
* ``"matmul"`` — the plain engine
  (:func:`raft_tpu_torch.ops.fused_knn.fused_knn_plain`): the explicit
  choice of ``torch.matmul`` + norms + stable sort on any device. It
  never races and ``auto`` never runs it.
* ``"scan"`` — the JAX package's composed streaming engine, for every
  metric it takes:
  the dataset in tiles of ``tile_size`` rows, each tile's distance block
  from ``distance/pairwise`` (plain PyTorch, the counterpart of JAX's XLA
  code: no Pallas kernel covers these metrics; the elementwise metrics
  in 64 MiB pieces), each tile's top-k and its merge with the best so
  far through ``matrix.select_k`` — kernel K1 on CUDA, a smallest or a
  largest selection by the metric.

The corpus is stored in any rung of ``ops/quant`` (``build(dtype=...)``):
float32, bfloat16, int8 with per-row scales, uint8 (byte-valued corpora)
or int4 split-half nibbles (the kernels' metrics only); every engine
computes the JAX package's contract for each store (``ops/fused_knn``;
the scan engine dequantizes a tile at a time). ``metric_arg`` is
LpUnexpanded's p. ``valid_rows`` excludes the rows from that index on,
through the penalty row on K2 and the plain engine, as a mask on the
scan. A filtered search follows ``ops/filter_policy``: where few rows
survive (and with no ``valid_rows``, on any store but int4), the
survivors' rows are gathered and searched as an index of their own (the
crossover); inside ``filter_policy.suspended()`` the filter is only the
penalty row. Every matrix product runs in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False), as the JAX package's
``precision="highest"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.bitset import Bitset
from ..core.errors import expects
from ..core.serialize import device_tensor, load_arrays, save_arrays
from ..distance.distance_types import (DistanceType, canonical_metric,
                                      is_min_close)
from ..distance.pairwise import (_ELEMENTWISE, _EXPANDED, _haversine,
                                 elementwise_distance)
from ..matrix.select_k import select_k
from ..ops import autotune, filter_policy
from ..ops.fused_knn import fused_knn, fused_knn_plain
from ..ops.quant import (dequantize_store, int8_scale_report, quantize_rows,
                         store_dtype)
from ..utils import (query_chunks, resolve_device, round_up_to,
                     run_query_chunks)

__all__ = ["Index", "build", "search", "knn", "knn_merge_parts", "health",
           "health_sample_rows", "quantization_error", "make_searcher",
           "tune_search", "save", "load"]

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
# the metrics whose index keeps the squared row norms (JAX's)
_NORM_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                 DistanceType.CosineExpanded)


@dataclasses.dataclass
class Index:
    """Brute-force index: the stored dataset plus the squared norms of its
    dequantized rows (for the expanded L2 and cosine metrics). ``scales``:
    the per-row factors of an int8 or int4 store; ``logical_dim``: the
    row width of an int4 store (its bytes are (n, half_p));
    ``metric_arg``: LpUnexpanded's p."""

    dataset: torch.Tensor           # (n, d) f32 | bf16 | int8 | uint8
    norms: Optional[torch.Tensor]   # (n,) squared L2 norms
    metric: DistanceType
    scales: Optional[torch.Tensor] = None   # (n,) f32, int8/int4 only
    logical_dim: Optional[int] = None       # int4 only
    metric_arg: float = 2.0

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
          device=None, metric_arg: float = 2.0) -> Index:
    """Store the dataset on ``device`` (the CUDA card by default) in the
    store ``dtype`` (float32, bfloat16, int8, uint8 or int4, as
    ``ops.quant.quantize_rows``; int4 for the kernels' metrics only) and,
    for the expanded L2 and cosine metrics, precompute the norms of the
    dequantized rows. Any metric; ``metric_arg`` is LpUnexpanded's p."""
    dev = resolve_device(device)
    dataset = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    expects(dataset.dim() == 2, "dataset must be (n, d)")
    mt = canonical_metric(metric)
    int4 = store_dtype(dtype) == "int4"
    expects(not int4 or mt in _KERNEL_METRICS,
            "int4 storage supports L2/cosine/IP metrics, got %s", mt.name)
    stored, scales = quantize_rows(dataset.contiguous(), dtype)
    logical_dim = dataset.shape[1] if int4 else None
    norms = None
    if mt in _NORM_METRICS:
        deq = dequantize_store(stored, scales, logical_dim)
        norms = (deq * deq).sum(dim=1)
    return Index(stored.contiguous(), norms, mt, scales, logical_dim,
                 float(metric_arg))


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


def _valid_mask(index: Index, filter, valid_rows):
    """(n,) bool: the rows a search may return (the filter's set bits,
    rows below ``valid_rows``), ``None`` when every row may."""
    if filter is None and valid_rows is None:
        return None
    keep = torch.ones(index.size, dtype=torch.bool, device=index.device)
    if filter is not None:
        keep = filter.to(index.device).to_mask()
    if valid_rows is not None:
        rows = torch.arange(index.size, device=index.device)
        keep = keep & (rows < torch.as_tensor(valid_rows,
                                              device=index.device))
    return keep


def _penalty_row(index: Index, filter, valid_rows=None):
    """(n,) additive min-space penalty: +inf on filtered-out rows and rows
    at or past ``valid_rows``, else 0 (``None`` without either)."""
    keep = _valid_mask(index, filter, valid_rows)
    if keep is None:
        return None
    return torch.where(keep, 0.0, float("inf")).to(torch.float32)


def _postprocess(mt: DistanceType, vals: torch.Tensor) -> torch.Tensor:
    """Min-space kernel values → the metric's distances (sqrt for L2,
    the raw inner product, -inf on empty slots, for IP)."""
    if mt is DistanceType.L2SqrtExpanded:
        return torch.sqrt(torch.clamp_min(vals, 0.0))
    if mt is DistanceType.InnerProduct:
        return torch.where(torch.isfinite(vals), -vals, -float("inf"))
    return vals


def _tile_distances(q, q_norm, tile, tile_norm, mt: DistanceType,
                    metric_arg: float):
    """(m, t) distance block of the queries to one dataset tile (the JAX
    package's ``_tile_distances``)."""
    if mt in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        d = torch.clamp_min(q_norm[:, None] + tile_norm[None, :]
                            - 2.0 * (q @ tile.T), 0.0)
        return torch.sqrt(d) if mt is DistanceType.L2SqrtExpanded else d
    if mt is DistanceType.CosineExpanded:
        qn = torch.sqrt(torch.clamp_min(q_norm, 1e-30))
        tn = torch.sqrt(torch.clamp_min(tile_norm, 1e-30))
        return 1.0 - (q @ tile.T) / (qn[:, None] * tn[None, :])
    if mt is DistanceType.InnerProduct:
        return q @ tile.T
    if mt is DistanceType.Haversine:
        return _haversine(q, tile)
    if mt in (DistanceType.CorrelationExpanded,
              DistanceType.HellingerExpanded,
              DistanceType.RusselRaoExpanded):
        return _EXPANDED[mt](q, tile)
    expects(mt in _ELEMENTWISE, "metric %s unsupported by brute force",
            mt.name)
    return elementwise_distance(q, tile, mt, metric_arg)


def _search_scan(index: Index, q: torch.Tensor, k: int, filter,
                 valid_rows, tile_size: int):
    """The scan engine (JAX's ``algo="scan"``): per dataset tile, the
    distance block, excluded rows set to the worst value, the tile's best
    ``min(k, tile)`` by ``select_k`` and their merge with the running best
    (the running best first, so ties keep the earlier rows and the
    (worst, -1) slots of a search with fewer than k admitted rows), both
    selections through ``matrix.select_k`` (K1 on CUDA). Values are the
    metric's own (inner products largest first)."""
    mt = index.metric
    select_min = is_min_close(mt)
    n, m = index.size, q.shape[0]
    tile = min(tile_size, round_up_to(n, 128))
    bad = float("inf") if select_min else -float("inf")
    keep = _valid_mask(index, filter, valid_rows)
    q_norm = (q * q).sum(dim=1)
    best_v = torch.full((m, k), bad, dtype=torch.float32, device=q.device)
    best_i = torch.full((m, k), -1, dtype=torch.int32, device=q.device)
    for base in range(0, n, tile):
        end = min(base + tile, n)
        scales = None if index.scales is None else index.scales[base:end]
        rows = dequantize_store(index.dataset[base:end], scales,
                                index.logical_dim)
        norms = (index.norms[base:end] if index.norms is not None
                 else torch.zeros(end - base, device=q.device))
        d = _tile_distances(q, q_norm, rows, norms, mt, index.metric_arg)
        if keep is not None:
            d = torch.where(keep[None, base:end], d, bad)
        t_val, t_loc = select_k(d.contiguous(), min(k, end - base),
                                select_min)
        merged_v = torch.cat([best_v, t_val], dim=1)
        merged_i = torch.cat([best_i, t_loc + base], dim=1)
        best_v, best_i = select_k(merged_v, k, select_min, merged_i)
    return best_v, best_i


def _tune_key(index: Index, m: int, k: int) -> str:
    """Verdict key of the engine race: the shape class and the store (the
    crossover moves with the bytes a row)."""
    return autotune.shape_bucket("bf_search", index.device, n=index.size,
                                 m=m, d=index.dim, k=k,
                                 store=index.store_name)


def _resolve_algo(index: Index) -> str:
    """The engine ``algo="auto"`` runs: K2 for its metrics, the scan for
    the others (module docstring)."""
    return "pallas" if index.metric in _KERNEL_METRICS else "scan"


def tune_search(index: Index, queries, k: int, reps: int = 5):
    """Race the engines on ``queries`` (:func:`raft_tpu_torch.ops.autotune.
    tune_best`, each call closed by a host read of its output) and record
    the fastest for the shape class: K2 (``"pallas"``, for its metrics)
    against the scan engine. The plain ``"matmul"`` engine never races.
    The verdict is a calibration record that ``algo="auto"`` does not
    follow (module docstring). Returns (winner, {engine: median
    seconds})."""
    q = torch.as_tensor(queries).to(device=index.device,
                                    dtype=torch.float32)
    cands = {"scan": lambda qq: search(index, qq, k, algo="scan")}
    if index.metric in _KERNEL_METRICS:
        cands["pallas"] = lambda qq: search(index, qq, k, algo="pallas")
    return autotune.tune_best(_tune_key(index, q.shape[0], k), cands, q,
                              reps=reps, force=True, value_read=True)


def search(index: Index, queries, k: int,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           algo: str = "auto", query_chunk: int = 0, res=None,
           valid_rows=None, tile_size: int = 8192
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """k nearest neighbors of each query → (distances (m, k), int32
    indices (m, k)), on the index's device.

    ``filter``: optional sample bitset; cleared bits are excluded. With no
    ``valid_rows``, outside ``filter_policy.suspended()`` and on any store
    but int4, a filter whose survivors number at most
    ``RAFT_TPU_FILTER_BRUTE_MAX`` (or as a crossover verdict says) is
    served by the crossover (``ops/filter_policy``: the survivors
    searched as an index of their own; slots past them (+inf, -1)).
    ``valid_rows``: rows at index >= ``valid_rows`` are excluded.
    ``algo``: "auto" — K2 for the metrics it serves (squared L2, L2,
    cosine, inner product) and the scan engine for every other; "pallas" — K2 + the K1 merge on CUDA, their
    plain versions on the CPU; "matmul" — the plain engine (GEMM + norms +
    stable sort) on any device; "scan" — the streaming tile engine
    (module docstring) over ``tile_size`` rows a tile, any metric.
    ``query_chunk``: run queries in chunks of this many rows. ``res``: a
    ``core.deadline.Deadline`` (or an object carrying one as
    ``deadline``): the queries run in chunks (``query_chunk``, else
    :data:`DEADLINE_CHUNK`) with a checkpoint before each, which raises
    ``DeadlineExceeded`` with the finished chunks' results once the
    budget is spent. A chunked search equals the unchunked one. On CUDA
    the kernel takes every k <= the index's size (past
    ``fused_knn.LIST_MAX_K`` its wide form)."""
    q = torch.as_tensor(queries).to(device=index.device,
                                    dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "queries must be (m, %d), got %s", index.dim, tuple(q.shape))
    expects(0 < k <= index.size, "k=%d out of range for index of size %d",
            k, index.size)
    expects(algo in ("auto", "pallas", "matmul", "scan"),
            "unknown brute-force algo %r", algo)
    mt = index.metric
    if (filter is not None and valid_rows is None
            and index.logical_dim is None
            and not filter_policy.adaptive_off()):
        fd = filter_policy.decide_graph(filter, index.size, index.dim, k,
                                        "brute_force", index.device)
        if fd.use_brute:
            return filter_policy.survivor_brute_dense(
                index.dataset, mt, q, k, filter, index.scales,
                index.metric_arg, index.norms, query_chunk, res)

    eng = _resolve_algo(index) if algo == "auto" else algo

    def one(qc: torch.Tensor, _s0: int = 0):
        if eng == "scan":
            return _search_scan(index, qc, k, filter, valid_rows, tile_size)
        expects(mt in _KERNEL_METRICS,
                "algo=%r supports L2/cosine/IP, got %s", eng, mt.name)
        engine = fused_knn_plain if eng == "matmul" else fused_knn
        vals, idxs = engine(qc, index.dataset, k, _KERNEL_METRICS[mt],
                            index.norms,
                            _penalty_row(index, filter, valid_rows),
                            index.scales, index.logical_dim)
        return _postprocess(mt, vals), idxs

    chunk = query_chunks(q.shape[0], query_chunk, res, DEADLINE_CHUNK)
    if chunk:
        return run_query_chunks(one, q, chunk, res)
    return one(q)


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


def knn(dataset, queries, k, metric="sqeuclidean", device=None,
        metric_arg: float = 2.0):
    """One-shot build + search (the reference's free function)."""
    return search(build(dataset, metric, device=device,
                        metric_arg=metric_arg), queries, k)


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
    "brute_force", version 2): meta ``metric``, ``metric_arg``,
    ``store_dtype`` and, for int4,
    ``logical_dim``; arrays ``dataset`` (bfloat16 as its uint16 words),
    ``norms`` and ``scales`` where the index has them. Byte-equal to the
    JAX package's file of the same index."""
    meta = {"metric": index.metric.value,
            "metric_arg": float(index.metric_arg),
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
    card by default), with its metric and ``metric_arg``."""
    _, version, meta, arrays = load_arrays(path, "brute_force")
    expects(version in (1, 2), "unsupported serialization version %d",
            version)
    mt = DistanceType(meta["metric"])
    dev = resolve_device(device)
    dataset = device_tensor(arrays["dataset"], dev,
                            meta.get("store_dtype") == "bfloat16")
    norms, scales = (device_tensor(arrays[a], dev) if a in arrays else None
                     for a in ("norms", "scales"))
    return Index(dataset, norms, mt, scales, meta.get("logical_dim"),
                 meta["metric_arg"])
