"""IVF-Flat index: counterpart of ``raft_tpu/neighbors/ivf_flat.py``
(``IndexParams``, ``SearchParams``, ``Index``, ``build``,
``build_from_batches``, ``extend``, ``search``, ``reconstruct``,
``health``, ``make_searcher``, ``save``, ``load``).

Lists are contiguous row ranges of one cluster-sorted array
(``_list_layout``), stored float32, bfloat16, int8 with per-row scales or
uint8 (``IndexParams.dtype``, ``ops/quant``), with the squared norms of the
dequantized rows beside them. ``IndexParams.list_growth`` > 1 leaves
capacity slack in each list, so that ``extend`` into a filled index is
one scatter of the new rows while every list has room, and a repack with
the same slack when one overflows; ``build_from_batches`` streams a
corpus through those extends. Search is two stages: a coarse probe (one
``torch.matmul`` over the centers and a select, kernel K1 on CUDA) picks
``n_probes`` lists per query, then the list scan (kernel K3 on CUDA, with
the K1 merge) returns each query's k best rows, mapped to source ids.

Engines (``algo``): ``"auto"`` / ``"pallas"`` run the kernels on CUDA and
their plain versions on the CPU; ``"plain"`` (the JAX package's
``"xla"``) asks for the plain versions on any device: a stable sort for
the probe and gather + score + stable select for the scan
(:func:`raft_tpu_torch.ops.ivf_scan.ivf_flat_scan_plain`).

A filter removes rows through an additive penalty row in sorted row
order, lists with no surviving row are pruned from the probe, and the
adaptive policy (``ops/filter_policy``) widens ``n_probes`` or, where few
rows survive, searches the survivors' rows (:func:`reconstruct`) by brute
force; inside ``filter_policy.suspended()`` only the prune stays. Host
streaming is not ported yet. ``save`` /
``load`` read and write the JAX package's files: lists packed with no
slack; a loaded index keeps that dense layout (list starts at any row;
the kernels take them). Every
matrix product runs in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False), as the JAX
package's ``precision="highest"``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..cluster import kmeans_balanced
from ..core.bitset import Bitset
from ..core.errors import RaftError, expects
from ..core.resources import workspace_chunk_bytes
from ..core.serialize import device_tensor, load_arrays, save_arrays
from ..distance.distance_types import DistanceType, canonical_metric
from ..matrix.select_k import SelectAlgo
from ..ops import filter_policy
from ..ops.ivf_scan import coarse_probe, ivf_flat_scan, ivf_flat_scan_plain
from ..ops.quant import (STORES, dequantize_rows, int8_scale_report,
                         quantize_rows, store_dtype)
from ..utils import (query_chunks, resolve_device, round_up_to,
                     run_query_chunks)
from ._list_layout import (dense_offsets, gather_dense, list_skew,
                           scatter_extend, streaming_build)
from .brute_force import _KERNEL_METRICS, _postprocess, health_sample_rows

__all__ = ["IndexParams", "SearchParams", "Index", "build",
           "build_from_batches", "extend", "search", "reconstruct",
           "health", "make_searcher", "save", "load"]

# the file version save writes (the JAX package's); load reads 1 and 2
_SERIAL_VERSION = 2


@dataclasses.dataclass
class IndexParams:
    """Mirror of ivf_flat::index_params (ivf_flat_types.hpp).
    ``list_growth``: each list's capacity slack factor (1.0: the lists
    packed, aligned; more: ``extend`` scatters into the slack until a list
    overflows). ``add_data_on_build`` False trains the quantizer only."""

    n_lists: int = 1024
    metric: DistanceType | str = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    add_data_on_build: bool = True
    seed: int = 0
    list_growth: float = 1.0
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
    int64 arrays. ``list_growth`` is the slack factor extends lay the
    lists out with; ``conservative_memory`` RAFT's flag of that name, kept
    for its files. ``offsets_dev``/``sizes_dev`` are the int32 copies of
    the offsets and sizes on the index's device, made once for the
    scan."""

    data: torch.Tensor
    data_norms: torch.Tensor
    source_ids: torch.Tensor
    centers: torch.Tensor
    center_norms: torch.Tensor
    list_offsets: np.ndarray
    list_sizes: np.ndarray
    metric: DistanceType
    scales: Optional[torch.Tensor] = None
    list_growth: float = 1.0
    conservative_memory: bool = False
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
    """Train the coarse quantizer on a strided subsample and, unless
    ``add_data_on_build`` is False, fill the lists
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
        if store == "int8" else None, p.list_growth)
    return extend(index, dataset) if p.add_data_on_build else index


def build_from_batches(batches, params: IndexParams | None = None,
                       trainset=None, device=None) -> Index:
    """Streaming build for corpora larger than the host holds (the role of
    the reference's bounded-batch extend loop): the quantizer trains on
    ``trainset``, else on the first batch, then each (b, d) block of
    ``batches`` is extended in turn. ``list_growth`` is floored at 1.2,
    so most extends scatter into slack. On ``device`` (the CUDA card by
    default)."""
    dev = resolve_device(device)
    return streaming_build(batches, params or IndexParams(),
                           lambda x, p: build(x, p, dev), extend, trainset)


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Add vectors (detail/ivf_flat_build.cuh extend): assign each to its
    nearest center, code it in the index's store and append it to its
    list, the scales with their rows. Ids continue from the largest id
    held (0 for an empty index) unless ``new_ids`` are given. While every
    list has room the new rows are scattered into the slack; a list that
    overflows repacks the lists with ``list_growth`` slack."""
    dev = index.device
    new_vectors = torch.as_tensor(new_vectors).to(device=dev,
                                                  dtype=torch.float32)
    expects(new_vectors.dim() == 2 and new_vectors.shape[1] == index.dim,
            "dim mismatch")
    n_new = new_vectors.shape[0]
    if new_ids is None:
        base = int(index.source_ids.max()) + 1 if index.size else 0
        new_ids = torch.arange(base, base + n_new, dtype=torch.int32,
                               device=dev)
    else:
        new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
    labels, _ = kmeans_balanced.predict(new_vectors, index.centers)
    stored, scales = quantize_rows(new_vectors, index.data.dtype)
    deq = dequantize_rows(stored, scales)
    norms = (deq * deq).sum(dim=1)      # the norms of the stored rows
    arrays, fills = [stored, norms, new_ids], [0, 0.0, -1]
    old = [index.data, index.data_norms, index.source_ids]
    if scales is not None:
        arrays.append(scales)
        old.append(index.scales)
        fills.append(1.0)
    out, offsets, sizes = scatter_extend(
        labels, arrays, old, fills, index.list_offsets, index.list_sizes,
        index.list_growth)
    return Index(out[0], out[1], out[2], index.centers, index.center_norms,
                 offsets, sizes, index.metric,
                 out[3] if scales is not None else None, index.list_growth,
                 index.conservative_memory)


def _penalty(index: Index, filter: Bitset) -> torch.Tensor:
    """Sample filter → (cap_total,) penalty row in sorted row order: +inf
    on filtered-out and slack rows, else 0."""
    mask = filter.to(index.device).to_mask()
    ids = index.source_ids.long()
    keep = (ids >= 0) & mask[ids.clamp_min(0)]
    return torch.where(keep, 0.0, float("inf")).to(torch.float32)


def search(index: Index, queries, k: int,
           params: SearchParams | None = None,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           query_chunk: int = 0, algo: str = "auto", res=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Probe the ``n_probes`` nearest lists of each query and return the
    exact top-k over their members → (distances (m, k), int32 source ids
    (m, k)); slots past the candidates hold (+inf, -1) (-inf for inner
    product). ``filter``: a sample bitset, decided on once a search
    (module docstring): the probe widened to ``filter_policy``'s level,
    or the crossover. ``query_chunk``: run queries in chunks of this many
    rows. ``res``: a ``core.deadline.Deadline`` (or an object carrying
    one): the queries run in chunks (``query_chunk``, else as many as
    ``core.resources.workspace_chunk_bytes(res)`` holds at n_probes x
    dim rounded up to 128 floats a query) with a checkpoint before each,
    which raises ``DeadlineExceeded`` with the finished chunks' results
    once the budget is spent. A chunked search equals the unchunked one.
    On CUDA the scan kernel's grouped form takes every k (past 512 its
    wide plan)."""
    p = params or SearchParams()
    q = torch.as_tensor(queries).to(device=index.device, dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "bad query shape %s", tuple(q.shape))
    expects(index.size > 0, "index is empty")
    expects(algo in ("auto", "pallas", "plain"),
            "unknown ivf_flat algo %r", algo)
    n_probes = min(p.n_probes, index.n_lists)
    pen = survivors = None
    sizes = index.sizes_dev
    if filter is not None:
        fd, n_probes, survivors = filter_policy.plan_ivf(
            index, filter, n_probes, k, "ivf_flat")
        if fd is not None and fd.use_brute:
            return filter_policy.survivor_brute_ivf(
                index, reconstruct, q, k, filter, index.data_norms,
                query_chunk, res)
        pen = _penalty(index, filter)
        sizes = torch.where(survivors > 0, sizes, 0).to(torch.int32)
    mt = index.metric
    metric = _KERNEL_METRICS[mt]
    plain = algo == "plain"
    scan = ivf_flat_scan_plain if plain else ivf_flat_scan

    def one(qc: torch.Tensor, _s0: int = 0):
        probed = coarse_probe(qc, index.centers, n_probes, metric,
                              index.center_norms, survivors,
                              SelectAlgo.TOPK if plain else SelectAlgo.AUTO)
        vals, rows = scan(index.data, index.data_norms, probed,
                          index.offsets_dev, sizes, qc, k, metric, pen,
                          scales=index.scales)
        ids = torch.where(rows >= 0,
                          index.source_ids[rows.clamp_min(0).long()], -1)
        return _postprocess(mt, vals), ids

    per_q = n_probes * round_up_to(index.dim, 128) * 4
    chunk = query_chunks(q.shape[0], query_chunk, res,
                         workspace_chunk_bytes(res) // per_q)
    if chunk:
        return run_query_chunks(one, q, chunk, res)
    return one(q)


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


def make_searcher(index: Index, params: SearchParams | None = None, *,
                  degrade=None, **opts):
    """``fn(queries, k, res=None) -> (distances, indices)`` with the
    search parameters and ``opts`` (``filter``, ``query_chunk``,
    ``algo``) frozen: the serving signature the four families share.
    ``degrade`` (JAX's brownout controller) waits for the serving layer
    and raises."""
    if degrade is not None:
        raise RaftError("make_searcher(degrade=...) is not ported yet: it "
                        "comes with the serving layer")
    base = params or SearchParams()

    def _fn(queries, k, res=None):
        return search(index, queries, k, base, res=res, **opts)

    return _fn


def save(index: Index, path) -> None:
    """Write the index in the JAX package's file format (kind "ivf_flat",
    version 2): meta ``metric``, ``n_lists``, ``store_dtype``; arrays
    ``data`` (bfloat16 as its uint16 words), ``source_ids``, ``centers``,
    ``list_offsets`` and, for int8, ``scales``, the lists packed with no
    slack (``list_offsets`` the cumulative sizes). Byte-equal to the JAX
    package's file of the same index."""
    arrays = [index.data, index.source_ids]
    if index.scales is not None:
        arrays.append(index.scales)
    arrays = gather_dense(arrays, index.list_offsets, index.list_sizes)
    out = {"data": arrays[0], "source_ids": arrays[1],
           "centers": index.centers,
           "list_offsets": dense_offsets(index.list_sizes)}
    if index.scales is not None:
        out["scales"] = arrays[2]
    save_arrays(path, "ivf_flat", _SERIAL_VERSION,
                {"metric": index.metric.value, "n_lists": index.n_lists,
                 "store_dtype": index.store_name}, out)


def load(path, device=None) -> Index:
    """Read an IVF-Flat file of either package onto ``device`` (the CUDA
    card by default). The lists keep the file's dense layout; the row
    norms are computed from the dequantized rows and the center norms
    from the centers, as :func:`build` computes them."""
    _, version, meta, arrs = load_arrays(path, "ivf_flat")
    expects(version in (1, 2), "unsupported version %d", version)
    mt = DistanceType(meta["metric"])
    expects(mt in _KERNEL_METRICS, "ivf_flat with metric %s is not ported "
            "yet", mt.name)
    dev = resolve_device(device)
    data = device_tensor(arrs["data"], dev,
                         meta.get("store_dtype") == "bfloat16")
    scales = (device_tensor(arrs["scales"], dev) if "scales" in arrs
              else None)
    deq = dequantize_rows(data, scales)
    norms = (deq * deq).sum(dim=1)
    del deq
    centers = device_tensor(arrs["centers"], dev)
    offsets = np.asarray(arrs["list_offsets"], np.int64)
    return Index(data, norms, device_tensor(arrs["source_ids"], dev),
                 centers, (centers * centers).sum(dim=1), offsets,
                 np.diff(offsets), mt, scales)
