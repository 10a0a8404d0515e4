"""IVF-PQ index: counterpart of ``raft_tpu/neighbors/ivf_pq.py``
(``CodebookGen``, ``IndexParams``, ``SearchParams``, ``Index``,
``make_rotation_matrix``, ``build``, ``build_from_batches``, ``extend``,
``search``, ``reconstruct``, ``health``, ``make_searcher``,
``pack_codes``, ``unpack_codes``, ``save``, ``load``).

Everything lives in rotated space, as in the JAX package: the dataset is
rotated once at build and the queries once at search (an orthogonal
rotation keeps L2 and inner products), and the coarse centers, residuals
and codebooks stay in rotated coordinates. Lists are contiguous row
ranges of one cluster-sorted (rows, pq_dim) uint8 code matrix
(``_list_layout``), one byte per subspace for any ``pq_bits`` in 4..8,
with ``IndexParams.list_growth`` capacity slack as IVF-Flat's.

Build: balanced k-means on a strided subsample (the coarse quantizer),
the rotation, then the codebooks, trained by fixed-iteration Lloyd on the
subsample's rotated residuals (labels from ``kmeans_balanced.predict``):
``PER_SUBSPACE`` one a subspace, (pq_dim, 2^pq_bits, pq_len);
``PER_CLUSTER`` one a list, (n_lists, 2^pq_bits, pq_len), each trained on
2,048 of its list's residual rows drawn with replacement, their
subspaces pooled (the JAX package's ``_train_per_cluster``; the draws
come from a ``torch.Generator``, so a per-cluster build matches JAX's in
quality, not bit for bit). ``extend`` assigns every row to its nearest
*rotated* center by a plain argmin, encodes its residual and appends it
to its list (into a filled index too: one scatter while the lists have
slack, a repack when one overflows); ``build_from_batches`` streams a
corpus through those extends. The decoded row norms ``||c_l + dec_i||²``
are computed once, when an :class:`Index` is made.

Search: rotate the queries, the coarse probe on the rotated centers
(``torch.matmul`` + kernel K1 on CUDA), then the PQ list scan (kernel K4
on CUDA, with the K1 merge) in the expanded form of the JAX package's
Pallas scan, with the codebook rounded to the LUT mode
(``SearchParams.lut_dtype``; per-cluster codebooks take bf16 for an int8
request, as the JAX package's gather path does). ``algo="plain"`` asks
for the plain versions on any device. The JAX package's gather engine
(``algo="xla"``), which rounds the *LUT* to bf16 and sums it in bf16,
is not ported as an engine: under ``lut_dtype=float32`` both compute the
same distances up to float32 rounding.

A filter removes rows through an additive penalty row in sorted row
order, lists with no surviving row are pruned from the probe, and the
adaptive policy (``ops/filter_policy``) widens ``n_probes`` or, where few
rows survive, searches the survivors decoded and rotated back
(:func:`reconstruct`) by brute force; inside
``filter_policy.suspended()`` only the prune stays. Not ported yet: host
streaming. ``save`` / ``load`` read
and write the JAX package's files (bit-packed codes, lists packed with no
slack). Every matrix product runs
in full float32 (``torch.backends.cuda.matmul.allow_tf32`` False).
"""
from __future__ import annotations

import dataclasses
import enum
import time
from typing import Optional, Tuple

import numpy as np
import torch

from ..cluster import kmeans_balanced
from ..cluster.kmeans import segment_sum
from ..core.bitset import Bitset
from ..core.errors import RaftError, expects
from ..core.resources import workspace_chunk_bytes
from ..core.serialize import device_tensor, load_arrays, save_arrays
from ..distance.distance_types import DistanceType, canonical_metric
from ..distance.fused_l2_nn import fused_l2_nn_argmin
from ..matrix.select_k import SelectAlgo
from ..ops import filter_policy
from ..ops.ivf_pq_scan import (decoded_row_norms, ivf_pq_scan,
                               ivf_pq_scan_plain, lut_codebook,
                               pq_chunk_rows)
from ..ops.ivf_scan import coarse_probe
from ..utils import cdiv, query_chunks, resolve_device, run_query_chunks
from ._list_layout import (dense_offsets, gather_dense, list_skew,
                           scatter_extend, span_labels, streaming_build)
from .brute_force import _postprocess, health_sample_rows
from .ivf_flat import _penalty

__all__ = ["CodebookGen", "IndexParams", "SearchParams", "Index",
           "make_rotation_matrix", "build", "build_from_batches", "extend",
           "search", "reconstruct", "health", "make_searcher", "pack_codes",
           "unpack_codes", "save", "load"]

# the file version save writes and load reads (the JAX package's)
_SERIAL_VERSION = 1
_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.InnerProduct)
# residual rows a list a per-cluster codebook trains on (JAX's)
_SAMPLES_PER_LIST = 2048


class CodebookGen(enum.Enum):
    """ivf_pq_types.hpp:43 codebook_gen."""

    PER_SUBSPACE = 0
    PER_CLUSTER = 1


@dataclasses.dataclass
class IndexParams:
    """Mirror of ivf_pq::index_params (ivf_pq_types.hpp:110).
    ``list_growth``: each list's capacity slack factor, as IVF-Flat's;
    ``add_data_on_build`` False trains the quantizers only."""

    n_lists: int = 1024
    metric: DistanceType | str = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8                   # 4..8
    pq_dim: int = 0                    # 0 → dim/4 rounded to a multiple of 8
    codebook_kind: CodebookGen = CodebookGen.PER_SUBSPACE
    force_random_rotation: bool = False
    add_data_on_build: bool = True
    seed: int = 0
    list_growth: float = 1.0


@dataclasses.dataclass
class SearchParams:
    """Mirror of ivf_pq::search_params (ivf_pq_types.hpp:146).
    ``lut_dtype`` picks the codebook the ``q·decode`` term reads:
    ``torch.float32`` exact, ``torch.bfloat16`` (default, the fp16-LUT
    role) or ``torch.int8`` (per-subspace symmetric quantization, the
    fp8-LUT role; bf16 on per-cluster codebooks); the names "float32",
    "bfloat16", "int8" and their aliases work too."""

    n_probes: int = 20
    lut_dtype: torch.dtype | str = torch.bfloat16


def _lut_mode(lut_dtype) -> str:
    """SearchParams.lut_dtype → LUT mode ("f32", "bf16", "int8"). Unknown
    names raise: a typo must not quietly change the precision."""
    if isinstance(lut_dtype, torch.dtype):
        if lut_dtype == torch.int8:
            return "int8"
        if lut_dtype == torch.float32:
            return "f32"
        expects(lut_dtype in (torch.bfloat16, torch.float16),
                "unknown lut_dtype %r (use float32 / bfloat16 / int8)",
                lut_dtype)
        return "bf16"
    s = str(lut_dtype).lower()
    if s in ("int8", "i8", "fp8"):
        return "int8"
    if s in ("f32", "float32", "fp32"):
        return "f32"
    expects(s in ("bf16", "bfloat16", "fp16", "f16"),
            "unknown lut_dtype %r (use float32 / bfloat16 / int8)",
            lut_dtype)
    return "bf16"


@dataclasses.dataclass
class Index:
    """Rotated-space IVF-PQ index.

    ``codes``: (cap_total, pq_dim) uint8 cluster-sorted (rows in
    [offset + size, next offset) are unread slack, code 0);
    ``source_ids``: (cap_total,) int32 (-1 on slack); ``centers_rot``:
    (n_lists, rot_dim); ``codebooks``: (pq_dim, 2^pq_bits, pq_len), or
    (n_lists, 2^pq_bits, pq_len) for ``PER_CLUSTER``; ``rotation``:
    (rot_dim, dim) with orthonormal columns; ``list_offsets`` (n_lists +
    1,) and ``list_sizes`` (n_lists,) host int64 arrays; ``list_growth``
    the slack factor extends lay the lists out with. Made once here:
    ``row_norms`` (the decoded squared row norms, from the unrounded
    codebook), ``center_norms`` and the int32 ``offsets_dev`` /
    ``sizes_dev`` on the index's device. ``build_seconds``
    holds the build's stages when :func:`build` made the index."""

    codes: torch.Tensor
    source_ids: torch.Tensor
    centers_rot: torch.Tensor
    codebooks: torch.Tensor
    rotation: torch.Tensor
    list_offsets: np.ndarray
    list_sizes: np.ndarray
    metric: DistanceType
    pq_bits: int
    codebook_kind: CodebookGen = CodebookGen.PER_SUBSPACE
    list_growth: float = 1.0
    row_norms: torch.Tensor = dataclasses.field(init=False, repr=False)
    center_norms: torch.Tensor = dataclasses.field(init=False, repr=False)
    offsets_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    sizes_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    build_seconds: dict = dataclasses.field(init=False, repr=False,
                                            default_factory=dict)

    def __post_init__(self):
        expects(self.codebooks.shape[1] == 1 << self.pq_bits,
                "codebooks hold %d entries, pq_bits=%d needs %d",
                self.codebooks.shape[1], self.pq_bits, 1 << self.pq_bits)
        books = self.n_lists if self.per_cluster else self.pq_dim
        expects(self.codebooks.shape[0] == books,
                "%s codebooks must number %d, got %d",
                self.codebook_kind.name, books, self.codebooks.shape[0])
        dev = self.codes.device
        self.row_norms = decoded_row_norms(
            self.codes, self.centers_rot, self.codebooks, self.list_offsets,
            self.per_cluster)
        self.center_norms = (self.centers_rot * self.centers_rot).sum(dim=1)
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
        return self.rotation.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def pq_dim(self) -> int:
        return self.codes.shape[1]

    @property
    def per_cluster(self) -> bool:
        return self.codebook_kind is CodebookGen.PER_CLUSTER

    @property
    def pq_len(self) -> int:
        return self.codebooks.shape[2]

    @property
    def pq_book_size(self) -> int:
        return 1 << self.pq_bits

    @property
    def n_lists(self) -> int:
        return self.centers_rot.shape[0]

    @property
    def device(self) -> torch.device:
        return self.codes.device


class _Laps:
    """Wall seconds of a build's stages, the card synchronised at each
    mark so a stage's time is its own."""

    def __init__(self, dev: torch.device):
        self.dev = dev
        self.seconds: dict = {}
        self.t = self._now()

    def _now(self) -> float:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        t = self._now()
        self.seconds[stage] = t - self.t
        self.t = t


def _default_pq_dim(dim: int) -> int:
    """ivf_pq_types.hpp: pq_dim=0 → dim/4 rounded for alignment."""
    pq = max(1, dim // 4)
    if pq > 8:
        pq = (pq // 8) * 8
    return pq


def make_rotation_matrix(gen: torch.Generator, rot_dim: int, dim: int,
                         force_random: bool) -> torch.Tensor:
    """(rot_dim, dim) with orthonormal columns (ivf_pq_build.cuh:119), on
    ``gen``'s device: the identity when rot_dim == dim and no rotation is
    forced, else the Q factor of a Gaussian drawn from ``gen`` (rot_dim !=
    dim always rotates, so no subspace is left mostly zeros)."""
    if not force_random and rot_dim == dim:
        return torch.eye(dim, dtype=torch.float32, device=gen.device)
    g = torch.randn((rot_dim, rot_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    qm, _ = torch.linalg.qr(g)
    return qm[:, :dim].contiguous()


def _kmeans_fixed(x: torch.Tensor, k: int, iters: int,
                  gen: torch.Generator) -> torch.Tensor:
    """Fixed-iteration Lloyd on a batch of problems: (S, T, L) points →
    (S, k, L) centers — for the codebooks, (pq_dim, T, pq_len) residual
    slices → (pq_dim, book, pq_len) (ivf_pq_build.cuh:392
    train_per_subset). Init = k distinct random points of each problem;
    an empty cluster keeps its center. The (S, rows, k) distance block is
    computed in row chunks of :func:`pq_chunk_rows`."""
    s_n, t_n, dim = x.shape
    expects(t_n >= k, "codebook training needs >= %d rows, got %d", k, t_n)
    dev = x.device
    x = x.contiguous()
    pick = torch.argsort(torch.rand((s_n, t_n), generator=gen, device=dev),
                         dim=1)[:, :k]
    centers = torch.gather(x, 1, pick[:, :, None].expand(s_n, k, dim))
    chunk = pq_chunk_rows(s_n, k)
    slot = torch.empty((s_n, t_n), dtype=torch.int64, device=dev)
    base = (torch.arange(s_n, device=dev) * k)[:, None]
    for _ in range(iters):
        cn = (centers * centers).sum(dim=2)[:, None, :]
        for t0 in range(0, t_n, chunk):
            xc = x[:, t0 : t0 + chunk]
            # ||x||² is constant along the argmin: dropped
            d2 = torch.baddbmm(cn, xc, centers.transpose(1, 2), alpha=-2.0)
            slot[:, t0 : t0 + chunk] = d2.argmin(dim=2) + base
        # one sum a step over every problem's points, in a fixed order
        sums = segment_sum(x.reshape(-1, dim), slot.view(-1),
                           s_n * k).view(s_n, k, dim)
        cnts = torch.bincount(slot.view(-1), minlength=s_n * k).view(
            s_n, k, 1)
        centers = torch.where(cnts > 0, sums / cnts.clamp_min(1), centers)
    return centers


def _train_per_cluster(resid_rot: torch.Tensor, labels: torch.Tensor,
                       n_lists: int, pq_len: int, book: int, iters: int,
                       gen: torch.Generator) -> torch.Tensor:
    """Per-cluster codebooks (ivf_pq_build.cuh:469 train_per_cluster):
    each list trains on :data:`_SAMPLES_PER_LIST` of its residual rows,
    drawn with replacement (row 0 for an empty list), their subspaces
    pooled into one set of pq_len-wide points → (n_lists, book, pq_len).
    The lists train in chunks, so that a chunk's (lists, samples·pq_dim,
    book) distance block stays within ``workspace_chunk_bytes``'s
    default budget."""
    dev = resid_rot.device
    n = resid_rot.shape[0]
    pq_dim = resid_rot.shape[1] // pq_len
    slices = resid_rot.reshape(n, pq_dim, pq_len)
    order = torch.argsort(labels, stable=True)
    counts = torch.bincount(labels, minlength=n_lists)
    starts = torch.cumsum(counts, 0) - counts
    u = torch.rand((n_lists, _SAMPLES_PER_LIST), generator=gen, device=dev)
    pick = torch.minimum((u * counts[:, None]).long(),
                         (counts - 1).clamp_min(0)[:, None])
    rows = torch.where(counts[:, None] > 0,
                       order[(starts[:, None] + pick).clamp_max(n - 1)], 0)
    points = _SAMPLES_PER_LIST * pq_dim
    per_list = points * book * 4
    step = max(1, workspace_chunk_bytes(None) // per_list)
    out = []
    for l0 in range(0, n_lists, step):
        pool = slices[rows[l0 : l0 + step]].reshape(-1, points, pq_len)
        out.append(_kmeans_fixed(pool, book, iters, gen))
    return torch.cat(out)


def _encode(resid_rot: torch.Tensor, codebooks: torch.Tensor,
            labels: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Residuals (n, rot_dim) → (n, pq_dim) uint8 codes: per-subspace
    argmin of ``||r_s||² - 2 r_s·cb + ||cb||²`` (ties to the lower code);
    with ``labels`` (per-cluster codebooks) ``cb`` is the row's list's."""
    _, _, pq_len = codebooks.shape
    slices = resid_rot.reshape(resid_rot.shape[0], -1, pq_len)
    if labels is not None:
        books = codebooks[labels]                    # (n, book, pq_len)
        d2 = ((slices * slices).sum(dim=2)[:, :, None]
              - 2.0 * torch.bmm(slices, books.transpose(1, 2))
              + (books * books).sum(dim=2)[:, None, :])
    else:
        d2 = ((slices * slices).sum(dim=2)[:, :, None]
              - 2.0 * torch.einsum("nsl,sbl->nsb", slices, codebooks)
              + (codebooks * codebooks).sum(dim=2)[None, :, :])
    return d2.argmin(dim=2).to(torch.uint8)


def build(dataset, params: IndexParams | None = None, device=None) -> Index:
    """Train the coarse quantizer, the rotation and the codebooks, then,
    unless ``add_data_on_build`` is False, encode and pack the dataset
    (detail/ivf_pq_build.cuh:1729), on ``device`` (the CUDA card by
    default). The index's ``build_seconds`` splits the time into
    "coarse_kmeans", "codebooks" and "encode"."""
    p = params or IndexParams()
    dev = resolve_device(device)
    dataset = torch.as_tensor(dataset).to(device=dev, dtype=torch.float32)
    expects(dataset.dim() == 2, "dataset must be (n, d)")
    n, dim = dataset.shape
    mt = canonical_metric(p.metric)
    expects(mt in _METRICS, "ivf_pq supports L2/IP metrics, got %s",
            mt.name)
    expects(4 <= p.pq_bits <= 8, "pq_bits must be in [4,8], got %d",
            p.pq_bits)
    expects(p.n_lists <= n, "n_lists %d > n %d", p.n_lists, n)
    pq_dim = p.pq_dim or _default_pq_dim(dim)
    pq_len = cdiv(dim, pq_dim)
    rot_dim = pq_dim * pq_len
    laps = _Laps(dev)

    # coarse quantizer on a subsample (ivf_pq_build.cuh:1760-1830)
    n_train = max(p.n_lists, min(n, int(n * p.kmeans_trainset_fraction)))
    trainset = dataset[:: max(1, n // n_train)]
    centers = kmeans_balanced.fit(
        trainset, p.n_lists,
        kmeans_balanced.BalancedKMeansParams(n_iters=p.kmeans_n_iters,
                                             seed=p.seed))
    laps.mark("coarse_kmeans")

    rotation = make_rotation_matrix(kmeans_balanced._generator(p.seed, dev),
                                    rot_dim, dim, p.force_random_rotation)
    centers_rot = centers @ rotation.T
    # codebooks on the rotated residuals of the subsample
    # (ivf_pq_build.cuh:1855-1873)
    t_labels, _ = kmeans_balanced.predict(trainset, centers)
    t_resid = trainset @ rotation.T - centers_rot[t_labels]
    gen = kmeans_balanced._generator(p.seed + 1, dev)
    if p.codebook_kind is CodebookGen.PER_SUBSPACE:
        codebooks = _kmeans_fixed(
            t_resid.reshape(-1, pq_dim, pq_len).transpose(0, 1),
            1 << p.pq_bits, p.kmeans_n_iters, gen)
    else:
        codebooks = _train_per_cluster(t_resid, t_labels, p.n_lists, pq_len,
                                       1 << p.pq_bits, p.kmeans_n_iters,
                                       gen)
    laps.mark("codebooks")

    index = Index(torch.zeros((0, pq_dim), dtype=torch.uint8, device=dev),
                  torch.zeros((0,), dtype=torch.int32, device=dev),
                  centers_rot, codebooks, rotation,
                  np.zeros(p.n_lists + 1, np.int64),
                  np.zeros(p.n_lists, np.int64), mt, p.pq_bits,
                  p.codebook_kind, p.list_growth)
    if p.add_data_on_build:
        index = extend(index, dataset)
        laps.mark("encode")
    index.build_seconds = laps.seconds
    return index


def build_from_batches(batches, params: IndexParams | None = None,
                       trainset=None, device=None) -> Index:
    """Streaming build (the reference's bounded-batch build): the
    quantizers train on ``trainset``, else on the first batch, then each
    (b, d) block of ``batches`` is assigned, encoded and appended in turn
    (``list_growth`` floored at 1.2, so most extends scatter into slack).
    On ``device`` (the CUDA card by default)."""
    dev = resolve_device(device)
    return streaming_build(batches, params or IndexParams(),
                           lambda x, p: build(x, p, dev), extend, trainset)


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Add vectors (ivf_pq_build.cuh:1550): assign each to its nearest
    rotated center and encode its residual, in batches of
    :func:`pq_chunk_rows` rows, then append the codes to their lists: one
    scatter while every list has room, a repack with ``list_growth``
    slack when one overflows. Ids continue from the largest id held (0
    for an empty index) unless ``new_ids`` are given."""
    dev = index.device
    x = torch.as_tensor(new_vectors).to(device=dev, dtype=torch.float32)
    expects(x.dim() == 2 and x.shape[1] == index.dim, "dim mismatch")
    n_new = x.shape[0]
    if new_ids is None:
        base = int(index.source_ids.max()) + 1 if index.size else 0
        new_ids = torch.arange(base, base + n_new, dtype=torch.int32,
                               device=dev)
    else:
        new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
    batch = pq_chunk_rows(index.pq_dim, index.pq_book_size)
    cr = index.centers_rot
    labels, codes = [], []
    for b0 in range(0, n_new, batch):
        xr = x[b0 : b0 + batch] @ index.rotation.T
        # nearest rotated center == nearest center (orthogonal rotation)
        lb = fused_l2_nn_argmin(xr, cr)[0]
        codes.append(_encode(xr - cr[lb], index.codebooks,
                             lb if index.per_cluster else None))
        labels.append(lb)
    labels = torch.cat(labels) if labels else torch.zeros(
        (0,), dtype=torch.int64, device=dev)
    codes = torch.cat(codes) if codes else index.codes[:0]
    (codes, ids), offsets, sizes = scatter_extend(
        labels, [codes, new_ids], [index.codes, index.source_ids], [0, -1],
        index.list_offsets, index.list_sizes, index.list_growth)
    return Index(codes, ids, index.centers_rot, index.codebooks,
                 index.rotation, offsets, sizes, index.metric, index.pq_bits,
                 index.codebook_kind, index.list_growth)


def search(index: Index, queries, k: int,
           params: SearchParams | None = None,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           query_chunk: int = 0, algo: str = "auto", res=None
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LUT-based approximate top-k (detail/ivf_pq_search.cuh:731) →
    (distances (m, k), int32 source ids (m, k)); slots past the
    candidates hold (+inf, -1) (-inf for inner product).

    ``filter``: a sample bitset, decided on once a search (module
    docstring): the probe widened to ``filter_policy``'s level, or the
    crossover over the decoded survivors. ``algo``: "auto" / "pallas" —
    K1 + K4 on CUDA, their plain versions on the CPU; "plain" — the plain
    versions on any device. ``query_chunk``:
    run queries in chunks of this many rows. ``res``: a
    ``core.deadline.Deadline`` (or an object carrying one): the queries
    run in chunks (``query_chunk``, else as many as
    ``core.resources.workspace_chunk_bytes(res)`` holds at n_probes x
    rot_dim x 8 bytes a query) with a checkpoint before each, which
    raises ``DeadlineExceeded`` with the finished chunks' results once
    the budget is spent. A chunked search equals the unchunked one. On
    CUDA the scan kernel's grouped form takes every k: it decodes each
    probed list once for a group of the queries that probe it (past k =
    256 each pair's distances go to a scratch and are selected once); its
    per-pair form, by name up to k = 1024, keeps a LUT of pq_dim x
    2^pq_bits float32 entries in shared memory (pq_dim = 64 at 8 bits
    uses 64 KB)."""
    p = params or SearchParams()
    q = torch.as_tensor(queries).to(device=index.device, dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "bad query shape %s", tuple(q.shape))
    expects(index.size > 0, "index is empty")
    expects(algo in ("auto", "pallas", "plain"),
            "unknown ivf_pq algo %r", algo)
    mode = _lut_mode(p.lut_dtype)
    if index.per_cluster and mode == "int8":
        mode = "bf16"     # the JAX gather path's int8 for per-cluster books
    n_probes = min(p.n_probes, index.n_lists)
    pen = survivors = None
    sizes = index.sizes_dev
    if filter is not None:
        fd, n_probes, survivors = filter_policy.plan_ivf(
            index, filter, n_probes, k, "ivf_pq")
        if fd is not None and fd.use_brute:
            return filter_policy.survivor_brute_ivf(
                index, reconstruct, q, k, filter, None, query_chunk, res)
        pen = _penalty(index, filter)
        sizes = torch.where(survivors > 0, sizes, 0).to(torch.int32)
    mt = index.metric
    metric = "ip" if mt is DistanceType.InnerProduct else "l2"
    plain = algo == "plain"
    scan = ivf_pq_scan_plain if plain else ivf_pq_scan
    book = lut_codebook(index.codebooks, mode)

    def one(qc: torch.Tensor, _s0: int = 0):
        q_rot = qc @ index.rotation.T
        probed = coarse_probe(q_rot, index.centers_rot, n_probes, metric,
                              index.center_norms, survivors,
                              SelectAlgo.TOPK if plain else SelectAlgo.AUTO)
        vals, rows = scan(index.codes, index.row_norms, index.centers_rot,
                          book, probed, index.offsets_dev, sizes, q_rot, k,
                          metric, pen, per_cluster=index.per_cluster)
        ids = torch.where(rows >= 0,
                          index.source_ids[rows.clamp_min(0).long()], -1)
        return _postprocess(mt, vals), ids

    chunk = query_chunks(q.shape[0], query_chunk, res,
                         workspace_chunk_bytes(res)
                         // (n_probes * index.rot_dim * 8))
    if chunk:
        return run_query_chunks(one, q, chunk, res)
    return one(q)


def reconstruct(index: Index, row_ids) -> torch.Tensor:
    """Decode rows back to approximate input-space vectors by physical row
    id (ivf_pq helpers reconstruct_list_data): the row's rotated center
    plus its decoded residual (through the row's list's codebook for
    ``PER_CLUSTER``), rotated back. A row's list is the one whose capacity
    span holds it, slack rows included, as the JAX package decodes them."""
    rid = torch.as_tensor(row_ids).to(device=index.device,
                                      dtype=torch.int64).reshape(-1)
    cap = index.codes.shape[0]
    expects(rid.numel() == 0 or (int(rid.min()) >= 0
                                 and int(rid.max()) < cap),
            "row_ids out of range [0, %d)", cap)
    labels = span_labels(np.diff(index.list_offsets), index.device)[rid]
    codes = index.codes[rid].long()                     # (r, pq_dim)
    books = (labels[:, None] if index.per_cluster
             else torch.arange(index.pq_dim, device=index.device)[None, :])
    decoded = index.codebooks[books, codes]             # (r, pq_dim, pq_len)
    y_rot = index.centers_rot[labels] + decoded.reshape(rid.numel(), -1)
    return y_rot @ index.rotation


def health(index: Index, sample: int = 256) -> dict:
    """Index health report, as the JAX package's: list-size skew, the PQ
    geometry and the sampled codeword utilization (the share of a
    subspace's 2^pq_bits codewords that the sampled real rows use: a
    small share means a collapsed codebook, which caps every list scan's
    resolution)."""
    report = {
        "family": "ivf_pq", "n": int(index.size), "dim": int(index.dim),
        "metric": index.metric.name,
        "lists": list_skew(index.list_sizes),
        "pq": {"pq_dim": int(index.pq_dim), "pq_bits": int(index.pq_bits),
               "book_size": int(index.pq_book_size),
               "rot_dim": int(index.rot_dim),
               "codebook_kind": index.codebook_kind.name,
               "compression": round(
                   index.dim * 4.0 / max(index.pq_dim, 1), 1)},
    }
    cap = int(index.codes.shape[0])
    if cap:
        rows = torch.as_tensor(health_sample_rows(cap, sample),
                               device=index.device)
        codes = index.codes[rows][index.source_ids[rows] >= 0]
        if codes.numel():
            codes = codes.cpu().numpy()
            used = np.array([np.unique(codes[:, s]).size
                             for s in range(codes.shape[1])], np.float64)
            # utilization saturates at the sample size on tiny samples:
            # the bound keeps the number readable
            denom = min(index.pq_book_size, codes.shape[0])
            report["pq"]["codeword_utilization"] = {
                "mean": round(float(used.mean() / denom), 4),
                "min": round(float(used.min() / denom), 4),
                "sampled_rows": int(codes.shape[0])}
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


def pack_codes(codes: np.ndarray, pq_bits: int) -> np.ndarray:
    """Bit-pack (n, pq_dim) byte codes → (n, ceil(pq_dim·pq_bits/8))
    bytes, each code's most significant bit first, each row padded to
    whole bytes (the JAX package's file layout; at 8 bits the codes as
    they are)."""
    codes = np.asarray(codes, np.uint8)
    if pq_bits == 8:
        return np.ascontiguousarray(codes)
    n, pq_dim = codes.shape
    bits = np.unpackbits(codes[:, :, None], axis=2,
                         count=8)[:, :, 8 - pq_bits:]
    flat = bits.reshape(n, pq_dim * pq_bits)
    flat = np.pad(flat, ((0, 0), (0, cdiv(pq_dim * pq_bits, 8) * 8
                                  - flat.shape[1])))
    return np.packbits(flat, axis=1)


def unpack_codes(packed: np.ndarray, pq_dim: int, pq_bits: int
                 ) -> np.ndarray:
    """Inverse of :func:`pack_codes`."""
    packed = np.asarray(packed, np.uint8)
    if pq_bits == 8:
        return np.ascontiguousarray(packed[:, :pq_dim])
    flat = np.unpackbits(packed, axis=1)[:, : pq_dim * pq_bits]
    bits = flat.reshape(packed.shape[0], pq_dim, pq_bits)
    weights = (1 << np.arange(pq_bits - 1, -1, -1)).astype(np.uint32)
    return (bits * weights).sum(axis=2).astype(np.uint8)


def save(index: Index, path) -> None:
    """Write the index in the JAX package's file format (kind "ivf_pq",
    version 1): meta ``metric``, ``pq_bits``, ``codebook_kind``,
    ``pq_dim``; arrays ``codes`` (:func:`pack_codes`), ``source_ids``,
    ``centers_rot``, ``codebooks``, ``rotation`` and ``list_offsets``,
    the lists packed with no slack. Byte-equal to the JAX package's file
    of the same index."""
    codes, ids = gather_dense((index.codes, index.source_ids),
                              index.list_offsets, index.list_sizes)
    save_arrays(
        path, "ivf_pq", _SERIAL_VERSION,
        {"metric": index.metric.value, "pq_bits": index.pq_bits,
         "codebook_kind": index.codebook_kind.value,
         "pq_dim": index.pq_dim},
        {"codes": pack_codes(codes.cpu().numpy(), index.pq_bits),
         "source_ids": ids, "centers_rot": index.centers_rot,
         "codebooks": index.codebooks, "rotation": index.rotation,
         "list_offsets": dense_offsets(index.list_sizes)})


def load(path, device=None) -> Index:
    """Read an IVF-PQ file of either package onto ``device`` (the CUDA card
    by default), either codebook kind; the lists keep the file's dense
    layout."""
    _, version, meta, arrs = load_arrays(path, "ivf_pq")
    expects(version == _SERIAL_VERSION, "unsupported version %d", version)
    mt = DistanceType(meta["metric"])
    expects(mt in _METRICS, "ivf_pq with metric %s is not ported yet",
            mt.name)
    dev = resolve_device(device)
    codes = unpack_codes(arrs.pop("codes"), meta["pq_dim"], meta["pq_bits"])
    offsets = np.asarray(arrs["list_offsets"], np.int64)
    return Index(device_tensor(codes, dev),
                 device_tensor(arrs["source_ids"], dev),
                 *(device_tensor(arrs[a], dev)
                   for a in ("centers_rot", "codebooks", "rotation")),
                 offsets, np.diff(offsets), mt, meta["pq_bits"],
                 CodebookGen(meta["codebook_kind"]))
