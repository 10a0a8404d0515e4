"""IVF-PQ index: counterpart of ``raft_tpu/neighbors/ivf_pq.py``
(``CodebookGen``, ``IndexParams``, ``SearchParams``, ``Index``,
``make_rotation_matrix``, ``build``, ``extend``, ``search``).

Everything lives in rotated space, as in the JAX package: the dataset is
rotated once at build and the queries once at search (an orthogonal
rotation keeps L2 and inner products), and the coarse centers, residuals
and codebooks stay in rotated coordinates. Lists are contiguous row
ranges of one cluster-sorted (rows, pq_dim) uint8 code matrix
(``_list_layout``), one byte per subspace for any ``pq_bits`` in 4..8.

Build: balanced k-means on a strided subsample (the coarse quantizer),
the rotation, then one codebook per subspace trained by fixed-iteration
Lloyd on the subsample's rotated residuals (labels from
``kmeans_balanced.predict``); ``extend`` assigns every row to its nearest
*rotated* center by a plain argmin, encodes its residual and scatters the
lists. The decoded row norms ``||c_l + dec_i||²`` are computed once, when
an :class:`Index` is made.

Search: rotate the queries, the coarse probe on the rotated centers
(``torch.matmul`` + kernel K1 on CUDA), then the PQ list scan (kernel K4
on CUDA, with the K1 merge) in the expanded form of the JAX package's
Pallas scan, with the codebook rounded to the LUT mode
(``SearchParams.lut_dtype``). ``algo="plain"`` asks for the plain
versions on any device. The JAX package's gather engine
(``algo="xla"``), which rounds the *LUT* to bf16 and sums it in bf16,
is not ported as an engine: under ``lut_dtype=float32`` both compute the
same distances up to float32 rounding.

A filter removes rows through an additive penalty row in sorted row
order, and lists with no surviving row are pruned from the probe — the
JAX package's search under ``filter_policy.suspended()``. Not ported yet:
``PER_CLUSTER`` codebooks, ``list_growth != 1.0`` and ``extend`` into a
non-empty index, ``build_from_batches``, host streaming, save/load and the
adaptive filter policy. Every matrix product runs in full float32
(``torch.backends.cuda.matmul.allow_tf32`` False).
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
from ..core.errors import expects
from ..distance.distance_types import DistanceType, canonical_metric
from ..distance.fused_l2_nn import fused_l2_nn_argmin
from ..matrix.select_k import SelectAlgo
from ..ops.ivf_pq_scan import (decoded_row_norms, ivf_pq_scan,
                               ivf_pq_scan_plain, lut_codebook,
                               pq_chunk_rows)
from ..ops.ivf_scan import coarse_probe
from ..utils import cdiv, resolve_device, run_query_chunks
from ._list_layout import scatter_build
from .brute_force import _postprocess
from .ivf_flat import _filter_rows

__all__ = ["CodebookGen", "IndexParams", "SearchParams", "Index",
           "make_rotation_matrix", "build", "extend", "search"]

_METRICS = (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
            DistanceType.InnerProduct)


class CodebookGen(enum.Enum):
    """ivf_pq_types.hpp:43 codebook_gen."""

    PER_SUBSPACE = 0
    PER_CLUSTER = 1


@dataclasses.dataclass
class IndexParams:
    """Mirror of ivf_pq::index_params (ivf_pq_types.hpp:110)."""

    n_lists: int = 1024
    metric: DistanceType | str = DistanceType.L2Expanded
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8                   # 4..8
    pq_dim: int = 0                    # 0 → dim/4 rounded to a multiple of 8
    codebook_kind: CodebookGen = CodebookGen.PER_SUBSPACE
    force_random_rotation: bool = False
    seed: int = 0
    list_growth: float = 1.0           # only 1.0 is ported


@dataclasses.dataclass
class SearchParams:
    """Mirror of ivf_pq::search_params (ivf_pq_types.hpp:146).
    ``lut_dtype`` picks the codebook the ``q·decode`` term reads:
    ``torch.float32`` exact, ``torch.bfloat16`` (default, the fp16-LUT
    role) or ``torch.int8`` (per-subspace symmetric quantization, the
    fp8-LUT role); the names "float32", "bfloat16", "int8" and their
    aliases work too."""

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
    (n_lists, rot_dim); ``codebooks``: (pq_dim, 2^pq_bits, pq_len);
    ``rotation``: (rot_dim, dim) with orthonormal columns;
    ``list_offsets`` (n_lists + 1,) and ``list_sizes`` (n_lists,) host
    int64 arrays. Made once here: ``row_norms`` (the decoded squared row
    norms, from the unrounded codebook), ``center_norms`` and the int32
    ``offsets_dev``/``sizes_dev`` on the index's device. ``build_seconds``
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
    row_norms: torch.Tensor = dataclasses.field(init=False, repr=False)
    center_norms: torch.Tensor = dataclasses.field(init=False, repr=False)
    offsets_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    sizes_dev: torch.Tensor = dataclasses.field(init=False, repr=False)
    build_seconds: dict = dataclasses.field(init=False, repr=False,
                                            default_factory=dict)

    def __post_init__(self):
        expects(self.codebook_kind is CodebookGen.PER_SUBSPACE,
                "PER_CLUSTER codebooks are not ported yet")
        expects(self.codebooks.shape[1] == 1 << self.pq_bits,
                "codebooks hold %d entries, pq_bits=%d needs %d",
                self.codebooks.shape[1], self.pq_bits, 1 << self.pq_bits)
        dev = self.codes.device
        self.row_norms = decoded_row_norms(self.codes, self.centers_rot,
                                           self.codebooks, self.list_offsets)
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
        return self.codebooks.shape[0]

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


def _encode(resid_rot: torch.Tensor, codebooks: torch.Tensor
            ) -> torch.Tensor:
    """Residuals (n, rot_dim) → (n, pq_dim) uint8 codes: per-subspace
    argmin of ``||r_s||² - 2 r_s·cb + ||cb||²`` (ties to the lower code)."""
    pq_dim, _, pq_len = codebooks.shape
    slices = resid_rot.reshape(resid_rot.shape[0], pq_dim, pq_len)
    d2 = ((slices * slices).sum(dim=2)[:, :, None]
          - 2.0 * torch.einsum("nsl,sbl->nsb", slices, codebooks)
          + (codebooks * codebooks).sum(dim=2)[None, :, :])
    return d2.argmin(dim=2).to(torch.uint8)


def build(dataset, params: IndexParams | None = None, device=None) -> Index:
    """Train the coarse quantizer, the rotation and the codebooks, then
    encode and pack the dataset (detail/ivf_pq_build.cuh:1729), on
    ``device`` (the CUDA card by default). The index's ``build_seconds``
    splits the time into "coarse_kmeans", "codebooks" and "encode"."""
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
    expects(p.codebook_kind is CodebookGen.PER_SUBSPACE,
            "PER_CLUSTER codebooks are not ported yet")
    expects(p.list_growth == 1.0, "list_growth != 1.0 is not ported yet")
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
    codebooks = _kmeans_fixed(
        t_resid.reshape(-1, pq_dim, pq_len).transpose(0, 1),
        1 << p.pq_bits, p.kmeans_n_iters,
        kmeans_balanced._generator(p.seed + 1, dev))
    laps.mark("codebooks")

    index = Index(torch.zeros((0, pq_dim), dtype=torch.uint8, device=dev),
                  torch.zeros((0,), dtype=torch.int32, device=dev),
                  centers_rot, codebooks, rotation,
                  np.zeros(p.n_lists + 1, np.int64),
                  np.zeros(p.n_lists, np.int64), mt, p.pq_bits)
    index = extend(index, dataset)
    laps.mark("encode")
    index.build_seconds = laps.seconds
    return index


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Fill an empty index with vectors (ids 0..n-1 unless ``new_ids``):
    assign each to its nearest rotated center, encode its residual, and
    scatter the lists (ivf_pq_build.cuh:1550), in batches of
    :func:`pq_chunk_rows` rows. Adding to a non-empty index is not ported
    yet."""
    expects(index.size == 0,
            "extend of a non-empty index is not ported yet")
    dev = index.device
    x = torch.as_tensor(new_vectors).to(device=dev, dtype=torch.float32)
    expects(x.dim() == 2 and x.shape[1] == index.dim, "dim mismatch")
    n_new = x.shape[0]
    if new_ids is None:
        new_ids = torch.arange(n_new, dtype=torch.int32, device=dev)
    else:
        new_ids = torch.as_tensor(new_ids).to(device=dev, dtype=torch.int32)
    batch = pq_chunk_rows(index.pq_dim, index.pq_book_size)
    cr = index.centers_rot
    labels, codes = [], []
    for b0 in range(0, n_new, batch):
        xr = x[b0 : b0 + batch] @ index.rotation.T
        # nearest rotated center == nearest center (orthogonal rotation)
        lb = fused_l2_nn_argmin(xr, cr)[0]
        codes.append(_encode(xr - cr[lb], index.codebooks))
        labels.append(lb)
    labels = torch.cat(labels) if labels else torch.zeros(
        (0,), dtype=torch.int64, device=dev)
    codes = torch.cat(codes) if codes else index.codes
    (codes, ids), offsets, sizes = scatter_build(
        labels, [codes, new_ids], [0, -1], index.n_lists)
    return Index(codes, ids, index.centers_rot, index.codebooks,
                 index.rotation, offsets, sizes, index.metric, index.pq_bits,
                 index.codebook_kind)


def search(index: Index, queries, k: int,
           params: SearchParams | None = None,
           filter: Optional[Bitset] = None,  # noqa: A002 - reference name
           query_chunk: int = 0, algo: str = "auto"
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LUT-based approximate top-k (detail/ivf_pq_search.cuh:731) →
    (distances (m, k), int32 source ids (m, k)); slots past the
    candidates hold (+inf, -1) (-inf for inner product).

    ``algo``: "auto" / "pallas" — K1 + K4 on CUDA, their plain versions on
    the CPU; "plain" — the plain versions on any device. ``query_chunk``:
    run queries in chunks of this many rows. On CUDA the scan kernel takes
    k <= 1024: its grouped form (k <= 512) decodes each probed list once
    for a group of the queries that probe it; its per-pair form (k > 512)
    keeps a LUT of pq_dim x 2^pq_bits float32 entries in shared memory
    (pq_dim = 64 at 8 bits uses 64 KB)."""
    p = params or SearchParams()
    q = torch.as_tensor(queries).to(device=index.device, dtype=torch.float32)
    expects(q.dim() == 2 and q.shape[1] == index.dim,
            "bad query shape %s", tuple(q.shape))
    expects(index.size > 0, "index is empty")
    expects(algo in ("auto", "pallas", "plain"),
            "unknown ivf_pq algo %r", algo)
    mode = _lut_mode(p.lut_dtype)
    if 0 < query_chunk < q.shape[0]:
        return run_query_chunks(
            lambda qc, _s0: search(index, qc, k, p, filter, 0, algo),
            q, query_chunk)
    n_probes = min(p.n_probes, index.n_lists)
    mt = index.metric
    metric = "ip" if mt is DistanceType.InnerProduct else "l2"
    pen = survivors = None
    sizes = index.sizes_dev
    if filter is not None:
        pen, survivors = _filter_rows(index, filter)
        sizes = torch.where(survivors > 0, sizes, 0).to(torch.int32)
    plain = algo == "plain"
    q_rot = q @ index.rotation.T
    probed = coarse_probe(q_rot, index.centers_rot, n_probes, metric,
                          index.center_norms, survivors,
                          SelectAlgo.TOPK if plain else SelectAlgo.AUTO)
    scan = ivf_pq_scan_plain if plain else ivf_pq_scan
    vals, rows = scan(index.codes, index.row_norms, index.centers_rot,
                      lut_codebook(index.codebooks, mode), probed,
                      index.offsets_dev, sizes, q_rot, k, metric, pen)
    ids = torch.where(rows >= 0, index.source_ids[rows.clamp_min(0).long()],
                      -1)
    return _postprocess(mt, vals), ids
