"""Dataset IO and ground truth for the bench harness: counterpart of
``raft_tpu/bench/datasets.py``.

Formats (raft-ann-bench get_dataset / split_groundtruth):
- ``.fbin`` / ``.ibin``: big-ann-benchmarks binary, an int32 (n, d)
  header then row-major float32 / int32 rows;
- ann-benchmarks ``.hdf5``: train / test / neighbors datasets (``h5py``
  is imported only when one is asked for);
- synthetic specs ``blobs-{n}x{d}`` and ``uniform-{n}x{d}``, made on the
  device from a seed by ``raft_tpu_torch.random``.
"""
from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.errors import expects
from ..utils import resolve_device

__all__ = ["read_fbin", "write_fbin", "read_ibin", "write_ibin",
           "iter_fbin", "load_dataset", "resolve_lane_dataset",
           "generate_groundtruth"]


def _read_bin(path, dtype) -> np.ndarray:
    with open(path, "rb") as f:
        n, d = np.fromfile(f, np.int32, 2)
        return np.fromfile(f, dtype, int(n) * int(d)).reshape(int(n), int(d))


def _write_bin(path, arr, dtype) -> None:
    if isinstance(arr, torch.Tensor):
        arr = arr.cpu().numpy()
    arr = np.ascontiguousarray(arr, dtype)
    with open(path, "wb") as f:
        np.asarray(arr.shape, np.int32).tofile(f)
        arr.tofile(f)


def read_fbin(path) -> np.ndarray:
    return _read_bin(path, np.float32)


def write_fbin(path, arr) -> None:
    _write_bin(path, arr, np.float32)


def read_ibin(path) -> np.ndarray:
    return _read_bin(path, np.int32)


def write_ibin(path, arr) -> None:
    _write_bin(path, arr, np.int32)


def iter_fbin(path, batch_rows: int = 1 << 17):
    """Stream an fbin file in row batches through a memory map: host
    memory stays O(batch_rows · d)."""
    with open(path, "rb") as f:
        n, d = np.fromfile(f, np.int32, 2)
    n, d = int(n), int(d)
    mm = np.memmap(path, np.float32, mode="r", offset=8, shape=(n, d))
    for b0 in range(0, n, batch_rows):
        yield np.asarray(mm[b0:b0 + batch_rows])


_SYNTH = re.compile(r"^(blobs|uniform)-(\d+)x(\d+)$")


def load_dataset(
    name: str,
    dataset_dir: Optional[str] = None,
    n_queries: int = 10_000,
    seed: int = 1234,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, Optional[torch.Tensor], str]:
    """→ (base (n, d) float32, queries, gt int32 ids or None, metric), on
    ``device`` (the CUDA card by default).

    ``name``: a synthetic spec (``blobs-1000000x128``: max(16, d // 2)
    blobs of std 3.0, centers uniform in ±10, base and queries split from
    one draw; ``uniform-...``: uniform in [0, 1)), an ann-benchmarks HDF5
    basename (``{name}.hdf5`` in ``dataset_dir``) or a big-ann directory
    (``{name}/base.fbin``, ``query.fbin``, optional
    ``groundtruth.neighbors.ibin``). The metric is inferred: "-angular" →
    cosine, "-dot" → inner product, else sqeuclidean (the raft-ann-bench
    mapping)."""
    from .. import random as rrnd

    dev = resolve_device(device)
    dataset_dir = dataset_dir or os.environ.get("RAFT_TPU_DATASET_DIR",
                                                "datasets")
    t = lambda a, dt: torch.from_numpy(np.asarray(a, dt)).to(dev)  # noqa: E731
    m = _SYNTH.match(name)
    if m:
        kind, n, d = m.group(1), int(m.group(2)), int(m.group(3))
        rng = rrnd.RngState(seed, device=dev)
        if kind == "blobs":
            base, _ = rrnd.make_blobs(n + n_queries, d,
                                      n_clusters=max(16, d // 2),
                                      cluster_std=3.0, rng=rng)
        else:
            base = rrnd.uniform(rng, (n + n_queries, d))
        return base[:n], base[n:], None, "sqeuclidean"

    h5 = Path(dataset_dir) / f"{name}.hdf5"
    if h5.exists():
        try:
            import h5py
        except ImportError as e:
            raise ImportError(f"reading {h5} needs h5py, which is not "
                              "installed") from e
        with h5py.File(h5, "r") as f:
            base = t(f["train"], np.float32)
            queries = t(f["test"], np.float32)
            gt = t(f["neighbors"], np.int32) if "neighbors" in f else None
        # ann-benchmarks: -angular ground truth is cosine distance, -dot
        # inner product
        if name.endswith("-angular"):
            metric = "cosine"
        elif name.endswith("-dot"):
            metric = "inner_product"
        else:
            metric = "sqeuclidean"
        return base, queries, gt, metric

    dd = Path(dataset_dir) / name
    if (dd / "base.fbin").exists():
        gtp = dd / "groundtruth.neighbors.ibin"
        return (t(read_fbin(dd / "base.fbin"), np.float32),
                t(read_fbin(dd / "query.fbin"), np.float32),
                t(read_ibin(gtp), np.int32) if gtp.exists() else None,
                "sqeuclidean")

    expects(False, "dataset %r not found (no synthetic match, %s, or %s)",
            name, str(h5), str(dd / "base.fbin"))


# big-ann directory names taken as "the" SIFT-1M corpus, in order
_LANE_FBIN_NAMES = ("sift-1m", "sift1m", "sift")
_LANE_HDF5_NAME = "sift-128-euclidean"


def resolve_lane_dataset(
    dataset_dir: Optional[str] = None,
    budget_rows: int = 100_000,
) -> Tuple[str, str]:
    """→ (dataset name for :func:`load_dataset`, kind) of the standing
    Pareto lane: a big-ann fbin directory of SIFT-1M, else its
    ann-benchmarks HDF5, else ``blobs-{budget_rows}x128`` (SIFT's dim).
    ``kind`` ("fbin", "hdf5" or "synthetic-fallback") goes into the
    lane's artifact, so a fallback run is never taken for a SIFT
    number."""
    dataset_dir = dataset_dir or os.environ.get("RAFT_TPU_DATASET_DIR",
                                                "datasets")
    root = Path(dataset_dir)
    for cand in _LANE_FBIN_NAMES:
        if (root / cand / "base.fbin").exists():
            return cand, "fbin"
    if (root / f"{_LANE_HDF5_NAME}.hdf5").exists():
        return _LANE_HDF5_NAME, "hdf5"
    return f"blobs-{int(budget_rows)}x128", "synthetic-fallback"


def generate_groundtruth(base, queries, k: int = 100,
                         metric: str = "sqeuclidean", batch: int = 10_000,
                         device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN ground truth by the port's brute force (K2 + K1 on
    CUDA), ``batch`` queries at a time → (distances (m, k), int32 ids
    (m, k)) on ``device`` (the CUDA card by default)."""
    from ..neighbors import brute_force

    dev = resolve_device(device)
    index = brute_force.build(base, metric, device=dev)
    q = torch.as_tensor(queries).to(device=dev, dtype=torch.float32)
    outs_d, outs_i = [], []
    for b0 in range(0, q.shape[0], batch):
        d, i = brute_force.search(index, q[b0:b0 + batch], k)
        outs_d.append(d)
        outs_i.append(i)
    return torch.cat(outs_d), torch.cat(outs_i)
