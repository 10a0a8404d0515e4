"""Build and load the port's CUDA kernels.

Each ``raft_tpu_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface and loaded
with ``ctypes`` (no PyTorch headers, so a build takes seconds). Libraries
go to ``build/kernels/`` at the root of the checkout, named by a hash of
the sources and flags, and are built at first use; :func:`build` starts
one ``nvcc`` per missing source, all at once. Nothing here runs when the
module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from ..core.errors import RaftError

__all__ = ["SOURCES", "STORE_SOURCES", "SMEM_PER_BLOCK", "build",
           "library", "check", "stream_of"]

SMEM_PER_BLOCK = 232_448   # bytes of shared memory one block may use (sm_90)
_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD = Path(__file__).resolve().parents[2] / "build" / "kernels"
# K2 and K3 are one library a store (csrc/fused_knn*.cu, ivf_flat_scan*.cu),
# K5 and K6 one a store mode (graph_expand*.cu, cagra_fused*.cu), so that
# their builds run side by side
STORE_SOURCES = {
    "fused_knn": {s: "fused_knn" if s == "float32" else f"fused_knn_{s}"
                  for s in ("float32", "bfloat16", "int8", "uint8",
                            "int4")},
    "ivf_flat_scan": {s: "ivf_flat_scan" if s == "float32"
                      else f"ivf_flat_scan_{s}"
                      for s in ("float32", "bfloat16", "int8", "uint8")},
    "graph_expand": {"dense": "graph_expand", "int4": "graph_expand_int4",
                     "pq": "graph_expand_pq"},
    "cagra_fused": {"dense": "cagra_fused", "int4": "cagra_fused_int4"},
}
SOURCES = (*STORE_SOURCES["fused_knn"].values(),
           *STORE_SOURCES["ivf_flat_scan"].values(), "select_k",
           "ivf_pq_scan", *STORE_SOURCES["graph_expand"].values(),
           *STORE_SOURCES["cagra_fused"].values(), "ring_topk")
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
# C signature of each library's entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "select_k": {
        "raft_select_k_warp": ([_P, _I, _I, _I, _I, _P, _P, _P], _I),
        "raft_select_k_radix": ([_P, _I, _I, _I, _I, _P, _P, _P], _I),
    },
    **{lib: {
        "raft_fused_knn": ([_P] * 6 + [_I] * 7 + [_P] * 3, _I),
        "raft_fused_knn_wide": ([_P] * 6 + [_I] * 8 + [_P] * 4, _I),
        "raft_fused_knn_wide_scratch": ([_I] * 3, ctypes.c_size_t),
        "raft_fused_knn_slots": ([_I, _I, _I, _I], _I),
    } for lib in STORE_SOURCES["fused_knn"].values()},
    **{lib: {
        "raft_ivf_flat_scan_group": ([_P] * 12 + [_I] * 6 + [_P] * 3, _I),
        "raft_ivf_flat_scan_pair": ([_P] * 10 + [_I] * 5 + [_P] * 3, _I),
        "raft_ivf_flat_scan_group_plan": ([_I, _I, _P], _I),
        "raft_ivf_flat_scan_wide": ([_P] * 13 + [_I] * 7 + [_P] * 3, _I),
        "raft_ivf_flat_scan_wide_scratch": ([_I, _I, _I, _P], _I),
    } for lib in STORE_SOURCES["ivf_flat_scan"].values()},
    "ivf_pq_scan": {
        "raft_ivf_pq_scan_group": ([_P] * 14 + [_I] * 9 + [_P] * 3, _I),
        "raft_ivf_pq_scan_group_per_cluster": (
            [_P] * 14 + [_I] * 9 + [_P] * 3, _I),
        "raft_ivf_pq_scan_pair": ([_P] * 10 + [_I] * 7 + [_P] * 3, _I),
        "raft_ivf_pq_scan_group_plan": ([_I, _I, _P], _I),
        "raft_ivf_pq_scan_group_scratch": ([_I, _I, _I, _P], _I),
    },
    **{lib: {
        "raft_graph_expand": ([_P] * 5 + [_I] * 8 + [_P] * 3, _I),
        "raft_graph_expand_info": ([_I] * 3 + [_P], _I),
        "raft_graph_expand_smem": ([_I] * 2, ctypes.c_size_t),
    } for lib in ("graph_expand", "graph_expand_int4")},
    "graph_expand_pq": {
        "raft_graph_expand_pq": ([_P] * 7 + [_I] * 10 + [_P] * 3, _I),
        "raft_graph_expand_pq_info": ([_I] * 5 + [_P], _I),
        "raft_graph_expand_pq_smem": ([_I] * 4, ctypes.c_size_t),
    },
    **{lib: {
        "raft_cagra_fused": ([_P] * 7 + [_I] * 11 + [_P] * 6, _I),
        "raft_cagra_fused_smem": ([_I] * 6, ctypes.c_size_t),
        "raft_cagra_fused_info": ([_I] * 6 + [_P], _I),
    } for lib in STORE_SOURCES["cagra_fused"].values()},
    "ring_topk": {
        "raft_merge_step": ([_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I,
                             _P, _P, _P, _I, _P], _I),
        "raft_ring_topk_capacity": ([_I, _I], _I),
        "raft_ring_enable_peer": ([_I, _I], _I),
        "raft_ring_topk": ([_P, _P] + [_I] * 10 + [_P] * 2, _I),
    },
}

_libs: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RaftError("nvcc not found: the CUDA kernels are built on a "
                        "machine with the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for src in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return _BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together. ``verbose`` adds
    ``-Xptxas -v`` (registers, shared memory, spills). Returns the
    compiler's output per library built; raises on the first failure."""
    procs = {}
    try:
        for name in names:
            out = _target(name)
            if out.exists():
                continue
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                   "-o", str(tmp), str(_CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, out)
        logs = {}
        for name, (proc, tmp, out) in procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise RaftError(f"nvcc failed on {name}.cu:\n{text}")
            os.replace(tmp, out)
            logs[name] = text
        return logs
    finally:
        for proc, _tmp, _out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(_target(name)))
        for fn, (argtypes, restype) in _SIGNATURES[name].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _libs[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error code."""
    if status != 0:
        raise RaftError(f"{what} kernel failed: CUDA error {status}")


def stream_of(t) -> int:
    """PyTorch's current CUDA stream on ``t``'s device, as an integer."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
