"""K1 against ``torch.topk`` across (rows, n, k): counterpart of
``raft_tpu/bench/select_k_sweep.py`` (``GRID``, ``run``).

Every point of :data:`GRID` (the JAX sweep's: brute-force merge shapes,
IVF coarse shapes, wide rows) runs ``matrix.select_k.tune_select_k``,
per-call-synchronised medians of 5, and records its winner: a
calibration record (``select_k``'s AUTO keeps K1 on the card whatever it
says) and the library column of K1's row in the kernel table. The
document names the card (``device``: ``gpu:`` and
``torch.cuda.get_device_name``) and its power limit
(``nvidia-smi``'s ``power.limit``); on the CPU ``device`` is ``cpu``, the
limit null, and the times the CPU's.

Run: ``python -m raft_tpu_torch.bench.select_k_sweep [out.json]`` on the
card; the document goes to :data:`DEFAULT_OUT` unless a path is given
(the repository root's ``bench_select_k_sweep.json`` is the JAX
package's TPU record and is never written here).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Optional

import torch

from ..matrix.select_k import tune_select_k
from ..utils import resolve_device

__all__ = ["GRID", "DEFAULT_OUT", "run"]

GRID = [
    # (rows, n, k): brute-force merge shapes, IVF coarse shapes, wide rows
    (128, 1024, 10),
    (1024, 1024, 64),
    (128, 16384, 10),
    (1024, 16384, 32),
    (128, 65536, 10),
    (512, 65536, 32),
    (64, 262144, 10),
    (64, 262144, 128),
]

DEFAULT_OUT = os.path.join("build", "bench_select_k_sweep.json")


def _power_limit(dev: torch.device) -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` gives it."""
    if dev.type != "cuda":
        return None
    out = subprocess.run(
        ["nvidia-smi", f"--id={dev.index or 0}", "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip()


def run(out_path: Optional[str] = DEFAULT_OUT, device=None,
        reps: int = 5) -> dict:
    """Sweep :data:`GRID` on ``device`` (the card by default), write the
    document to ``out_path`` (None: write nothing) and return it."""
    dev = resolve_device(device)
    results = []
    for rows, n, k in GRID:
        winner, timings = tune_select_k(rows, n, k, reps=reps, device=dev)
        entry = {"rows": rows, "n": n, "k": k, "winner": winner,
                 "ms": {name: t * 1e3 for name, t in timings.items()}}
        results.append(entry)
        print(f"# rows={rows} n={n} k={k}: {winner} {entry['ms']}",
              file=sys.stderr, flush=True)
    doc = {
        "device": (f"gpu:{torch.cuda.get_device_name(dev)}"
                   if dev.type == "cuda" else dev.type),
        "power_limit": _power_limit(dev),
        "methodology": (f"tune_select_k: per-call-synchronised median of "
                        f"{reps}; kpass = K1 (csrc/select_k.cu), topk = "
                        "torch.topk"),
        "results": results,
    }
    if out_path:
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(doc, f, indent=1)
    return doc


if __name__ == "__main__":
    print(json.dumps(run(sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT)))
