"""Measured engine selection: counterpart of ``raft_tpu/ops/autotune.py``
(``shape_bucket``, ``lookup``, ``record``, ``measure``, ``tune_best``).

A verdict is the winner of a race between candidate engines on the
device in use, cached in this process under a key that names the card
(``torch.cuda.get_device_name``), the family and the log2-bucketed
shape. Callers consult :func:`lookup` (never measures) and race through
:func:`tune_best`.

Where the port differs from the JAX package:

* A candidate that raises makes :func:`tune_best` raise. JAX skips it;
  here no kernel failure may hide behind a verdict, so a caller leaves a
  candidate that cannot serve the shape out *before* the race, by an
  explicit capability check.
* :func:`measure` is JAX's per-call-synchronised median alone. JAX's
  guards against a remote backend that replays results (input
  perturbation, the plausibility floor and its re-measure through a
  fresh executable) have no counterpart on a local card.
* The cache is in-process only; JAX's on-disk persistence
  (``RAFT_TPU_AUTOTUNE_CACHE``) is not ported.
"""
from __future__ import annotations

import statistics
import time
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from ..core.errors import expects

__all__ = ["shape_bucket", "lookup", "record", "measure", "tune_best"]

_MEM_CACHE: Dict[str, str] = {}


def _log2_bucket(x: int) -> int:
    return max(0, int(x - 1).bit_length())


def shape_bucket(family: str, device, **dims) -> str:
    """Cache key: device type + card name + family + dims. Integer dims
    bucket by log2; strings pass through as categorical tags (a storage
    dtype, a metric name)."""
    dev = torch.device(device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else dev.type)
    parts = [dev.type, kind.replace(" ", "_"), family]
    parts += [f"{name}{_log2_bucket(v) if isinstance(v, int) else v}"
              for name, v in sorted(dims.items())]
    return ":".join(parts)


def lookup(key: str) -> Optional[str]:
    """The recorded verdict for ``key``, or None. Never measures."""
    return _MEM_CACHE.get(key)


def record(key: str, choice: str) -> None:
    """Record ``choice`` as the verdict for ``key``."""
    _MEM_CACHE[key] = choice


def _sync(args) -> None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)
            return


def measure(fn: Callable, *args, reps: int = 5, out0=None) -> float:
    """Median seconds a call of ``fn(*args)``, the card synchronised after
    every call (a call's time is its whole work, not its enqueue). A
    first call warms up unless ``out0`` (its output) says one was made."""
    if out0 is None:
        fn(*args)
        _sync(args)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def tune_best(key: str, candidates: Mapping[str, Callable], *args,
              reps: int = 5, force: bool = False
              ) -> Tuple[str, Dict[str, float]]:
    """Time every candidate on ``args`` (:func:`measure`), record the
    fastest under ``key`` and return (winner, {name: median seconds}).
    Without ``force`` a recorded verdict among the candidates is
    returned at once, with no timings. A candidate that raises is not
    skipped: the exception propagates."""
    if not force:
        hit = lookup(key)
        if hit in candidates:
            return hit, {}
    expects(len(candidates) > 0, "autotune %s: no candidate to race", key)
    timings = {name: measure(fn, *args, reps=reps)
               for name, fn in candidates.items()}
    winner = min(timings, key=timings.get)
    record(key, winner)
    return winner, timings
