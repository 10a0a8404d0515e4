"""Measured engine selection: counterpart of ``raft_tpu/ops/autotune.py``
(``shape_bucket``, ``lookup``, ``record``, ``forget``, ``entries``,
``measure``, ``measure_throughput``, ``measure_value_read_wall``,
``tune_best``, ``TimingUnreliableError``, ``cache_path``, ``load_cache``,
``save_cache``).

A verdict is the winner of a race between candidate engines on the
device in use, cached under a key that names the card
(``torch.cuda.get_device_name``), the family and the log2-bucketed
shape, in this process and in a file that later processes read. Callers
consult :func:`lookup` (never measures) and race through
:func:`tune_best`.

Where the port differs from the JAX package:

* A candidate that raises makes :func:`tune_best` raise. JAX skips it;
  here no kernel failure may hide behind a verdict, so a caller leaves a
  candidate that cannot serve the shape out *before* the race, by an
  explicit capability check.
* :func:`measure` is JAX's per-call-synchronised median, or with
  ``value_read`` each call closed by a host read of its output's first
  element. JAX's guards against a remote backend that replays results
  (input perturbation, the re-measure through a fresh executable) have
  no counterpart on a local card. The plausibility floor stays
  (``suspect_floor_s``): a median below it is measured once more, and a
  second median below it raises :class:`TimingUnreliableError`, which
  :func:`tune_best` lets through like any other failure (JAX instead
  returns the first such candidate unrecorded).
* The on-disk cache is the port's own: ``RAFT_TPU_TORCH_AUTOTUNE_CACHE``
  names its JSON file (default ``$XDG_CACHE_HOME/raft_tpu_torch/
  autotune.json``, ``~/.cache`` without XDG; ``""`` keeps verdicts in
  the process). Sharing JAX's file would let each package's
  :func:`save_cache` rewrite it from its own memory; the keys name the
  card in any case.
* ``record`` has no ``persist=False``: JAX keeps guard demotions off the
  disk with it, and the port has no guards (no fallback may hide a
  kernel), so every verdict persists.

The file is read once per path (the first :func:`lookup`, :func:`record`
or :func:`entries` after the variable names it) and rewritten whole on
every :func:`record` and :func:`forget`, through a temporary file and
``os.replace``, so a reader never sees half a file. A file that cannot be
read or written gives a warning and the cache carries on in memory.
"""
from __future__ import annotations

import json
import os
import statistics
import time
import warnings
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from ..core.errors import expects

__all__ = ["shape_bucket", "lookup", "record", "forget", "entries",
           "measure", "measure_throughput", "measure_value_read_wall",
           "tune_best", "cache_path", "load_cache", "save_cache",
           "TimingUnreliableError"]


class TimingUnreliableError(RuntimeError):
    """A median below the caller's plausibility floor on two measurements
    in a row: no honest number exists, so none is recorded."""


_MEM_CACHE: Dict[str, str] = {}
# the file whose verdicts _MEM_CACHE holds (None: none read yet)
_LOADED_FROM: Optional[str] = None


def cache_path() -> Optional[str]:
    """The verdict file: ``RAFT_TPU_TORCH_AUTOTUNE_CACHE``, else
    ``$XDG_CACHE_HOME/raft_tpu_torch/autotune.json``; None when the
    variable is set to ``""`` (no persistence)."""
    p = os.environ.get("RAFT_TPU_TORCH_AUTOTUNE_CACHE")
    if p == "":
        return None
    if p:
        return p
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "raft_tpu_torch", "autotune.json")


def load_cache() -> None:
    """Merge the verdict file into the in-process cache, once per path
    (a verdict already in memory wins). An unreadable file warns."""
    global _LOADED_FROM
    p = cache_path()
    if p is None or p == _LOADED_FROM:
        return
    _LOADED_FROM = p
    if not os.path.exists(p):
        return
    try:
        with open(p) as f:
            disk = json.load(f)
        if not isinstance(disk, dict):
            raise ValueError("not a JSON object")
    except (OSError, ValueError) as e:
        warnings.warn(f"autotune cache {p} unreadable: {e}", stacklevel=2)
        return
    for k, v in disk.items():
        _MEM_CACHE.setdefault(str(k), str(v))


def save_cache() -> None:
    """Write every verdict in memory to the verdict file (a temporary
    file, then ``os.replace``). An unwritable path warns."""
    p = cache_path()
    if p is None:
        return
    tmp = f"{p}.tmp{os.getpid()}"
    try:
        os.makedirs(os.path.dirname(p) or ".", exist_ok=True)
        with open(tmp, "w") as f:
            json.dump(_MEM_CACHE, f, indent=1, sort_keys=True)
        os.replace(tmp, p)
    except OSError as e:
        warnings.warn(f"autotune cache {p} unwritable: {e}", stacklevel=2)


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
    load_cache()
    return _MEM_CACHE.get(key)


def record(key: str, choice: str) -> None:
    """Record ``choice`` as the verdict for ``key``, in memory and in the
    verdict file."""
    load_cache()
    _MEM_CACHE[key] = choice
    save_cache()


def entries() -> Dict[str, str]:
    """A copy of every verdict, the file's included."""
    load_cache()
    return dict(_MEM_CACHE)


def forget(key: str) -> None:
    """Drop the verdict for ``key``, from memory and from the file."""
    load_cache()
    if _MEM_CACHE.pop(key, None) is not None:
        save_cache()


def _sync(args) -> None:
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)
            return


def _first_leaf(out) -> Optional[torch.Tensor]:
    """The first tensor of a (nested) tuple, list or dict output."""
    if isinstance(out, torch.Tensor):
        return out
    items = out.values() if isinstance(out, dict) else (
        out if isinstance(out, (tuple, list)) else ())
    for item in items:
        leaf = _first_leaf(item)
        if leaf is not None:
            return leaf
    return None


def _fold(out) -> torch.Tensor:
    """The first element of ``out``'s first tensor as a float32 scalar on
    its device (0 where it is not finite): a value that exists only once
    the call that made it has run."""
    leaf = _first_leaf(out)
    expects(leaf is not None and leaf.numel() > 0,
            "a value-read timing needs a tensor output")
    x = leaf.reshape(-1)[0].to(torch.float32)
    return torch.where(torch.isfinite(x), x, torch.zeros_like(x))


def _timed_reps(fn, args, reps: int, value_read: bool) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        if value_read:
            _fold(out).item()
        else:
            _sync(args)
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def _floor_checked(run, what: str, suspect_floor_s: float) -> float:
    """``run()``'s median, measured once more when it falls below
    ``suspect_floor_s`` (0: no floor); a second one below it raises
    :class:`TimingUnreliableError`, else the larger of the two counts."""
    med = run()
    if suspect_floor_s and med < suspect_floor_s:
        again = run()
        if again < suspect_floor_s:
            raise TimingUnreliableError(
                f"{what} {again:.3g} s a call below the plausibility floor "
                f"{suspect_floor_s:.3g} s twice")
        med = max(med, again)
    return med


def measure(fn: Callable, *args, reps: int = 5, out0=None,
            suspect_floor_s: float = 0.0, value_read: bool = False
            ) -> float:
    """Median seconds a call of ``fn(*args)``, the card synchronised after
    every call (a call's time is its whole work, not its enqueue), or with
    ``value_read`` each call closed by a host read of its output's first
    element. A first call warms up unless ``out0`` (its output) says one
    was made. ``suspect_floor_s``: a per-call plausibility floor
    (module docstring)."""
    if out0 is None:
        fn(*args)
        _sync(args)
    return _floor_checked(lambda: _timed_reps(fn, args, reps, value_read),
                          "median", suspect_floor_s)


def measure_throughput(fn: Callable, *args, depth: int = 6, reps: int = 3,
                       out0=None, suspect_floor_s: float = 0.0) -> float:
    """Steady-state seconds a call with ``depth`` calls in flight: each of
    ``reps`` windows enqueues ``depth`` calls back to back and ends with
    one ``torch.cuda.synchronize``, so one call's launches overlap the
    last one's work (the reference harness's ``items_per_second``);
    median over the windows, per call. A first call warms up unless
    ``out0`` says one was made; ``suspect_floor_s`` as :func:`measure`'s.
    """
    if out0 is None:
        fn(*args)
        _sync(args)

    def windows() -> float:
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(depth):
                fn(*args)
            _sync(args)
            ts.append((time.perf_counter() - t0) / depth)
        return statistics.median(ts)

    return _floor_checked(windows, "throughput", suspect_floor_s)


def measure_value_read_wall(fn: Callable, inputs: Sequence, *args,
                            warm_input=None) -> float:
    """Wall seconds a call over ``inputs`` with a value-read close: each
    input is its call's first argument, the calls run back to back, the
    first element of every output is folded into one device scalar, and
    the window closes with one host read (``.item()``) of it, which
    cannot return before every call feeding it has run. ``warm_input``
    (not in ``inputs``) warms up outside the window."""
    expects(len(inputs) > 0, "measure_value_read_wall needs inputs")
    if warm_input is not None:
        _fold(fn(warm_input, *args)).item()
    t0 = time.perf_counter()
    acc = None
    for inp in inputs:
        s = _fold(fn(inp, *args))
        acc = s if acc is None else acc + s
    acc.item()
    return (time.perf_counter() - t0) / len(inputs)


def tune_best(key: str, candidates: Mapping[str, Callable], *args,
              reps: int = 5, force: bool = False,
              suspect_floor_s: float = 0.0, value_read: bool = False
              ) -> Tuple[str, Dict[str, float]]:
    """Time every candidate on ``args`` (:func:`measure`, with
    ``suspect_floor_s`` and ``value_read``), record the fastest under
    ``key`` and return (winner, {name: median seconds}). Without
    ``force`` a recorded verdict among the candidates is returned at
    once, with no timings. A candidate that raises is not skipped: the
    exception propagates (:class:`TimingUnreliableError` too)."""
    if not force:
        hit = lookup(key)
        if hit in candidates:
            return hit, {}
    expects(len(candidates) > 0, "autotune %s: no candidate to race", key)
    timings = {name: measure(fn, *args, reps=reps,
                             suspect_floor_s=suspect_floor_s,
                             value_read=value_read)
               for name, fn in candidates.items()}
    winner = min(timings, key=timings.get)
    record(key, winner)
    return winner, timings
