"""Startup warmup for the bucket ladder and the first-call watch:
counterpart of ``raft_tpu/serve/warmup.py`` (``CompileCounter``,
``count_compilations``, ``warmup``, ``install_recompile_watch``,
``compile_context``; ``warmup_sharded`` is not ported yet).

The JAX package counts XLA compilations, which an unwarmed shape pays on
its first request. The port compiles nothing per shape; what a first
call costs it instead is a kernel library built or loaded
(``ops/_cuda.py::library``), an engine race timed
(``ops/autotune.py::measure``), cuBLAS's handle and workspace on the
first product, and the caching allocator's growth. The first two are
counted, through ``ops._cuda.note_first_call`` (the observer slot both
call); the last two show only in a first call's time, which
:func:`warmup` measures shape by shape.

* :func:`install_recompile_watch` subscribes ONCE per process: every
  counted first call increments ``serve.compiles``; one inside a serving
  dispatch (a non-warmup :func:`compile_context` label, which the batcher
  sets around each dispatch) also increments ``serve.recompiles`` and
  records a ``first_call`` event. ``serve.recompiles`` reads 0 after a
  clean warmup.
* :func:`count_compilations` counts them for the extent of a block, so a
  load test can assert that after warmup a mixed stream of requests pays
  no first call.
* :func:`warmup` dispatches a zero batch through the search closure at
  every (query bucket x k bucket) shape, waits for each on a CUDA event,
  and keeps each shape's first-call seconds in the gauges
  ``<name>.warmup.first_call_s.<rows>x<k>``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import List

import torch

from ..core.errors import RaftError, expects
from ..ops import _cuda

__all__ = ["CompileCounter", "count_compilations", "warmup",
           "warmup_sharded", "install_recompile_watch", "compile_context"]


class CompileCounter:
    """Mutable count of first calls inside a :func:`count_compilations`
    block."""

    def __init__(self):
        self.count = 0


_watch_lock = threading.Lock()
_watch_subs: List[CompileCounter] = []
_watch_installed = False
_ctx = threading.local()        # .label (str), .warmup (bool)


@contextlib.contextmanager
def compile_context(label: str, warmup: bool = False):
    """Label first calls observed by the watch for the extent of the
    block (thread-local: the batcher's worker labels its own
    dispatches). ``warmup=True`` exempts them from ``serve.recompiles``."""
    prev = (getattr(_ctx, "label", None), getattr(_ctx, "warmup", False))
    _ctx.label, _ctx.warmup = label, warmup
    try:
        yield
    finally:
        _ctx.label, _ctx.warmup = prev


def _observe(kind: str, name: str) -> None:
    with _watch_lock:
        for c in _watch_subs:
            c.count += 1
    label = getattr(_ctx, "label", None)
    in_warmup = bool(getattr(_ctx, "warmup", False))
    try:
        from . import metrics as _metrics

        _metrics.counter("serve.compiles").inc()
        # a first call on a serving dispatch is the rare degradation
        # signal: only those earn an event and serve.recompiles (a warmup
        # sweep or an index build mid-serve pays many legitimate ones)
        if label is not None and not in_warmup:
            from ..core import events as _events

            _events.record("first_call", label, cost=kind, what=name,
                           warmup=False)
            _metrics.counter("serve.recompiles").inc()
    except Exception:  # noqa: BLE001 - telemetry must not break a call
        pass


def install_recompile_watch() -> None:
    """Subscribe the first-call watch (idempotent; module docstring)."""
    global _watch_installed
    with _watch_lock:
        if _watch_installed:
            return
        _cuda.first_call_observers.append(_observe)
        _watch_installed = True


@contextlib.contextmanager
def count_compilations():
    """Count first calls during the block (yields a
    :class:`CompileCounter`); installs the watch on first use. Nested and
    concurrent blocks each see every first call."""
    install_recompile_watch()
    counter = CompileCounter()
    with _watch_lock:
        _watch_subs.append(counter)
    try:
        yield counter
    finally:
        with _watch_lock:
            _watch_subs.remove(counter)


def _wait_for(out) -> None:
    """Wait until the tensors of a search's output are computed: one CUDA
    event recorded on each card's current stream after them, and waited
    on (no device-wide synchronize). CPU tensors are ready already."""
    devs = {t.device for t in (out if isinstance(out, (tuple, list))
                               else (out,))
            if isinstance(t, torch.Tensor) and t.is_cuda}
    for dev in devs:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


def warmup(search_fn, ladder, dim: int, dtype=torch.float32, registry=None,
           name: str = "serve", prepare=None, engines=None,
           shapes=None) -> int:
    """Dispatch a zero batch through ``search_fn`` at every ladder shape
    and wait for each result. Returns the number of counted first calls
    the sweep made (0 when the process is already warm). Records
    ``<name>.warmup.shapes`` (gauge), ``<name>.warmup.compiles``
    (counter) and each shape's first-call seconds
    (``<name>.warmup.first_call_s.[<engine>:]<rows>x<k>``).

    ``prepare``: a zero-argument callable run before the sweep for index
    caches that must not land on the first request (e.g. ``lambda:
    cagra.prepare_traversal(index)``). ``engines``: ``{engine_name:
    search_fn}``, each swept across the whole ladder (``search_fn`` may
    then be None). ``shapes``: an explicit ``[(query_bucket, k_bucket),
    ...]`` subset instead of the ladder's cross product (a tenant swap
    warms only the shapes its tenant has served)."""
    from . import metrics as _metrics

    reg = registry or _metrics.default_registry
    if prepare is not None:
        prepare()
    if engines is not None:
        fns = dict(engines)
    else:
        expects(search_fn is not None,
                "warmup needs a search_fn or an engines mapping")
        fns = {"": search_fn}
    if shapes is None:
        sweep = [(mb, kb) for mb in ladder.query_buckets
                 for kb in ladder.k_buckets]
    else:
        sweep = [(int(mb), int(kb)) for mb, kb in shapes]
    n_shapes = 0
    with count_compilations() as cc:
        for eng, fn in fns.items():
            tag = f"{eng}:" if eng else ""
            for mb, kb in sweep:
                q = torch.zeros((mb, int(dim)), dtype=dtype)
                with compile_context(f"{name}:warmup:{tag}{mb}x{kb}",
                                     warmup=True):
                    t0 = time.perf_counter()
                    _wait_for(fn(q, kb))
                    dt = time.perf_counter() - t0
                reg.gauge(f"{name}.warmup.first_call_s.{tag}{mb}x{kb}"
                          ).set(dt)
                n_shapes += 1
    reg.gauge(f"{name}.warmup.shapes").set(n_shapes)
    reg.counter(f"{name}.warmup.compiles").inc(cc.count)
    return cc.count


def warmup_sharded(*_args, **_kwargs) -> int:
    """The sharded ladder's warmup (JAX's ``warmup_sharded``) needs
    ``sharded_ann.warmup_searchers`` and ``widen_rungs``, which are not
    ported yet."""
    raise RaftError("serve.warmup.warmup_sharded is not ported yet: it "
                    "needs sharded_ann.warmup_searchers and widen_rungs")
