"""Fault probes at named sites: counterpart of ``raft_tpu/core/faults.py``
(``InjectedFault``, ``InjectedCrash``, ``Fault``, ``inject``, ``fired``,
``check``, ``sleep_if``, ``corrupt``, ``crash``, ``cut``, ``active``,
``seen_sites``, ``reload_env``, ``reset_stats``).

A probe asks whether a fault of its kind is armed for its site; the
durable writers (``core/serialize.py``, ``core/wal.py``,
``neighbors/mutable.py``) carry probes, so that every failure path they
promise to survive can be driven on demand. Faults are armed from the
environment, under the JAX package's name, or by :func:`inject`::

    RAFT_TPU_FAULTS='kind@pattern[:count][=value],...'

* ``kind``: what the probe asks about — ``io_error``, ``corrupt_bytes``
  (one bit of the written bytes flipped at the offset ``value``, else
  the middle byte), ``crash_point`` (the process dies at the site:
  :class:`InjectedCrash`), ``wal_torn_tail`` (a write cut to a prefix of
  ``value`` bytes, else half, then the process dies), ``slow_dispatch``
  (a sleep of ``value`` seconds); kinds are open strings;
* ``pattern``: an fnmatch pattern over the site's name (default ``*``);
* ``count``: fire at most this many times (default: every time);
* ``value``: the kind's argument.

A probe costs one check of two lists when nothing is armed.
:class:`InjectedCrash` is a ``BaseException``, not an ``Exception``: no
``except Exception`` in the port may survive it, as no handler runs in a
process that dies.

A fire counts under ``faults.fired.<kind>.<site>`` and a fault's first
fire records a ``fault_injected`` event (``_emit_fire``). Not ported
yet: the timed ``Scenario`` drills, which need the soak harness.
"""
from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import os
import threading
import time
from typing import List, Optional

from .errors import RaftError

__all__ = ["InjectedFault", "InjectedCrash", "Fault", "inject", "fired",
           "check", "sleep_if", "corrupt", "crash", "cut", "active",
           "seen_sites", "reload_env", "reset_stats"]


class InjectedFault(RaftError):
    """Raised by a probe when an armed fault fires at its site."""

    def __init__(self, kind: str, site: str):
        self.kind = kind
        self.site = site
        super().__init__(f"injected fault {kind!r} at site {site!r}")


class InjectedCrash(BaseException):
    """The process dying at a named crash point. Not an ``Exception``, so
    that no containment in the port runs a handler for it: the drill
    catches it at the top and recovers from what reached the disk."""

    def __init__(self, kind: str, site: str):
        self.kind = kind
        self.site = site
        super().__init__(f"injected crash {kind!r} at site {site!r}")


@dataclasses.dataclass
class Fault:
    """One armed fault: kind, site pattern, budget and argument."""

    kind: str
    pattern: str = "*"
    count: Optional[int] = None     # None: fires every time
    value: Optional[str] = None     # the kind's argument
    fires: int = 0                  # times it has fired

    def matches(self, kind: str, site: str) -> bool:
        return (self.kind == kind
                and (self.count is None or self.fires < self.count)
                and fnmatch.fnmatch(site, self.pattern))


_lock = threading.Lock()
_injected: List[Fault] = []         # armed by inject()
_env_faults: List[Fault] = []       # armed by RAFT_TPU_FAULTS
_env_loaded = False
_seen_sites: set = set()            # sites that probed while armed


def _parse_spec(spec: str) -> Fault:
    """``kind@pattern[:count][=value]`` → :class:`Fault`."""
    kind, _, rest = spec.strip().partition("@")
    if not kind:
        raise ValueError(f"bad fault spec {spec!r}: empty kind")
    pattern = rest or "*"
    value = None
    if "=" in pattern:
        pattern, _, value = pattern.partition("=")
    count = None
    if ":" in pattern:
        pattern, _, c = pattern.partition(":")
        count = int(c)
    return Fault(kind, pattern or "*", count, value)


def _load_env() -> None:
    global _env_loaded
    if _env_loaded:
        return
    with _lock:
        if _env_loaded:
            return
        spec = os.environ.get("RAFT_TPU_FAULTS", "")
        _env_faults.clear()
        for part in spec.split(","):
            if part.strip():
                _env_faults.append(_parse_spec(part))
        _env_loaded = True


def reload_env() -> None:
    """Read ``RAFT_TPU_FAULTS`` again (after a change of the variable)."""
    global _env_loaded
    with _lock:
        _env_loaded = False
    _load_env()


@contextlib.contextmanager
def inject(kind: str, pattern: str = "*", count: Optional[int] = None,
           value=None):
    """Arm a fault for the block; probes on every thread see it."""
    f = Fault(kind, pattern, count, None if value is None else str(value))
    with _lock:
        _injected.append(f)
    try:
        yield f
    finally:
        with _lock:
            _injected.remove(f)


def fired(kind: str, site: str) -> Optional[Fault]:
    """The first armed fault of ``kind`` whose pattern matches ``site``,
    one firing taken from its budget; None when none fires. Nothing is
    locked when nothing is armed."""
    _load_env()
    if not _injected and not _env_faults:
        return None
    hit = None
    first = False
    with _lock:
        _seen_sites.add(site)
        for f in _injected + _env_faults:
            if f.matches(kind, site):
                f.fires += 1
                first = f.fires == 1
                hit = f
                break
    if hit is not None:
        _emit_fire(kind, site, first)
    return hit


def _emit_fire(kind: str, site: str, first: bool) -> None:
    """Telemetry of a fired fault: the counter ``faults.fired.<kind>.
    <site>`` on every fire, a ``fault_injected`` event (stamped with the
    bound trace IDs) on the fault's first only, so that a drill firing on
    every batch does not churn the bounded ring. Outside the probe lock;
    never raises."""
    try:
        if first:
            from . import events

            events.record("fault_injected", site, fault_kind=kind)
        from ..serve import metrics

        metrics.counter(f"faults.fired.{kind}.{site}").inc()
    except Exception:  # noqa: BLE001 - telemetry must not break injection
        pass


def check(kind: str, site: str) -> None:
    """Raise :class:`InjectedFault` when a fault of ``kind`` fires here."""
    if fired(kind, site) is not None:
        raise InjectedFault(kind, site)


def sleep_if(site: str, default_s: float = 0.01) -> None:
    """``slow_dispatch`` probe: sleep the armed seconds here."""
    f = fired("slow_dispatch", site)
    if f is not None:
        time.sleep(float(f.value) if f.value else default_s)


def corrupt(site: str, data):
    """``corrupt_bytes`` probe: ``data`` (bytes-like) with one bit flipped
    at the armed offset, else at the middle byte; ``data`` itself (no
    copy) when nothing fires or it is empty."""
    f = fired("corrupt_bytes", site)
    if f is None or not data:
        return data
    off = int(f.value) if f.value else len(data) // 2
    off = max(0, min(off, len(data) - 1))
    out = bytearray(data)
    out[off] ^= 0x01
    return bytes(out)


def crash(site: str) -> None:
    """``crash_point`` probe: raise :class:`InjectedCrash` here when
    armed."""
    if fired("crash_point", site) is not None:
        raise InjectedCrash("crash_point", site)


def cut(site: str, data: bytes) -> bytes:
    """``wal_torn_tail`` probe: a prefix of ``data`` (the armed byte count,
    else half; at least 1 byte and short of the whole) when armed — the
    caller writes it and dies; ``data`` itself when nothing fires."""
    f = fired("wal_torn_tail", site)
    if f is None or not data:
        return data
    off = int(f.value) if f.value else len(data) // 2
    return bytes(data[: max(1, min(off, len(data) - 1))])


def active() -> List[Fault]:
    """The armed faults (``inject`` first, then the environment's)."""
    _load_env()
    with _lock:
        return list(_injected + _env_faults)


def seen_sites() -> set:
    """The sites that probed while a fault was armed."""
    with _lock:
        return set(_seen_sites)


def reset_stats() -> None:
    """Forget the seen sites and every armed fault's firings."""
    with _lock:
        _seen_sites.clear()
        for f in _injected + _env_faults:
            f.fires = 0
