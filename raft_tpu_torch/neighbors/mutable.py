"""Crash-safe mutable index over the four families: counterpart of
``raft_tpu/neighbors/mutable.py`` (``MutableIndex``, ``create``,
``recover``, ``health``, ``make_searcher``, ``ops_snapshot``,
``CRASH_POINTS``, ``MERGE_SITE``).

A mutable index is:

* a **sealed segment**: one brute-force, IVF-Flat, IVF-PQ or CAGRA index
  over the corpus as of the last merge, its source ids the slots of the
  snapshot corpus;
* a **delta**: a brute-force index over the upserted rows, its capacity
  a power of two (at least 64), rebuilt from the host rows after each
  mutation (kernel K2 on the card);
* **tombstones**: a :class:`~raft_tpu_torch.core.bitset.Bitset` over the
  sealed slots, the sealed search's filter, and one over the delta's
  rows. Both searches run under ``filter_policy.suspended()`` (the prune
  only), and the parts are merged by ``brute_force.knn_merge_parts``
  (K1). A user filter is refused: the tombstones own the filter.

Durability: :meth:`MutableIndex.upsert` and :meth:`~MutableIndex.delete`
append to the WAL (``core/wal.py``) and fsync before they return — the
return is the ack. :meth:`MutableIndex.recover` replays the manifest's
logs over its snapshot (a torn tail cut; mid-log corruption raises),
rebuilds the sealed segment from the snapshot when its file fails its
CRC, and removes what an interrupted merge left. The files — manifest
and snapshot (``core/serialize``'s RAFTTPU2), segments (the families'
``save``), logs — are the JAX package's, so either package recovers a
directory the other wrote.

:meth:`MutableIndex.merge` folds the delta and the tombstones into a new
generation: the log is rotated first (the manifest names both logs until
the flip), the live rows are snapshotted under the lock at a watermark,
the segment is built off the lock (CAGRA warm-started through
``build_knn_graph(init_graph=...)`` from the surviving graph rows),
checked (the family's ``health`` and sampled distance recall against an
exact brute-force answer at or above
``RAFT_TPU_MUTABLE_MERGE_RECALL_FLOOR``), pre-warmed at the last served
shape, written, and flipped by one atomic manifest replace; mutations
that raced the build are tombstoned again in the new segment, and the
old generation is retired. A merge that fails, misses its deadline or
its check is abandoned with the live index as it was, and the index's
merge breaker, private to this module (the JAX package's
``guarded_call`` cadence: ``RAFT_TPU_GUARD_PROBE_AFTER_S`` 30 s,
doubling to ``RAFT_TPU_GUARD_MAX_BACKOFF_S`` 600 s), answers
``"backoff"`` until its next probe. ``merge`` keeps the seconds of its
stages in ``last_merge["stages_s"]``.

Crash drills: the ``crash_point`` probes of :data:`CRASH_POINTS` (and
``wal_torn_tail`` at the log's append) raise ``InjectedCrash``, which
passes every ``except`` here.

``create`` / ``recover`` place the segments and the delta on ``device``
(the card unless the caller asks for the CPU). Telemetry, as the JAX
package's: the events ``upsert``, ``delete``, ``merge_started`` /
``merge_committed`` / ``merge_abandoned`` and ``wal_recovered`` (site:
the index's name), the counters ``mutable.upserts``, ``.deletes``,
``.merges.committed``, ``.merges.abandoned``, ``.recoveries``, and the
``tracing.annotate`` spans ``raft_tpu::mutable::{create, recover,
upsert, delete, search}``. Not ported: the sampled device sync of the
pre-warm (``mutable.prewarm.device_s``); the merge's stages are timed
with the device synchronised instead (``last_merge["stages_s"]``).
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import events, faults, tracing, wal as wal_mod
from ..core.bitset import Bitset
from ..core.errors import CorruptIndexError, RaftError, expects
from ..core.serialize import fsync_dir, load_arrays, save_arrays
from ..distance.distance_types import (DistanceType, canonical_metric,
                                       is_min_close)
from ..ops import filter_policy
from ..utils import env_float, env_int, resolve_device

__all__ = ["MutableIndex", "create", "recover", "health", "make_searcher",
           "ops_snapshot", "CRASH_POINTS", "MERGE_SITE"]

_MANIFEST = "MANIFEST"
_SERIAL_VERSION = 1

# the background merge's breaker site (the JAX package's name)
MERGE_SITE = "mutable.merge"

# every process-death site the crash drill covers; the tests sweep the
# source for faults.crash(...) probes and fail on one missing here
CRASH_POINTS = (
    wal_mod.APPEND_SITE,          # mid-append (core/wal.py)
    "mutable.merge.build",        # mid-merge, nothing written yet
    "mutable.merge.pre_flip",     # new generation written, manifest old
    "mutable.merge.post_flip",    # manifest flipped, old one not retired
)

_FAMILIES = ("brute_force", "ivf_flat", "ivf_pq", "cagra")

# the live mutable indexes (weak: a dropped index drops out)
_LIVE: "weakref.WeakSet[MutableIndex]" = weakref.WeakSet()

# the breaker's clock (the tests step it)
_clock = time.monotonic


class _Breaker:
    """A merge's circuit breaker: closed → open on a failed merge
    (backoff ``RAFT_TPU_GUARD_PROBE_AFTER_S``), half-open for one probe
    merge once the backoff has passed, open again with the backoff
    doubled (at most ``RAFT_TPU_GUARD_MAX_BACKOFF_S``) if the probe
    fails, closed if it commits."""

    def __init__(self):
        self.lock = threading.Lock()
        self.state = "closed"
        self.reason = ""
        self.opened_at = 0.0
        self.backoff_s = 0.0
        self.next_probe_at = 0.0
        self.opens = self.probes = self.closes = 0
        self.probing = False

    def call(self, fn):
        """``fn()``, or ``"backoff"`` while open; a failure of ``fn``
        (an ``Exception``) opens the breaker and gives ``"backoff"``."""
        probing = False
        with self.lock:
            if self.state != "closed":
                if (self.state == "open" and _probe_after_s() > 0
                        and not self.probing
                        and _clock() >= self.next_probe_at):
                    self.state, self.probing = "half_open", True
                    self.probes += 1
                    probing = True
                else:
                    return "backoff"
        try:
            out = fn()
        except Exception as e:  # noqa: BLE001 - a failed merge backs off
            with self.lock:
                if self.state == "half_open":
                    self.backoff_s = min(self.backoff_s * 2.0,
                                         _max_backoff_s())
                else:
                    self.backoff_s = _probe_after_s()
                now = _clock()
                self.state, self.probing = "open", False
                self.reason = f"{type(e).__name__}: {e}"
                self.opened_at, self.next_probe_at = now, now + self.backoff_s
                self.opens += 1
            return "backoff"
        except BaseException:
            if probing:   # neither success nor failure: re-probe at once
                with self.lock:
                    self.state, self.probing = "open", False
            raise
        if probing:
            with self.lock:
                self.state, self.probing, self.reason = "closed", False, ""
                self.backoff_s = 0.0
                self.closes += 1
        return out

    def snapshot(self) -> dict:
        with self.lock:
            return {"state": self.state, "reason": self.reason,
                    "backoff_s": self.backoff_s,
                    "next_probe_in_s": (max(0.0, self.next_probe_at
                                            - _clock())
                                        if self.state != "closed" else 0.0),
                    "opens": self.opens, "probes": self.probes,
                    "closes": self.closes}


def _probe_after_s() -> float:
    return env_float("RAFT_TPU_GUARD_PROBE_AFTER_S", 30.0)


def _max_backoff_s() -> float:
    return env_float("RAFT_TPU_GUARD_MAX_BACKOFF_S", 600.0)


def _family_mod(family: str):
    from . import brute_force, cagra, ivf_flat, ivf_pq

    mods = {"brute_force": brute_force, "ivf_flat": ivf_flat,
            "ivf_pq": ivf_pq, "cagra": cagra}
    expects(family in mods, "unknown sealed family %r (one of %s)",
            family, "/".join(_FAMILIES))
    return mods[family]


def _family_params(mod, family: str, fparams: dict, mt, n: int):
    """The family's IndexParams from the plain ``family_params`` dict
    (unknown keys refused); ``n_lists`` at most the corpus's rows."""
    if family == "brute_force":
        return None
    fields = {f.name for f in dataclasses.fields(mod.IndexParams)}
    bad = set(fparams) - fields
    expects(not bad, "unknown %s family_params: %s", family, sorted(bad))
    p = mod.IndexParams(**fparams)
    p.metric = mt
    if hasattr(p, "n_lists"):
        p.n_lists = max(1, min(p.n_lists, n))
    return p


def _pad_k(vals: torch.Tensor, ids: torch.Tensor, k: int, bad: float):
    """A (m, k') top-k' block padded to k columns with (bad, -1)."""
    pad = k - vals.shape[1]
    if pad <= 0:
        return vals, ids
    m = vals.shape[0]
    return (torch.cat([vals, torch.full((m, pad), bad, dtype=vals.dtype,
                                        device=vals.device)], 1),
            torch.cat([ids, torch.full((m, pad), -1, dtype=ids.dtype,
                                       device=ids.device)], 1))


def _host_rows(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class MutableIndex:
    """One mutable index: sealed segment, delta, tombstones and WAL.

    Made by :meth:`create` (a new directory) or :meth:`recover` (an
    existing one). Mutations and the merge's flip serialise on one
    re-entrant lock; a search reads a consistent view under it and runs
    outside it."""

    def __init__(self, path: str, family: str, metric: DistanceType,
                 dim: int, family_params: Optional[dict] = None,
                 device=None):
        self.path = os.path.abspath(path)
        self.name = os.path.basename(self.path)
        self.family = family
        self.metric = metric
        self.dim = int(dim)
        self.family_params = dict(family_params or {})
        self.device = resolve_device(device)
        self._mod = _family_mod(family)
        self._lock = threading.RLock()
        # sealed state
        self._sealed = None                       # family Index | None
        self._sealed_ids = np.zeros(0, np.int64)  # slot -> external id
        self._sealed_vecs = np.zeros((0, self.dim), np.float32)
        self._slot_of: Dict[int, int] = {}
        self._alive = np.zeros(0, bool)           # False: tombstoned
        self._n_tomb = 0
        self._sealed_cache: Optional[tuple] = None
        # the delta, capacity-padded
        self._d_vecs = np.zeros((0, self.dim), np.float32)
        self._d_ids = np.zeros(0, np.int64)
        self._d_alive = np.zeros(0, bool)
        self._d_n = 0                             # rows used (dead too)
        self._d_live = 0
        self._d_row_of: Dict[int, int] = {}
        self._delta_cache: Optional[tuple] = None
        # durability
        self._wal: Optional[wal_mod.WriteAheadLog] = None
        self._wal_names: List[str] = []
        self._gen = 0
        self._epoch = 0
        self._next_id = 0
        # the merge
        self._merging = False
        self._during: List[Tuple[str, np.ndarray]] = []
        self._last_merge: Optional[dict] = None
        self._last_shape: Optional[Tuple[int, int]] = None
        self._last_request: Tuple[object, dict] = (None, {})
        self._breaker = _Breaker()
        self._clock = time.monotonic
        self.merge_rows = env_int("RAFT_TPU_MUTABLE_MERGE_ROWS", 65536)
        self.merge_tomb_frac = env_float(
            "RAFT_TPU_MUTABLE_MERGE_TOMB_FRAC", 0.25)
        self.merge_deadline_s = env_float(
            "RAFT_TPU_MUTABLE_MERGE_DEADLINE_S", 0.0)
        self.merge_recall_floor = env_float(
            "RAFT_TPU_MUTABLE_MERGE_RECALL_FLOOR", 0.9)
        _LIVE.add(self)

    @classmethod
    @tracing.annotate("raft_tpu::mutable::create")
    def create(cls, path, dataset=None, ids=None, *,
               family: str = "brute_force", metric="sqeuclidean",
               family_params: Optional[dict] = None,
               dim: Optional[int] = None, device=None) -> "MutableIndex":
        """A new mutable index in directory ``path``. ``dataset`` (n, d)
        seeds the sealed segment, ``ids`` its external ids (default: row
        positions, unique, within int32); with no dataset, ``dim=``
        starts it all-delta. ``family_params``: the sealed family's
        IndexParams fields as a plain dict, kept in the manifest so a
        merge after ``recover`` builds the same segment."""
        path = os.fspath(path)
        os.makedirs(path, exist_ok=True)
        expects(not os.path.exists(os.path.join(path, _MANIFEST)),
                "mutable index already exists at %s (use recover)", path)
        if dataset is None:
            expects(dim is not None and dim > 0, "empty create needs dim=")
            vecs = np.zeros((0, int(dim)), np.float32)
        else:
            vecs = _host_rows(dataset, np.float32)
            expects(vecs.ndim == 2, "dataset must be (n, d)")
        mt = canonical_metric(metric)
        self = cls(path, family, mt, vecs.shape[1], family_params, device)
        n = vecs.shape[0]
        if ids is None:
            sids = np.arange(n, dtype=np.int64)
        else:
            sids = _host_rows(ids, np.int64)
            expects(sids.shape == (n,), "ids must be (n,)")
            expects(np.unique(sids).size == n, "ids must be unique")
        expects(n == 0 or (sids.min() >= 0 and sids.max() < 2 ** 31),
                "external ids must fit int32")
        with self._lock:
            self._install_sealed_locked(
                self._build_segment(vecs) if n else None, sids, vecs)
            self._next_id = int(sids.max()) + 1 if n else 0
            self._gen = 1
            self._epoch = 1
            if self._sealed is not None:
                self._save_segment_of(self._sealed, self._gen)
            self._save_snapshot(self._gen)
            self._wal = wal_mod.WriteAheadLog.create(
                os.path.join(self.path, self._wal_name(self._epoch)))
            self._wal_names = [self._wal_name(self._epoch)]
            self._save_manifest_locked()
        return self

    @classmethod
    @tracing.annotate("raft_tpu::mutable::recover")
    def recover(cls, path, device=None) -> "MutableIndex":
        """Open ``path`` as a restarted process would: the manifest's
        generation, its logs replayed over the snapshot (a torn tail
        cut), the sealed segment rebuilt from the snapshot if its file is
        corrupt, files of an interrupted merge removed. Every acked
        mutation is visible after; :class:`CorruptIndexError` only where
        acked state is damaged."""
        path = os.fspath(path)
        _, _, meta, _ = load_arrays(os.path.join(path, _MANIFEST),
                                    "mutable_manifest")
        fparams = json.loads(meta.get("family_params", "{}"))
        self = cls(path, meta["family"], DistanceType(meta["metric"]),
                   meta["dim"], fparams, device)
        with self._lock:
            self._gen = int(meta["generation"])
            self._epoch = int(meta["epoch"])
            self._next_id = int(meta["next_id"])
            _, _, _, arrs = load_arrays(os.path.join(path, meta["snapshot"]),
                                        "mutable_snapshot")
            vecs = np.asarray(arrs["corpus"],
                              np.float32).reshape(-1, self.dim)
            sids = np.asarray(arrs["ids"], np.int64)
            sealed = None
            rebuilt = False
            if meta["segment"]:
                try:
                    sealed = self._mod.load(os.path.join(path,
                                                         meta["segment"]),
                                            device=self.device)
                except CorruptIndexError:
                    # the segment is derived: the snapshot is the source
                    sealed = self._build_segment(vecs) if len(vecs) else None
                    rebuilt = True
            self._install_sealed_locked(sealed, sids, vecs)
            # the manifest's logs, oldest first; only the last may end in
            # a torn append
            self._wal_names = json.loads(meta["wals"])
            replayed = truncated = 0
            for i, wname in enumerate(self._wal_names):
                last = i == len(self._wal_names) - 1
                records, cut = wal_mod.replay(os.path.join(path, wname),
                                              repair=last,
                                              allow_torn_tail=last)
                truncated += cut
                for kind, rids, rvecs in records:
                    if kind == "upsert":
                        self._apply_upsert_locked(rids, rvecs)
                    else:
                        self._apply_delete_locked(rids)
                    replayed += 1
            self._wal = wal_mod.WriteAheadLog.open(
                os.path.join(path, self._wal_names[-1]))
            if rebuilt and self._sealed is not None:
                self._save_segment_of(self._sealed, self._gen)
            gen = self._gen
        self._housekeep(meta)
        self._event("wal_recovered", generation=gen, records=replayed,
                    truncated_bytes=truncated, segment_rebuilt=rebuilt)
        self._count("mutable.recoveries")
        return self

    # -- files --------------------------------------------------------------
    def _wal_name(self, epoch: int) -> str:
        return f"wal-{epoch:06d}.log"

    def _seg_name(self, gen: int) -> str:
        return f"segment-{gen:06d}.idx"

    def _snap_name(self, gen: int) -> str:
        return f"snapshot-{gen:06d}.idx"

    def _save_segment_of(self, index, gen: int) -> None:
        self._mod.save(index, os.path.join(self.path, self._seg_name(gen)))

    def _save_snapshot(self, gen: int, vecs=None, sids=None) -> None:
        if vecs is None:
            vecs, sids = self._sealed_vecs, self._sealed_ids
        save_arrays(os.path.join(self.path, self._snap_name(gen)),
                    "mutable_snapshot", _SERIAL_VERSION, {"generation": gen},
                    {"corpus": vecs, "ids": sids})

    def _save_manifest_locked(self) -> None:
        g = self._gen
        save_arrays(
            os.path.join(self.path, _MANIFEST), "mutable_manifest",
            _SERIAL_VERSION,
            {"generation": g, "family": self.family,
             "metric": self.metric.value, "dim": self.dim,
             "epoch": self._epoch, "next_id": self._next_id,
             "segment": self._seg_name(g) if self._has_segment(g) else "",
             "snapshot": self._snap_name(g),
             "wals": json.dumps(self._wal_names),
             "family_params": json.dumps(self.family_params)}, {})

    def _has_segment(self, gen: int) -> bool:
        return os.path.exists(os.path.join(self.path, self._seg_name(gen)))

    def _housekeep(self, meta: dict) -> None:
        """Remove generation files the manifest does not name (what a
        merge that died before or after its flip left)."""
        keep = {_MANIFEST, meta["snapshot"], *json.loads(meta["wals"])}
        if meta["segment"]:
            keep.add(meta["segment"])
        for fn in os.listdir(self.path):
            if fn not in keep and fn.startswith(("segment-", "snapshot-",
                                                 "wal-")):
                try:
                    os.unlink(os.path.join(self.path, fn))
                except OSError:
                    pass

    # -- segments -------------------------------------------------------------
    def _build_segment(self, vecs: np.ndarray, warm=None):
        """A sealed family index over ``vecs`` on the device (source ids
        are the slots)."""
        mod = self._mod
        n = len(vecs)
        x = torch.from_numpy(np.ascontiguousarray(vecs)).to(self.device)
        if self.family == "brute_force":
            return mod.build(x, self.metric,
                             dtype=self.family_params.get("dtype",
                                                          "float32"),
                             device=self.device)
        p = _family_params(mod, self.family, self.family_params,
                           self.metric, n)
        if self.family == "cagra" and warm is not None:
            # a merge's rebuild: the kNN graph warm-started from the
            # surviving rows of the previous graph (the exact route
            # ignores it)
            d0 = min(p.intermediate_graph_degree, n - 1)
            degree = min(p.graph_degree, d0)
            knn = mod.build_knn_graph(x, d0, self.metric, p.seed,
                                      algo=p.knn_graph_algo,
                                      nnd_rounds=p.nn_descent_niter,
                                      init_graph=warm, device=self.device)
            graph = mod.optimize(knn, degree)
            seeds = mod.build_covering_seeds(x, p)
            return mod.Index(x, graph, self.metric, seeds)
        return mod.build(x, p, device=self.device)

    def _warm_graph(self, new_ids: np.ndarray, sealed,
                    sealed_ids: np.ndarray) -> Optional[torch.Tensor]:
        """The previous CAGRA graph in the new slots for the warm start:
        surviving neighbors keep their edges, the others are drawn
        uniformly from the new slots (numpy, seed 0, as the JAX
        package draws them). ``sealed`` / ``sealed_ids`` are the
        snapshot taken under the lock."""
        if self.family != "cagra" or sealed is None:
            return None
        g = sealed.graph.cpu().numpy()
        n_new = len(new_ids)
        if n_new < 2:
            return None
        slot2 = {int(e): s for s, e in enumerate(new_ids)}
        old2new = np.full(len(sealed_ids), -1, np.int32)
        for old_slot, ext in enumerate(sealed_ids):
            s = slot2.get(int(ext))
            if s is not None:
                old2new[old_slot] = s
        warm = np.full((n_new, g.shape[1]), -1, np.int32)
        mapped = old2new[np.clip(g, 0, len(old2new) - 1)]
        keep = old2new >= 0
        warm[old2new[keep]] = mapped[keep]
        rng = np.random.default_rng(0)
        fill = rng.integers(0, n_new, warm.shape, dtype=np.int64)
        warm = np.where(warm >= 0, warm, fill).astype(np.int32)
        return torch.from_numpy(warm).to(self.device)

    def _install_sealed_locked(self, sealed, sids: np.ndarray,
                               vecs: np.ndarray) -> None:
        self._sealed = sealed
        self._sealed_ids = np.asarray(sids, np.int64)
        self._sealed_vecs = np.asarray(vecs, np.float32)
        self._slot_of = {int(e): s for s, e in enumerate(self._sealed_ids)}
        self._alive = np.ones(len(self._sealed_ids), bool)
        self._n_tomb = 0
        self._sealed_cache = None

    # -- mutations applied in memory (the live path and the replay) -----------
    def _ensure_delta_cap_locked(self, need: int) -> None:
        cap = len(self._d_ids)
        if need <= cap:
            return
        new_cap = 64
        while new_cap < need:
            new_cap *= 2
        v = np.zeros((new_cap, self.dim), np.float32)
        i = np.full(new_cap, -1, np.int64)
        a = np.zeros(new_cap, bool)
        v[:self._d_n] = self._d_vecs[:self._d_n]
        i[:self._d_n] = self._d_ids[:self._d_n]
        a[:self._d_n] = self._d_alive[:self._d_n]
        self._d_vecs, self._d_ids, self._d_alive = v, i, a

    def _apply_upsert_locked(self, ids: np.ndarray, vecs: np.ndarray) -> None:
        ids = np.asarray(ids, np.int64)
        vecs = np.asarray(vecs, np.float32)
        self._ensure_delta_cap_locked(self._d_n + len(ids))
        for j, ext in enumerate(ids.tolist()):
            slot = self._slot_of.get(ext)
            if slot is not None and self._alive[slot]:
                self._alive[slot] = False       # the sealed copy is stale
                self._n_tomb += 1
            old = self._d_row_of.get(ext)
            if old is not None:
                self._d_alive[old] = False      # so is an older delta copy
                self._d_live -= 1
            row = self._d_n
            self._d_vecs[row] = vecs[j]
            self._d_ids[row] = ext
            self._d_alive[row] = True
            self._d_row_of[ext] = row
            self._d_n += 1
            self._d_live += 1
            self._next_id = max(self._next_id, ext + 1)
        if self._merging:
            self._during.append(("upsert", ids.copy()))
        self._sealed_cache = None
        self._delta_cache = None

    def _apply_delete_locked(self, ids: np.ndarray) -> int:
        ids = np.asarray(ids, np.int64)
        found = 0
        for ext in ids.tolist():
            hit = False
            slot = self._slot_of.get(ext)
            if slot is not None and self._alive[slot]:
                self._alive[slot] = False
                self._n_tomb += 1
                hit = True
            row = self._d_row_of.pop(ext, None)
            if row is not None and self._d_alive[row]:
                self._d_alive[row] = False
                self._d_live -= 1
                hit = True
            found += hit
        if self._merging:
            self._during.append(("delete", ids.copy()))
        self._sealed_cache = None
        self._delta_cache = None
        return found

    # -- telemetry ----------------------------------------------------------
    def _event(self, kind: str, **details) -> None:
        try:
            events.record(kind, self.name, **details)
        except Exception:  # noqa: BLE001 - telemetry must not fail writes
            pass

    def _count(self, name: str, n: int = 1) -> None:
        try:
            from ..serve import metrics

            metrics.counter(name).inc(n)
        except Exception:  # noqa: BLE001
            pass

    # -- the public mutations ------------------------------------------------
    @tracing.annotate("raft_tpu::mutable::upsert")
    def upsert(self, ids, vectors=None) -> np.ndarray:
        """Insert or replace rows → the external ids used (``ids=None``:
        the next ones in sequence; ``upsert(vectors)`` works too). The
        record is in the WAL and fsynced when this returns. A sealed
        row's id is tombstoned there, and an id already in the delta
        replaces its row. An ``upsert`` event and the
        ``mutable.upserts`` counter."""
        if vectors is None:
            ids, vectors = None, ids
        vecs = _host_rows(vectors, np.float32)
        expects(vecs.ndim == 2 and vecs.shape[1] == self.dim,
                "vectors must be (m, %d), got %s", self.dim, vecs.shape)
        with self._lock:
            if ids is None:
                ids = np.arange(self._next_id, self._next_id + len(vecs),
                                dtype=np.int64)
            else:
                ids = _host_rows(ids, np.int64)
                expects(ids.shape == (len(vecs),), "ids must be (m,)")
                expects(len(ids) == 0
                        or (ids.min() >= 0 and ids.max() < 2 ** 31),
                        "external ids must fit int32")
            self._wal.append("upsert", ids, vecs)   # durable before the ack
            self._apply_upsert_locked(ids, vecs)
        self._event("upsert", rows=int(len(ids)),
                    delta_rows=self.delta_rows)
        self._count("mutable.upserts", int(len(ids)))
        return ids

    @tracing.annotate("raft_tpu::mutable::delete")
    def delete(self, ids) -> int:
        """Delete rows by external id → how many were present (absent ids
        are no error). Durable before it returns, as :meth:`upsert`. A
        ``delete`` event and the ``mutable.deletes`` counter."""
        ids = np.atleast_1d(_host_rows(ids, np.int64))
        with self._lock:
            self._wal.append("delete", ids)
            found = self._apply_delete_locked(ids)
        self._event("delete", rows=int(len(ids)), found=found,
                    tombstones=self.tombstones)
        self._count("mutable.deletes", int(len(ids)))
        return found

    # -- introspection --------------------------------------------------------
    @property
    def sealed_index(self):
        """The live sealed family index (None before the first seal)."""
        return self._sealed

    @property
    def sealed_rows(self) -> int:
        return len(self._alive) - self._n_tomb

    @property
    def delta_rows(self) -> int:
        return self._d_live

    @property
    def tombstones(self) -> int:
        return self._n_tomb

    @property
    def size(self) -> int:
        """Live rows over both tiers."""
        return self.sealed_rows + self.delta_rows

    @property
    def generation(self) -> int:
        return self._gen

    @property
    def last_merge(self) -> Optional[dict]:
        """The last merge's verdict, generation, rows, seconds (and
        ``stages_s``) or the reason it was abandoned."""
        return self._last_merge

    def merge_breaker(self) -> dict:
        """The merge breaker's state: ``state`` ("closed", "open",
        "half_open"), ``reason``, ``backoff_s``, ``next_probe_in_s`` and
        its counts."""
        return self._breaker.snapshot()

    def wal_bytes(self) -> int:
        with self._lock:
            return self._wal.size_bytes() if self._wal else 0

    # -- search ---------------------------------------------------------------
    def _sealed_view_locked(self):
        """(sealed index, tombstone bitset or None, ids on the device),
        kept until a mutation or a flip."""
        if self._sealed is None or self.sealed_rows == 0:
            return None
        if self._sealed_cache is None:
            filt = (None if self._n_tomb == 0 else Bitset.from_mask(
                torch.from_numpy(self._alive).to(self.device)))
            ids_dev = torch.as_tensor(self._sealed_ids, dtype=torch.int32,
                                      device=self.device)
            self._sealed_cache = (self._sealed, filt, ids_dev)
        return self._sealed_cache

    def _delta_view_locked(self):
        """(brute-force index over the capacity-padded delta, its live
        rows' bitset, ids on the device, capacity), rebuilt from the host
        rows after a mutation."""
        from . import brute_force

        if self._d_live == 0:
            return None
        if self._delta_cache is None:
            cap = len(self._d_ids)
            idx = brute_force.build(torch.from_numpy(self._d_vecs),
                                    self.metric, device=self.device)
            filt = Bitset.from_mask(
                torch.from_numpy(self._d_alive).to(self.device))
            ids_dev = torch.as_tensor(self._d_ids, dtype=torch.int32,
                                      device=self.device)
            self._delta_cache = (idx, filt, ids_dev, cap)
        return self._delta_cache

    def _search_sealed(self, sealed, q, k, params, filt, opts):
        if self.family == "brute_force":
            return self._mod.search(sealed, q, k, filter=filt, **opts)
        return self._mod.search(sealed, q, k, params, filter=filt, **opts)

    @tracing.annotate("raft_tpu::mutable::search")
    def search(self, queries, k: int, params=None, **opts):
        """The k nearest live rows → (distances (m, k), int32 external
        ids (m, k)), on the index's device: the sealed segment with its
        tombstones as the filter and the delta with its dead rows
        filtered, both under ``filter_policy.suspended()``, merged by
        ``knn_merge_parts``. ``params``: the sealed family's
        SearchParams (brute force takes none); ``opts`` go to the family's
        search, but ``filter`` is refused (use :meth:`delete`)."""
        from . import brute_force

        expects("filter" not in opts,
                "mutable search does not accept a filter — tombstones "
                "own the sealed filter slot; use delete() to exclude "
                "rows")
        q = torch.as_tensor(queries).to(device=self.device,
                                        dtype=torch.float32)
        expects(q.dim() == 2 and q.shape[1] == self.dim,
                "queries must be (m, %d), got %s", self.dim, tuple(q.shape))
        with self._lock:
            sview = self._sealed_view_locked()
            dview = self._delta_view_locked()
            # what the merge's pre-warm searches the new segment with
            self._last_shape = (int(q.shape[0]), int(k))
            self._last_request = (params, dict(opts))
            phys = len(self._alive) + len(self._d_ids)
        expects(sview is not None or dview is not None or phys > 0,
                "mutable index is empty")
        select_min = is_min_close(self.metric)
        bad = float("inf") if select_min else -float("inf")
        m = q.shape[0]
        if sview is None and dview is None:
            return (torch.full((m, k), bad, device=self.device),
                    torch.full((m, k), -1, dtype=torch.int32,
                               device=self.device))
        parts = []
        with filter_policy.suspended():
            if sview is not None:
                sealed, filt, ids_dev = sview
                d, i = self._search_sealed(sealed, q, min(k, sealed.size),
                                           params, filt, opts)
                ext = torch.where(i >= 0, ids_dev[i.clamp_min(0).long()], -1)
                parts.append(_pad_k(d, ext, k, bad))
            if dview is not None:
                didx, dfilt, dids_dev, cap = dview
                d, i = brute_force.search(didx, q, min(k, cap), filter=dfilt)
                ext = torch.where(i >= 0, dids_dev[i.clamp_min(0).long()],
                                  -1)
                parts.append(_pad_k(d, ext, k, bad))
        if len(parts) == 1:
            return parts[0]
        return brute_force.knn_merge_parts(
            torch.stack([p[0] for p in parts]),
            torch.stack([p[1] for p in parts]), select_min)

    # -- the merge ------------------------------------------------------------
    def should_merge(self) -> bool:
        with self._lock:
            if self._merging:
                return False
            n_sealed = len(self._alive)
            tomb_frac = (self.tombstones / n_sealed) if n_sealed else 0.0
            return (self.delta_rows >= self.merge_rows
                    or tomb_frac >= self.merge_tomb_frac)

    def maintenance(self) -> Optional[str]:
        """The periodic tick: :meth:`merge` when it is due
        (``RAFT_TPU_MUTABLE_MERGE_ROWS`` delta rows, or
        ``RAFT_TPU_MUTABLE_MERGE_TOMB_FRAC`` of the sealed rows
        tombstoned), else None."""
        if not self.should_merge():
            return None
        return self.merge()

    def merge(self, deadline_s: Optional[float] = None) -> str:
        """Fold the delta and the tombstones into a new sealed generation
        → ``"committed"``, ``"in_progress"`` (another merge runs) or
        ``"backoff"``: this merge failed (abandoned, the live index as
        it was, ``last_merge`` says why) or the breaker is open from an
        earlier failure. ``deadline_s`` (else
        ``RAFT_TPU_MUTABLE_MERGE_DEADLINE_S``; 0: none) abandons a merge
        that runs longer."""
        return self._breaker.call(lambda: self._merge_once(deadline_s))

    def _check_deadline(self, t0: float, deadline_s: float,
                        phase: str) -> None:
        if deadline_s and deadline_s > 0:
            el = self._clock() - t0
            if el > deadline_s:
                raise RaftError(f"merge deadline exceeded after {phase} "
                                f"({el:.1f}s > {deadline_s:.1f}s)")

    def _post_merge_check(self, index, vecs: np.ndarray) -> dict:
        """The new segment before its flip: the family's health report
        must render, and its distances at k = 10 for 64 sampled rows of
        the merge's corpus must reach the exact k-th distance (within
        1e-5 relative, the ann-benchmarks rule, so duplicate rows may
        trade ids) on at least ``merge_recall_floor`` of the slots."""
        from . import brute_force
        from .brute_force import health_sample_rows

        rep = self._mod.health(index)
        rows = health_sample_rows(len(vecs), 64)
        if rows.size == 0:
            return {"health_family": rep.get("family"), "merge_recall": 1.0}
        q = torch.from_numpy(np.ascontiguousarray(vecs[rows])).to(
            self.device)
        kc = min(10, len(vecs))
        ref = brute_force.build(torch.from_numpy(vecs), self.metric,
                                device=self.device)
        ref_d, _ = brute_force.search(ref, q, kc)
        del ref
        cand_d, _ = self._search_sealed(index, q, kc, None, None, {})
        ref_d, cand_d = ref_d.cpu().numpy(), cand_d.cpu().numpy()
        kth = ref_d[:, -1:]
        eps = 1e-5 + 1e-5 * np.abs(kth)
        ok = (cand_d <= kth + eps if is_min_close(self.metric)
              else cand_d >= kth - eps)
        recall = float(ok.mean())
        if recall < self.merge_recall_floor:
            raise RaftError(f"post-merge recall {recall:.3f} below floor "
                            f"{self.merge_recall_floor:.3f}")
        return {"health_family": rep.get("family"), "merge_recall": recall}

    def _prewarm(self, index) -> None:
        """Search the new segment once at the last served shape and
        parameters (``res`` dropped), so that the first search after the
        flip finds its plans and caches made. No device sync."""
        with self._lock:
            shape, request = self._last_shape, self._last_request
        if shape is None:
            return
        m, k = shape
        k = min(k, max(1, index.size))
        params, opts = request
        opts = {kk: v for kk, v in opts.items() if kk != "res"}
        self._search_sealed(index, torch.zeros((m, self.dim),
                                               device=self.device),
                            k, params, None, opts)

    def _lap(self, stages: dict, name: str, t: list) -> None:
        """Stage ``name``'s seconds since ``t[0]`` (the device synchronised
        first, so the stage's work is its own)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        stages[name] = now - t[0]
        t[0] = now

    def _merge_once(self, deadline_s: Optional[float]) -> str:
        t0 = self._clock()
        deadline_s = (self.merge_deadline_s if deadline_s is None
                      else deadline_s)
        stages: dict = {}
        lap = [time.perf_counter()]
        old_wal = None
        started = False          # did this call claim the merge?
        try:
            # one hold from the claim through the watermark: a mutation
            # lands either before it (merged) or after it (in the delta
            # tail, in _during and in the new log)
            with self._lock:
                if self._merging:
                    return "in_progress"
                # the log rotates first: mutations during the merge go to
                # the new one, and the manifest names both until the flip
                self._epoch += 1
                new_wal_name = self._wal_name(self._epoch)
                try:
                    # a rotated-out log is replayed with no torn tail
                    # allowed: cut a failed append's bytes first
                    self._wal.seal()
                    new_wal = wal_mod.WriteAheadLog.create(
                        os.path.join(self.path, new_wal_name))
                    self._wal_names = self._wal_names + [new_wal_name]
                    self._save_manifest_locked()   # still the old generation
                except BaseException:
                    self._epoch -= 1
                    if self._wal_names and \
                            self._wal_names[-1] == new_wal_name:
                        self._wal_names = self._wal_names[:-1]
                    try:
                        os.unlink(os.path.join(self.path, new_wal_name))
                    except OSError:
                        pass
                    raise
                self._merging = True
                started = True
                self._during = []
                old_wal, self._wal = self._wal, new_wal
                watermark = self._d_n
                sa = self._alive
                da = self._d_alive[:watermark]
                vecs = np.concatenate(
                    [self._sealed_vecs[sa], self._d_vecs[:watermark][da]])
                ids = np.concatenate(
                    [self._sealed_ids[sa], self._d_ids[:watermark][da]])
                gen0, gen2 = self._gen, self._gen + 1
                sealed0, sealed_ids0 = self._sealed, self._sealed_ids
            self._event("merge_started", generation=gen0,
                        rows=int(len(ids)), delta_rows=int(da.sum()),
                        tombstones=self.tombstones)
            self._lap(stages, "rotate_snapshot", lap)
            hook = getattr(self, "_after_snapshot_hook", None)
            if hook is not None:
                hook()                    # a test's mutation mid-merge
            faults.crash("mutable.merge.build")
            warm = self._warm_graph(ids, sealed0, sealed_ids0)
            new_sealed = (self._build_segment(vecs, warm=warm)
                          if len(vecs) else None)
            self._lap(stages, "build", lap)
            self._check_deadline(t0, deadline_s, "build")
            check = {}
            if new_sealed is not None:
                check = self._post_merge_check(new_sealed, vecs)
                self._lap(stages, "check", lap)
                self._prewarm(new_sealed)
                self._lap(stages, "prewarm", lap)
            self._check_deadline(t0, deadline_s, "check")
            # the new generation's files (orphans until the flip)
            if new_sealed is not None:
                self._save_segment_of(new_sealed, gen2)
            self._save_snapshot(gen2, vecs, ids)
            self._lap(stages, "write", lap)
            faults.crash("mutable.merge.pre_flip")
            # the flip: one atomic manifest replace moves recovery from
            # (gen0 + both logs) to (gen2 + the new log)
            with self._lock:
                old_names = (self._wal_names[:-1],
                             self._seg_name(gen0), self._snap_name(gen0))
                self._wal_names = self._wal_names[-1:]
                self._gen = gen2
                self._save_manifest_locked()
            faults.crash("mutable.merge.post_flip")
            with self._lock:
                during = self._during
                self._during = []
                self._install_sealed_locked(new_sealed, ids, vecs)
                # ids that mutations touched during the build: their new
                # sealed slot is stale, as a replay would find it
                for _kind, dids in during:
                    for ext in dids.tolist():
                        slot = self._slot_of.get(ext)
                        if slot is not None and self._alive[slot]:
                            self._alive[slot] = False
                            self._n_tomb += 1
                # the delta keeps its tail (rows born during the merge)
                tail_v = self._d_vecs[watermark:self._d_n].copy()
                tail_i = self._d_ids[watermark:self._d_n].copy()
                tail_a = self._d_alive[watermark:self._d_n].copy()
                self._d_vecs = np.zeros((0, self.dim), np.float32)
                self._d_ids = np.zeros(0, np.int64)
                self._d_alive = np.zeros(0, bool)
                self._d_n = 0
                self._d_live = 0
                self._d_row_of = {}
                self._delta_cache = None
                if len(tail_i):
                    self._ensure_delta_cap_locked(len(tail_i))
                    self._d_vecs[:len(tail_i)] = tail_v
                    self._d_ids[:len(tail_i)] = tail_i
                    self._d_alive[:len(tail_i)] = tail_a
                    self._d_n = len(tail_i)
                    self._d_live = int(tail_a.sum())
                    self._d_row_of = {int(e): r for r, e in enumerate(tail_i)
                                      if tail_a[r]}
                self._merging = False
            self._lap(stages, "flip", lap)
            # retire the old generation (a failure here leaves orphans,
            # which recovery removes)
            try:
                old_wal.close()
                for fn in (*old_names[0], old_names[1], old_names[2]):
                    p = os.path.join(self.path, fn)
                    if os.path.exists(p):
                        os.unlink(p)
                fsync_dir(self.path)
            except OSError:
                pass
            self._lap(stages, "retire", lap)
            dur = round(self._clock() - t0, 3)
            self._last_merge = {"verdict": "committed", "generation": gen2,
                                "rows": int(len(ids)), "dur_s": dur,
                                "stages_s": stages, **check}
            self._event("merge_committed", generation=gen2,
                        rows=int(len(ids)), dur_s=dur, **check)
            self._count("mutable.merges.committed")
            return "committed"
        except Exception as e:
            # abandoned: the live index is as it was (the rotated log and
            # the manifest naming both keep recovery whole); raised on
            # for the breaker. InjectedCrash is no Exception and passes.
            with self._lock:
                self._merging = False
                self._during = []
                gen_now = self._gen
            if old_wal is not None:
                try:
                    old_wal.close()     # it stays on disk, named
                except OSError:
                    pass
            self._last_merge = {"verdict": "abandoned",
                                "reason": f"{type(e).__name__}: {e}",
                                "dur_s": round(self._clock() - t0, 3)}
            self._event("merge_abandoned", generation=gen_now, error=e)
            self._count("mutable.merges.abandoned")
            raise
        finally:
            # only the call that claimed the merge clears the flag
            if started:
                with self._lock:
                    self._merging = False

    def ops_entry(self) -> dict:
        with self._lock:
            ent = {"family": self.family, "generation": self._gen,
                   "sealed_rows": self.sealed_rows,
                   "delta_rows": self.delta_rows,
                   "tombstones": self.tombstones,
                   "wal_bytes": self._wal.size_bytes() if self._wal else 0,
                   "merging": self._merging,
                   "merge_breaker": self._breaker.snapshot()["state"]}
            if self._last_merge is not None:
                ent["last_merge"] = dict(self._last_merge)
            return ent


def create(path, dataset=None, ids=None, **kw) -> MutableIndex:
    """:meth:`MutableIndex.create`."""
    return MutableIndex.create(path, dataset, ids, **kw)


def recover(path, device=None) -> MutableIndex:
    """:meth:`MutableIndex.recover`."""
    return MutableIndex.recover(path, device)


def health(index: MutableIndex, sample: int = 256) -> dict:
    """The tiers' state and the sealed family's own health report."""
    rep = {**index.ops_entry(), "family": "mutable",
           "sealed_family": index.family, "n": index.size,
           "dim": index.dim, "metric": index.metric.name}
    sealed = index.sealed_index
    if sealed is not None:
        try:
            rep["sealed"] = index._mod.health(sealed, sample=sample)
        except Exception as e:  # noqa: BLE001 - the report must render
            rep["sealed"] = {"error": f"{type(e).__name__}: {e}"}
    return rep


def make_searcher(index: MutableIndex, params=None, **opts):
    """``fn(queries, k, res=None) -> (distances, indices)`` over the
    mutable index (a merge's flip serves the next call)."""

    def _fn(queries, k, res=None):
        return index.search(queries, k, params, **opts)

    return _fn


def ops_snapshot() -> dict:
    """Each live mutable index's state: delta rows, tombstones, WAL
    bytes, the last merge."""
    out: Dict[str, dict] = {}
    for idx in list(_LIVE):
        key = idx.name if idx.name not in out else f"{idx.name}@{id(idx):x}"
        try:
            out[key] = idx.ops_entry()
        except Exception as e:  # noqa: BLE001 - the snapshot must render
            out[key] = {"error": f"{type(e).__name__}: {e}"}
    return {"indexes": out}
