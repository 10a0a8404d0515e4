"""Exact-match query-result cache for the multi-tenant fabric:
counterpart of ``raft_tpu/serve/qcache.py`` (``query_digest``,
``QueryCache``).

* **Exact match only**: the key is ``(tenant, blake2b(query bytes), k,
  params_key)`` over the C-contiguous float32 bytes of the query block —
  the JAX package's digest, digest for digest, on the same bytes. A hit
  returns the host tensors a dispatch produced for the same index
  generation.
* **Bounded LRU**: ``capacity`` entries; blocks above ``max_rows`` are
  never cached (counted under ``<name>.qcache.bypass``).
* **Generation-keyed invalidation**: the fabric folds the tenant's swap
  generation (and a mutable index's merge generation) into
  ``params_key``; :meth:`QueryCache.invalidate_tenant` also drops a
  tenant's entries at once.
* **Policed**: the fabric offers sampled hits to the tenant's recall
  sentinel under the ``qcache`` family.

Metrics: ``<name>.qcache.hits`` / ``.misses`` / ``.bypass`` /
``.invalidated`` / ``.evictions`` counters and ``<name>.qcache.entries``.
Knobs: ``RAFT_TPU_QCACHE_CAP`` (default 4096 entries),
``RAFT_TPU_QCACHE_MAX_ROWS`` (default 16 rows a cached block).
"""
from __future__ import annotations

import collections
import hashlib
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from ..utils import env_int

__all__ = ["QueryCache", "query_digest"]


def query_digest(queries) -> str:
    """Stable content digest of one query block (a tensor or array): the
    blake2b of its C-contiguous float32 bytes."""
    if isinstance(queries, torch.Tensor):
        queries = queries.detach().to("cpu", torch.float32).numpy()
    q = np.ascontiguousarray(queries, np.float32)
    return hashlib.blake2b(q.tobytes(), digest_size=16).hexdigest()


class QueryCache:
    """Bounded exact-match LRU of served (distances, indices) blocks.

    Thread-safe: one lock over the ordered map (get/put/invalidate all
    run on the fabric worker or a submit thread). Stored tensors are
    host copies — a cached result must not pin device memory nor alias
    a caller-mutable block.
    """

    def __init__(self, capacity: Optional[int] = None,
                 max_rows: Optional[int] = None,
                 registry=None, name: str = "fabric"):
        from . import metrics as _metrics

        self.capacity = (env_int("RAFT_TPU_QCACHE_CAP", 4096)
                         if capacity is None else int(capacity))
        if self.capacity <= 0:
            raise ValueError(
                f"qcache capacity must be positive, got {self.capacity}")
        self.max_rows = (env_int("RAFT_TPU_QCACHE_MAX_ROWS", 16)
                         if max_rows is None else int(max_rows))
        reg = registry or _metrics.default_registry
        self._name = name
        self._hits = reg.counter(f"{name}.qcache.hits")
        self._misses = reg.counter(f"{name}.qcache.misses")
        self._bypass = reg.counter(f"{name}.qcache.bypass")
        self._invalidated = reg.counter(f"{name}.qcache.invalidated")
        self._evictions = reg.counter(f"{name}.qcache.evictions")
        self._entries = reg.gauge(f"{name}.qcache.entries")
        self._lock = threading.Lock()
        self._map: "collections.OrderedDict[tuple, tuple]" = \
            collections.OrderedDict()

    # -- keying -----------------------------------------------------------
    def key(self, tenant: str, queries, k: int,
            params_key: str) -> Optional[tuple]:
        """Cache key for one request, or None when the request is not
        cacheable (too many rows — counted as a bypass at lookup)."""
        if queries.shape[0] > self.max_rows:
            return None
        return (str(tenant), query_digest(queries), int(k),
                str(params_key))

    # -- lookup / insert --------------------------------------------------
    def get(self, key: Optional[tuple]
            ) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """Hit returns ``(distances, indices)`` host tensors; miss (or a
        non-cacheable ``key=None``) returns None. Counts hit/miss/bypass."""
        if key is None:
            self._bypass.inc()
            return None
        with self._lock:
            hit = self._map.get(key)
            if hit is not None:
                self._map.move_to_end(key)
        if hit is None:
            self._misses.inc()
            return None
        self._hits.inc()
        # copies OUT as well as in: a caller post-processing a hit's
        # tensors in place must not poison every future hit
        return (hit[0].clone(), hit[1].clone())

    def bypass(self) -> None:
        """Count one deliberate non-lookup (caller opted out via
        ``submit(..., cache=False)``) — distinguishable from misses on a
        dashboard."""
        self._bypass.inc()

    def put(self, key: Optional[tuple], distances, indices) -> bool:
        """Insert one served answer (host copies); evicts LRU beyond
        capacity. ``key=None`` (non-cacheable) is a no-op."""
        if key is None:
            return False
        val = tuple(torch.as_tensor(a).detach().to("cpu", copy=True)
                    for a in (distances, indices))
        evicted = 0
        with self._lock:
            self._map[key] = val
            self._map.move_to_end(key)
            while len(self._map) > self.capacity:
                self._map.popitem(last=False)
                evicted += 1
            n = len(self._map)
        if evicted:
            self._evictions.inc(evicted)
        self._entries.set(n)
        return True

    # -- invalidation -----------------------------------------------------
    def invalidate_tenant(self, tenant: str) -> int:
        """Eagerly drop every entry of ``tenant`` (swap / merge flip —
        the generation baked into ``params_key`` already defeats lookups;
        this frees the memory too). Returns the count dropped."""
        tenant = str(tenant)
        with self._lock:
            dead = [k for k in self._map if k[0] == tenant]
            for k in dead:
                del self._map[k]
            n = len(self._map)
        if dead:
            self._invalidated.inc(len(dead))
        self._entries.set(n)
        return len(dead)

    def clear(self) -> None:
        with self._lock:
            self._map.clear()
        self._entries.set(0)

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return len(self._map)

    def hit_rate(self) -> Optional[float]:
        """Lifetime hit rate over (hits + misses); None before any
        lookup."""
        h, m = self._hits.value, self._misses.value
        return h / (h + m) if (h + m) > 0 else None

    def snapshot(self) -> dict:
        """JSON-safe view for the debugz ``tenants`` section."""
        with self._lock:
            n = len(self._map)
        hr = self.hit_rate()
        return {
            "entries": n,
            "capacity": self.capacity,
            "max_rows": self.max_rows,
            "hits": int(self._hits.value),
            "misses": int(self._misses.value),
            "bypass": int(self._bypass.value),
            "invalidated": int(self._invalidated.value),
            "evictions": int(self._evictions.value),
            "hit_rate": None if hr is None else round(hr, 4),
        }
