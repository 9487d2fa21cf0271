"""Source-row distance cache — LRU over solved ``(graph, source)`` rows
(port of repro/serve/cache.py; rows are host numpy arrays).

The serving workloads (arXiv:1505.05033's observation, reproduced by the
Zipf scenario in serve/workload.py) repeat sources heavily: a handful of
hub sources account for most queries.  Once any engine has solved a source
to its fixpoint, its (n,) distance row answers every later ``sssp(s)`` and
``dist(s, t)`` query against the same graph without touching an engine.

Rows are exact fixpoints, so cache hits preserve the bitwise-equal-to-
serial guarantee trivially: the bytes returned are the bytes solved.  Two
things must never be served from here: partial rows (a ``target=``
early-exit solve) are not inserted at all, and a *t*-row is never used to
answer ``dist(s, t)`` — undirected symmetry holds in exact arithmetic,
but f32 path sums traversed from the other end can differ by an ulp,
which would break bitwise equality with a fresh s-sourced solve.

Eviction is plain LRU by row count (each row is n * 4 bytes, so a row
budget is a byte budget per graph size); hit/miss/eviction counters feed
the serve metrics.
"""
from __future__ import annotations

import collections
from typing import Hashable, Optional

import numpy as np

from repro_torch.obs.metrics import MetricsRegistry


class DistanceCache:
    """LRU cache of solved distance rows keyed by ``(graph, source)``.

    ``capacity`` bounds the number of rows held; 0 disables caching (every
    ``get`` is a miss, ``put`` is a no-op) so a sequential baseline can
    run the same scheduler cache-less.

    Counters live on a `MetricsRegistry` (own instance by default, or a
    shared one via ``metrics=``) under the ``cache.*`` namespace; the
    legacy ``hits``/``misses``/``evictions`` attributes and ``stats()``
    dict are views over it.
    """

    def __init__(self, capacity: int = 256,
                 metrics: Optional[MetricsRegistry] = None):
        if capacity < 0:
            raise ValueError(f"capacity must be >= 0, got {capacity}")
        self.capacity = capacity
        self._rows: "collections.OrderedDict[Hashable, np.ndarray]" = (
            collections.OrderedDict())
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._hits = self.metrics.counter("cache.hits")
        self._misses = self.metrics.counter("cache.misses")
        self._evictions = self.metrics.counter("cache.evictions")
        self.metrics.gauge("cache.rows", fn=lambda: len(self._rows))

    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    def __len__(self) -> int:
        return len(self._rows)

    def get(self, key: Hashable) -> Optional[np.ndarray]:
        """Return the cached row (refreshing its recency) or None."""
        row = self._rows.get(key)
        if row is None:
            self._misses.inc()
            return None
        self._rows.move_to_end(key)
        self._hits.inc()
        return row

    def peek(self, key: Hashable) -> Optional[np.ndarray]:
        """Like get but touches neither counters nor recency (for tests
        and for probing both endpoint rows before committing to one)."""
        return self._rows.get(key)

    def put(self, key: tuple, row: np.ndarray) -> None:
        """Insert a COMPLETE fixpoint row under a tuple key.

        Key contract: every key is a tuple whose first element is the
        graph name — ``(name, source)``, ``(name, version, source)`` for
        dynamic graphs, ``(name, shard, source)`` for sharded-routed ones
        (``GraphHandle.row_key`` builds all three).  ``keys_for`` /
        ``purge_graph`` index ``k[0]`` on every key, so a non-tuple key
        would crash the next eviction purge (or, for a str key equal to a
        graph name, be silently over-purged); reject it at insert time
        where the caller is on the stack.

        The row is FROZEN on insert: served bytes alias the stored array,
        so a caller that keeps mutating its buffer after ``put`` (e.g. a
        repair loop patching rows in place) would silently corrupt every
        later hit — the same aliasing class the overlay staging fixed in
        dynamic/overlay.py.  Borrowed/externally-owned buffers (views, and
        ``tensor.numpy()`` / ``tensor.cpu().numpy()``, which share the
        tensor's storage) are copied before freezing; owned buffers are
        frozen in place, making post-insert writes through the caller's
        handle raise instead of corrupt.
        """
        if not isinstance(key, tuple):
            raise TypeError(
                f"cache keys must be (graph, ...) tuples (see "
                f"GraphHandle.row_key); got {type(key).__name__}: {key!r}")
        if self.capacity == 0:
            return
        row = np.asarray(row)
        if not row.flags.owndata:
            row = row.copy()
        row.setflags(write=False)
        if key in self._rows:
            self._rows.move_to_end(key)
        self._rows[key] = row
        while len(self._rows) > self.capacity:
            self._rows.popitem(last=False)
            self._evictions.inc()

    def pop(self, key: Hashable) -> Optional[np.ndarray]:
        """Remove and return one row without touching the hit/miss
        counters (the mutation path's selective invalidation and
        re-keying are bookkeeping, not query traffic)."""
        return self._rows.pop(key, None)

    def keys_for(self, graph: Hashable) -> list:
        """All keys belonging to ``graph``, LRU-first (keys start with
        the graph name whatever their arity — versioned dynamic keys are
        ``(graph, version, source)``, sharded ``(graph, shard, source)``,
        static ``(graph, source)``; ``put`` enforces tuple keys so the
        ``k[0]`` probe here is always the name)."""
        return [k for k in self._rows if k[0] == graph]

    def purge_graph(self, graph: Hashable) -> int:
        """Drop every row belonging to ``graph`` — every VERSION of it,
        since all keys lead with the name — wired to registry eviction so
        a re-registered name can never serve rows of the evicted graph."""
        stale = self.keys_for(graph)
        for k in stale:
            del self._rows[k]
        return len(stale)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def stats(self) -> dict:
        """Legacy flat view; the same counts appear in
        ``metrics.snapshot()`` under the ``cache.*`` namespace."""
        return {
            "rows": len(self._rows),
            "capacity": self.capacity,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": round(self.hit_rate, 4),
        }
