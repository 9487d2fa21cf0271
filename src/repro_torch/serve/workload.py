"""Synthetic serving workloads (port of repro/serve/workload.py).

Only :class:`EdgeChurn`, the seeded edge-mutation sampler, is here: the
dynamic bench and ``chip_smoke.py`` apply its edits to a ``DynamicGraph``.
The arrival traces (``make_trace``, ``make_churn_trace``), their events and
the latency recorder come with the serving slice of the port.
"""
from __future__ import annotations

import numpy as np


class EdgeChurn:
    """Seeded edge-mutation sampler over an evolving undirected edge set.

    Deletes and updates pick a uniformly random live edge (a swap-pop
    list); adds rejection-sample an absent pair; the op is uniform over
    add / update / delete.  The mirror evolves with every sample, so a
    sampled sequence is valid when applied in order.

    The same seed draws the same edits as the JAX package's sampler: the
    draws come in the same order, and the live list starts in the same
    order (the incoming CSR's u < v arcs) and changes the same way.  The
    list is held as int64 keys ``u * n + v`` in a numpy array, and
    membership as the sorted base keys plus the sets of edges added and
    deleted since, so a graph of tens of millions of edges costs a few
    bytes an edge rather than a Python tuple each.
    """

    def __init__(self, cg, rng: np.random.Generator, *,
                 max_weight: float = 100.0):
        if getattr(cg, "directed", False):
            raise ValueError("churn traces assume undirected graphs "
                             "(the serve landmark path's contract)")
        self.n = int(cg.n)
        self.rng = rng
        self.max_weight = max_weight
        u = np.asarray(cg.indices, np.int64)
        v = cg.dst_ids().astype(np.int64)
        keep = u < v
        self._live = u[keep] * self.n + v[keep]
        self._count = int(self._live.shape[0])
        self._base = np.sort(self._live)
        self._added: set = set()
        self._deleted: set = set()

    def __len__(self) -> int:
        """Live edges."""
        return self._count

    def _has(self, key: int) -> bool:
        if key in self._added:
            return True
        if key in self._deleted:
            return False
        i = int(np.searchsorted(self._base, key))
        return i < self._base.shape[0] and int(self._base[i]) == key

    def _weight(self) -> float:
        return float(np.float32(self.rng.uniform(0.5, self.max_weight)))

    def sample(self) -> tuple:
        """One ``(op, u, v, w)`` edit (w is None for deletes)."""
        n = self.n
        op = ("add", "update", "delete")[int(self.rng.integers(3))]
        if op == "add" or not self._count:
            while True:
                a = int(self.rng.integers(n))
                b = int(self.rng.integers(n))
                key = min(a, b) * n + max(a, b)
                if a != b and not self._has(key):
                    break
            if key in self._deleted:
                self._deleted.discard(key)
            else:
                self._added.add(key)
            if self._count == self._live.shape[0]:
                self._live = np.concatenate(
                    [self._live, np.empty(max(self._count, 16), np.int64)])
            self._live[self._count] = key
            self._count += 1
            return ("add", key // n, key % n, self._weight())
        j = int(self.rng.integers(self._count))
        key = int(self._live[j])
        if op == "delete":
            self._count -= 1
            self._live[j] = self._live[self._count]
            if key in self._added:
                self._added.discard(key)
            else:
                self._deleted.add(key)
            return ("delete", key // n, key % n, None)
        return ("update", key // n, key % n, self._weight())
