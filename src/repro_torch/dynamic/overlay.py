"""Mutable CSR overlays — a versioned dynamic view over a frozen base (port
of repro/dynamic/overlay.py).

``CsrGraph`` is immutable: its memoized views depend on that.  A
:class:`DynamicGraph` makes mutation cheap by layering three small mutable
structures over an untouched base:

* an **effective-weight copy** of the base arc weights, in both the
  incoming and the outgoing order (each mutation writes both): updates
  write the new value, deletions write INF (an INF arc never wins a relax
  min), a re-inserted base edge reuses its slots;
* an **insertion overlay**: new arcs land in fixed-capacity arrays
  (``ov_src`` / ``ov_dst`` / ``ov_w``); free slots hold the inert
  ``(0, n, INF)``, n being the drop id.  The capacity stays fixed across
  versions, so the staged tensors keep their shapes;
* **deletion tombstones**, which are INF weights (base slots) or freed
  overlay slots: no arc is removed between compactions.

``commit()`` turns the pending edits into one :class:`MutationBatch` of
per-edge net ``w_old -> w_new`` deltas (INF means absent: a delete is an
increase to INF, an insert a decrease from INF), bumps the version and
restages the mutable tensors.  Once the live overlay passes
``compact_threshold``, ``compact()`` folds everything into a fresh frozen
``CsrGraph`` base.

The effective arc set always equals ``snapshot()`` plus inert INF slots,
so an engine run over the overlay operands reaches the fixpoint of a fresh
solve on the snapshot, bitwise.  The snapshot's arrays are byte-identical
to the JAX package's for the same edits.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch.core.csr import CsrGraph
from repro_torch.core.graph import INF


def _by_dst_then_src(src, dst, ov_src, ov_dst, n: int) -> np.ndarray:
    """``np.lexsort((src', dst'))`` of the live base arcs followed by the
    live overlay arcs (``src' = concat(src, ov_src)``, ``dst'`` likewise):
    the order that sorts them by dst, then src, ties in input order.  The
    base arcs of a CsrGraph already come in that order, so only the few
    overlay arcs are sorted and merged in after their equal keys; a base
    out of that order falls back to the full lexsort."""
    key = dst.astype(np.int64) * n + src
    if key.size and not bool((key[1:] >= key[:-1]).all()):
        return np.lexsort((np.concatenate([src, ov_src]),
                           np.concatenate([dst, ov_dst])))
    ov_key = ov_dst.astype(np.int64) * n + ov_src
    ov_order = np.argsort(ov_key, kind="stable")
    at = np.searchsorted(key, ov_key[ov_order], side="right")
    return np.insert(np.arange(key.size), at, key.size + ov_order)


@dataclasses.dataclass(frozen=True)
class EdgeDelta:
    """Net effect of one batch on one edge: ``w_old -> w_new``, INF meaning
    absent on either side (insert: w_old = INF; delete: w_new = INF).  For
    undirected graphs (u, v) is the canonical u < v form and the delta
    applies to both stored arcs."""

    u: int
    v: int
    w_old: float
    w_new: float


@dataclasses.dataclass(frozen=True)
class MutationBatch:
    """One committed mutation batch: the per-edge net deltas between two
    consecutive versions (edits that cancelled out are dropped)."""

    version_from: int
    version_to: int
    records: tuple

    def __len__(self) -> int:
        return len(self.records)


class DynamicGraph:
    """Versioned mutable view over a base :class:`CsrGraph`.

    Mutation API (weights finite and > 0: the repair's cone walks a
    predecessor tree, a shortest-path tree only under strictly positive
    weights):

    * ``add_edge(u, v, w)``    — edge must be absent;
    * ``update_edge(u, v, w)`` — edge must be present;
    * ``delete_edge(u, v)``    — edge must be present;
    * ``apply(edit)``          — one ``("add"|"update"|"delete", u, v[, w])``
      tuple.

    Edits take effect on the host at once; ``commit()`` publishes them as a
    new version and returns the :class:`MutationBatch` the repair consumes.
    ``dyn_ops(device=...)`` stages the operands of the dynamic engines.
    """

    def __init__(
        self,
        base: CsrGraph,
        *,
        overlay_capacity: int = 64,
        compact_threshold: "int | None | str" = "auto",
    ):
        """``compact_threshold``: live overlay arcs that trigger a compaction
        at commit.  "auto" is half the overlay capacity, so a batch smaller
        than the free half cannot overflow the fixed slots.  A batch that
        nets more inserts than the free slots grows the overlay by doubling
        (counted in ``overlay_growths``: new staged shapes).  ``None``
        disables compaction; the overlay then grows without bound."""
        if overlay_capacity < 1:
            raise ValueError(
                f"overlay_capacity must be >= 1, got {overlay_capacity}")
        self.directed = base.directed
        self._version = 0
        self.compact_threshold = (max(1, overlay_capacity // 2)
                                  if compact_threshold == "auto"
                                  else compact_threshold)
        self.compactions = 0
        self.overlay_growths = 0
        self._capacity = int(overlay_capacity)
        self._rebind_base(base)
        self._pending: "dict[tuple, float]" = {}   # edge key -> w at batch start
        self._dops: Optional[dict] = None
        self._device: Optional[torch.device] = None
        self._snapshot: Optional[CsrGraph] = None

    # -- base binding -----------------------------------------------------

    def _rebind_base(self, base: CsrGraph) -> None:
        """(Re)build the mutable state over ``base`` (init and compact)."""
        self.base = base
        out_indptr, out_dst, out_w = base.out_csr()
        self._in_w = np.asarray(base.weights, np.float32).copy()
        self._out_w = np.asarray(out_w, np.float32).copy()
        self._out_indptr = out_indptr
        self._out_dst = out_dst
        C = self._capacity
        self._ov_src = np.zeros(C, np.int32)
        self._ov_dst = np.full(C, base.n, np.int32)   # n = the drop id
        self._ov_w = np.full(C, INF, np.float32)
        self._ov_pos: "dict[tuple, int]" = {}         # (u, v) arc -> slot
        self._ov_free = list(range(C - 1, -1, -1))

    # -- introspection ----------------------------------------------------

    @property
    def n(self) -> int:
        return self.base.n

    @property
    def version(self) -> int:
        return self._version

    @property
    def overlay_used(self) -> int:
        """Live overlay arcs (insertions not yet folded by compact())."""
        return len(self._ov_pos)

    @property
    def overlay_capacity(self) -> int:
        return self._capacity

    @property
    def nnz_live(self) -> int:
        """Live arcs of the current version (tombstones excluded)."""
        return int(np.isfinite(self._in_w).sum()) + len(self._ov_pos)

    @property
    def nbytes(self) -> int:
        """Host bytes: base container + effective-weight copies + overlay."""
        return int(self.base.indptr.nbytes + self.base.indices.nbytes
                   + self.base.weights.nbytes + self._in_w.nbytes
                   + self._out_w.nbytes + self._ov_src.nbytes
                   + self._ov_dst.nbytes + self._ov_w.nbytes)

    @property
    def staged_nbytes(self) -> int:
        """Device bytes held by :meth:`dyn_ops` (0 if never staged)."""
        if self._dops is None:
            return 0
        return sum(t.nbytes for t in self._dops.values())

    # -- arc addressing ---------------------------------------------------

    def _edge_key(self, u: int, v: int) -> tuple:
        return (u, v) if self.directed or u < v else (v, u)

    def _base_in_pos(self, u: int, v: int) -> int:
        """Position of arc u->v in the incoming arrays, or -1 (row v is
        sorted by source: a binary search in v's window)."""
        lo, hi = int(self.base.indptr[v]), int(self.base.indptr[v + 1])
        i = lo + int(np.searchsorted(self.base.indices[lo:hi], u))
        return i if i < hi and int(self.base.indices[i]) == u else -1

    def _base_out_pos(self, u: int, v: int) -> int:
        """Position of arc u->v in the outgoing arrays, or -1."""
        lo, hi = int(self._out_indptr[u]), int(self._out_indptr[u + 1])
        i = lo + int(np.searchsorted(self._out_dst[lo:hi], v))
        return i if i < hi and int(self._out_dst[i]) == v else -1

    def weight_of(self, u: int, v: int) -> float:
        """Effective weight of arc u->v in the current version (INF when
        absent)."""
        p = self._base_in_pos(u, v)
        if p >= 0 and np.isfinite(self._in_w[p]):
            return float(self._in_w[p])
        slot = self._ov_pos.get((u, v))
        return float(self._ov_w[slot]) if slot is not None else float("inf")

    def has_edge(self, u: int, v: int) -> bool:
        return np.isfinite(self.weight_of(u, v))

    # -- mutation ---------------------------------------------------------

    def _check(self, u: int, v: int) -> tuple:
        u, v = int(u), int(v)
        if not (0 <= u < self.n and 0 <= v < self.n):
            raise IndexError(
                f"edge endpoints must be in [0, {self.n}); got ({u}, {v})")
        if u == v:
            raise ValueError("self-loops are not representable "
                             "(the 0 diagonal is implicit)")
        return u, v

    def _grow_overlay(self) -> None:
        C = self._capacity
        self._ov_src = np.concatenate([self._ov_src, np.zeros(C, np.int32)])
        self._ov_dst = np.concatenate([self._ov_dst,
                                       np.full(C, self.n, np.int32)])
        self._ov_w = np.concatenate([self._ov_w, np.full(C, INF, np.float32)])
        self._ov_free.extend(range(2 * C - 1, C - 1, -1))
        self._capacity = 2 * C
        self.overlay_growths += 1

    def _set_arc(self, u: int, v: int, w: float) -> None:
        """Write one directed arc's effective weight (INF = tombstone)."""
        p = self._base_in_pos(u, v)
        if p >= 0:
            self._in_w[p] = w
            self._out_w[self._base_out_pos(u, v)] = w
            return
        slot = self._ov_pos.get((u, v))
        if slot is not None:
            if np.isfinite(w):
                self._ov_w[slot] = w
            else:                       # an overlay delete frees the slot
                self._ov_src[slot] = 0
                self._ov_dst[slot] = self.n
                self._ov_w[slot] = INF
                del self._ov_pos[(u, v)]
                self._ov_free.append(slot)
            return
        if not np.isfinite(w):          # deleting an absent arc: no-op
            return
        if not self._ov_free:
            self._grow_overlay()
        slot = self._ov_free.pop()
        self._ov_src[slot] = u
        self._ov_dst[slot] = v
        self._ov_w[slot] = np.float32(w)
        self._ov_pos[(u, v)] = slot

    def _record_and_set(self, u: int, v: int, w: float) -> None:
        key = self._edge_key(u, v)
        if key not in self._pending:
            self._pending[key] = self.weight_of(*key)
        w32 = np.float32(w)
        self._set_arc(u, v, w32)
        if not self.directed:
            self._set_arc(v, u, w32)

    @staticmethod
    def _check_weight(w: float) -> None:
        if not (np.isfinite(w) and w > 0):
            raise ValueError(f"edge weights must be finite and > 0, got {w}")

    def add_edge(self, u: int, v: int, w: float) -> None:
        u, v = self._check(u, v)
        if self.has_edge(u, v):
            raise ValueError(f"edge ({u}, {v}) already present; "
                             "use update_edge")
        self._check_weight(w)
        self._record_and_set(u, v, w)

    def update_edge(self, u: int, v: int, w: float) -> None:
        u, v = self._check(u, v)
        if not self.has_edge(u, v):
            raise ValueError(f"edge ({u}, {v}) not present; use add_edge")
        self._check_weight(w)
        self._record_and_set(u, v, w)

    def delete_edge(self, u: int, v: int) -> None:
        u, v = self._check(u, v)
        if not self.has_edge(u, v):
            raise ValueError(f"edge ({u}, {v}) not present")
        self._record_and_set(u, v, INF)

    def apply(self, edit: tuple) -> None:
        """One ``("add"|"update"|"delete", u, v[, w])`` edit."""
        op = edit[0]
        if op == "add":
            self.add_edge(edit[1], edit[2], edit[3])
        elif op == "update":
            self.update_edge(edit[1], edit[2], edit[3])
        elif op == "delete":
            self.delete_edge(edit[1], edit[2])
        else:
            raise ValueError(f"unknown edit op {op!r}; "
                             "expected add/update/delete")

    # -- versioning -------------------------------------------------------

    def staged_ops(self) -> Optional[dict]:
        """Shallow copy of the staged operands without forcing staging (None
        if :meth:`dyn_ops` was never called).  ``commit()`` swaps fresh
        tensors into the live dict, so a caller that needs the pre-commit
        version takes this copy before committing."""
        return dict(self._dops) if self._dops else None

    def rollback(self) -> int:
        """Undo every uncommitted edit (restore each touched edge to its
        weight at batch start) and clear the pending record.  Returns the
        number of edges restored."""
        pending, self._pending = self._pending, {}
        for (u, v), w_old in pending.items():
            w = np.float32(w_old)
            self._set_arc(u, v, w)
            if not self.directed:
                self._set_arc(v, u, w)
        return len(pending)

    def commit(self) -> MutationBatch:
        """Publish the pending edits as a new version: coalesced per edge
        (an add and a delete in one batch cancel), the version bumped and
        the mutable tensors restaged only when something changed, then a
        compaction once the live overlay passed ``compact_threshold``."""
        records = []
        for (u, v), w_old in self._pending.items():
            w_new = self.weight_of(u, v)
            if not (w_new == w_old
                    or (np.isinf(w_new) and np.isinf(w_old))):
                records.append(EdgeDelta(u, v, float(w_old), float(w_new)))
        self._pending.clear()
        if not records:
            return MutationBatch(self._version, self._version, ())
        old = self._version
        self._version += 1
        self._snapshot = None
        if (self.compact_threshold is not None
                and len(self._ov_pos) > self.compact_threshold):
            self.compact()              # drops the staged operands
        elif self._dops is not None:
            self._restage_mutable()
        return MutationBatch(old, self._version, tuple(records))

    def compact(self) -> CsrGraph:
        """Fold the overlay and tombstones into a fresh frozen base (the same
        graph and version, another representation).  The staged operands
        are dropped and staged again on next use with the new shapes."""
        new_base = self.snapshot()
        self._rebind_base(new_base)
        self._dops = None
        self._snapshot = new_base
        self.compactions += 1
        return new_base

    def snapshot(self) -> CsrGraph:
        """The current version as a plain frozen :class:`CsrGraph`, memoized
        per version."""
        if self._snapshot is not None:
            return self._snapshot
        live = np.isfinite(self._in_w)
        src = np.asarray(self.base.indices)[live]
        dst = self.base.dst_ids()[live]
        w = self._in_w[live]
        ov_live = self._ov_dst < self.n
        order = _by_dst_then_src(src, dst, self._ov_src[ov_live],
                                 self._ov_dst[ov_live], self.n)
        if ov_live.any():
            src = np.concatenate([src, self._ov_src[ov_live]])
            dst = np.concatenate([dst, self._ov_dst[ov_live]])
            w = np.concatenate([w, self._ov_w[ov_live]])
        dst = dst.astype(np.int64)[order]
        counts = np.bincount(dst, minlength=self.n)
        indptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        self._snapshot = CsrGraph(
            indptr=indptr, indices=src[order].astype(np.int32),
            weights=w[order].astype(np.float32), n=self.n,
            directed=self.directed)
        return self._snapshot

    # -- device staging ---------------------------------------------------

    def dyn_ops(self, *, device="cuda") -> dict:
        """Operands of the dynamic engines (dynamic/repair.py) on
        ``device``: the incoming arcs ``src`` / ``dst`` (int64) with ``w``
        the effective weights, the incoming and outgoing row offsets
        ``in_indptr`` / ``out_indptr`` (int32, one extra trailing entry so
        the id n indexes an empty row, as in ``frontier_operands``),
        ``out_dst`` (int32) with ``out_w``, and the overlay triple
        ``ov_src`` / ``ov_dst`` (int64) and ``ov_w``.  Staged on first use
        and again after a compaction or on another device; ``commit()``
        swaps in fresh weight and overlay tensors, the index tensors stay."""
        from repro_torch.core.api import resolve_device

        dev = resolve_device(device)
        if self._dops is None or dev != self._device:
            base = self.base
            in_indptr = np.concatenate([base.indptr, base.indptr[-1:]])
            out_indptr = np.concatenate([self._out_indptr,
                                         self._out_indptr[-1:]])
            i32, i64 = torch.int32, torch.int64
            self._device = dev
            self._dops = {
                "src": torch.tensor(base.indices, dtype=i64, device=dev),
                "dst": torch.tensor(base.dst_ids(), dtype=i64, device=dev),
                "in_indptr": torch.tensor(in_indptr, dtype=i32, device=dev),
                "out_indptr": torch.tensor(out_indptr, dtype=i32,
                                           device=dev),
                "out_dst": torch.tensor(self._out_dst, dtype=i32,
                                        device=dev),
            }
            self._restage_mutable()
        return self._dops

    def _restage_mutable(self) -> None:
        # torch.tensor copies.  torch.from_numpy and torch.as_tensor would
        # alias these five host mirrors on the CPU, and later edits write
        # them in place: a staged version (and the pre-commit copy that
        # staged_ops() hands out) would change under its holder.
        dev, i64 = self._device, torch.int64
        self._dops.update(
            w=torch.tensor(self._in_w, device=dev),
            out_w=torch.tensor(self._out_w, device=dev),
            ov_src=torch.tensor(self._ov_src, dtype=i64, device=dev),
            ov_dst=torch.tensor(self._ov_dst, dtype=i64, device=dev),
            ov_w=torch.tensor(self._ov_w, device=dev),
        )
