"""Graph registry — named graph handles with staged views and a byte budget
(port of repro/serve/registry.py).

A query server holds a few registered graphs and answers many queries per
graph, so per-graph state that core deliberately re-derives per solve is
worth pinning here:

* the CSR container itself (``Graph`` inputs are converted once);
* the **staged device operands** — ``csr_operands`` is deliberately not
  memoized on ``CsrGraph`` (core/bellman_csr.py) because a long-lived host
  container shouldn't pin device memory; a registry entry is exactly the
  long-lived *server* object that should, so both the segment-min and the
  frontier operand dicts are staged lazily, once, on the registry's
  device and cached on the handle (the frontier dict reuses the
  segment-min tensors);
* the **landmark set** (serve/landmarks.py), built at registration with
  one batched multisource solve;
* the **vertex-partitioned view** (``CsrGraph.partitioned``) and its
  staged per-owner blocks, for graphs the dispatch policy routes to the
  sharded engines (serve/dispatch.py) — built lazily on first sharded
  solve on the registry's serving group (core/_dist.ServingGroup: the
  leader stages its own block here, every follower its own), accounted
  like every other staged view and dropped on every rank on eviction.

Memory is accounted with the containers' own byte counters (``CsrGraph.
nbytes``, ``LandmarkSet.nbytes``, ``.nbytes`` of every distinct staged
tensor) and bounded by an LRU **byte budget**: registering or staging past
the budget evicts the least-recently-used other graphs, fires the
``on_evict`` hooks (the scheduler purges the evicted graph's cache rows),
and drops the handle so its device buffers can be freed.  The most
recently touched graph is never evicted — a single graph over budget is
admitted (and flagged in ``stats()``) rather than leaving the server
empty.

Graphs registered as :class:`~repro_torch.dynamic.DynamicGraph` get
**versioned handles**: ``mutate()`` edits edges in place, commits them
as one batch, stales the landmark set only when a landmark row is
actually touched (lazy re-solve on next use), and fires the mutate
hooks through which the scheduler keeps, repairs, or invalidates the
graph's cached distance rows — see serve/scheduler.py and
dynamic/repair.py.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterable, Optional

import torch

from repro_torch.core import csr as csr_mod
from repro_torch.core import graph as graph_mod
from repro_torch.core.bellman_csr import csr_operands
from repro_torch.core.frontier import frontier_operands
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.serve.landmarks import LandmarkSet, build_landmarks


@dataclasses.dataclass
class GraphHandle:
    """One registered graph: the CSR container plus lazily staged views on
    ``device``.

    A graph registered as a :class:`~repro_torch.dynamic.DynamicGraph`
    makes the handle **versioned**: ``version`` tracks the overlay's
    committed mutation batches, both operand views resolve to the
    overlay's fixed-shape tensors, the ``*_sweep_fn`` accessors return the
    dynamic sweeps the engines need on those operands, and ``row_key``
    scopes cache rows to ``(name, version, source)`` so a stale version's
    row can never answer a query against a newer graph.
    """

    name: str
    device: torch.device
    # static container; None for dynamic handles (whose container is
    # dyn.base and is REBOUND by compaction — pinning it here would both
    # retain the pre-compaction base forever and hide it from nbytes)
    cg: Optional[csr_mod.CsrGraph] = None
    landmarks: Optional[LandmarkSet] = None
    dyn: Optional[object] = None               # dynamic.DynamicGraph
    landmarks_stale: bool = False
    landmark_refreshes: int = 0
    landmark_seed: int = 0
    group: Optional[object] = None             # core/_dist.ServingGroup
    _csr_ops: Optional[dict] = dataclasses.field(default=None, repr=False)
    _frontier_ops: Optional[dict] = dataclasses.field(default=None,
                                                      repr=False)
    # vertex-partitioned view + its staged blocks (sharded serving path,
    # serve/dispatch.py); keyed by nprocs — a policy change restages.
    # The leader's block is here, the followers' are in their processes
    # under ``_partition_slot`` and only their bytes are known here.
    _partition: Optional[csr_mod.CsrPartition] = dataclasses.field(
        default=None, repr=False)
    _partition_ops: Optional[dict] = dataclasses.field(default=None,
                                                       repr=False)
    _partition_nprocs: int = 0
    _partition_slot: Optional[int] = None
    _partition_remote_bytes: int = 0

    @property
    def n(self) -> int:
        return self.dyn.n if self.dyn is not None else self.cg.n

    @property
    def m(self) -> int:
        """Stored arc count at the current version (live arcs for
        dynamic overlays) — the edge-size axis of a solve's cost record."""
        return (self.dyn.nnz_live if self.dyn is not None
                else self.cg.nnz)

    @property
    def version(self) -> int:
        """Committed mutation-batch count (0 for static graphs)."""
        return self.dyn.version if self.dyn is not None else 0

    def owner_shard(self, source: int, nprocs: int) -> int:
        """Owner block of ``source`` under the contiguous 1-D vertex
        partition (``CsrGraph.partitioned``): source // ceil(n/P)."""
        return int(source) // -(-self.n // int(nprocs))

    def row_key(self, source: int, *, shards: int = 1) -> tuple:
        """Cache key for this graph's ``source`` row at the CURRENT
        version.  Static graphs keep the plain ``(name, source)`` form;
        dynamic graphs interpose the version so every mutation batch
        implicitly retires the old keys (survivors are re-keyed by the
        scheduler's selective-invalidation hook).

        ``shards>1`` (sharded-routed graphs) interposes the source's
        OWNER SHARD instead — ``(name, shard, source)`` — so cache scans
        and future tiering can group a graph's rows by the device block
        that produced them (arXiv 1505.05033's rows-live-with-their-owner
        locality).  The scheduler derives ``shards`` from the dispatch
        policy's pure size check, never from staged state, so the key
        shape is deterministic from the first tick.  Dynamic graphs never
        shard (serve/dispatch.py), so the two extended forms don't
        collide."""
        if self.dyn is None:
            if shards > 1:
                return (self.name, self.owner_shard(source, shards), source)
            return (self.name, source)
        return (self.name, self.dyn.version, source)

    def csr_ops(self) -> dict:
        """Staged segment-min operands (multisource / bellman_csr path).
        Dynamic handles resolve to the overlay operand dict, a superset
        of the static pytree with effective weights."""
        if self.dyn is not None:
            return self.dyn.dyn_ops(device=self.device)
        if self._csr_ops is None:
            self._csr_ops = csr_operands(self.cg, device=self.device)
        return self._csr_ops

    def frontier_ops(self) -> dict:
        """Staged frontier operands (the ``target=`` point-to-point path).
        Supersets csr_ops, whose staged tensors are reused — only the
        outgoing views are uploaded on top."""
        if self.dyn is not None:
            return self.dyn.dyn_ops(device=self.device)
        if self._frontier_ops is None:
            self._frontier_ops = frontier_operands(
                self.cg, device=self.device, base_ops=self.csr_ops())
        return self._frontier_ops

    def partition(self, nprocs: int) -> csr_mod.CsrPartition:
        """The handle's vertex-partitioned view for ``nprocs`` owners,
        built once and pinned (the sharded serving path's analogue of the
        staged operand dicts); a new arity drops the staged blocks of the
        old one.  Dynamic graphs refuse: a CsrPartition freezes the arc
        set, so the overlay's in-place mutations would silently stop
        reaching sharded answers."""
        if self.dyn is not None:
            raise ValueError(
                f"graph {self.name!r} is dynamic; the sharded engines "
                "run on a frozen CsrPartition and never serve dynamic "
                "graphs (serve/dispatch.py pins them single-device)")
        nprocs = int(nprocs)
        if self._partition is None or self._partition_nprocs != nprocs:
            self.drop_partition()
            self._partition = self.cg.partitioned(nprocs)
            self._partition_nprocs = nprocs
        return self._partition

    def partition_ops(self, nprocs: int) -> dict:
        """The leader's staged block of :meth:`partition`, staged once on
        every rank of the registry's serving group (each follower stages
        its own block and reports its bytes) so every sharded solve after
        the first skips the upload.  Raises ``ValueError`` without a
        serving group, or when ``nprocs`` is not the group's size."""
        parts = self.partition(nprocs)
        if self._partition_ops is None:
            if self.group is None:
                raise ValueError(
                    f"graph {self.name!r}: staging a partition needs a "
                    "serving group (GraphRegistry(group=...))")
            slot, ops, sizes = self.group.stage(parts, self.cg)
            self._partition_slot, self._partition_ops = slot, ops
            self._partition_remote_bytes = sum(sizes[1:])
        return self._partition_ops

    @property
    def partition_slot(self) -> Optional[int]:
        """The serving group's slot of the staged partition, or None."""
        return self._partition_slot

    def drop_partition(self) -> None:
        """Free the staged blocks on every rank (the view stays)."""
        if self._partition_slot is not None:
            self.group.drop(self._partition_slot)
        self._partition_ops = self._partition_slot = None
        self._partition_remote_bytes = 0

    def multisource_sweep_fn(self):
        """``sweep_fn`` the batched engine needs on this handle's operands
        (None = the engine's static default)."""
        if self.dyn is None:
            return None
        from repro_torch.dynamic.repair import dynamic_segment_sweep_multi

        return dynamic_segment_sweep_multi

    def frontier_sweep_fn(self):
        """``sweep_fn`` the frontier engine needs on this handle's
        operands: the overlay sweep for a dynamic handle; for a static one
        the ``frontier_relax`` kernel's sweep on a CUDA device, None (the
        engine's plain default) on the CPU."""
        if self.dyn is not None:
            from repro_torch.dynamic.repair import make_dynamic_flat_sweep_fn

            return make_dynamic_flat_sweep_fn()
        if self.device.type == "cuda":
            from repro_torch.kernels.frontier_relax.ops import \
                make_frontier_sweep_fn

            return make_frontier_sweep_fn()
        return None

    def landmarks_ready(self) -> Optional[LandmarkSet]:
        """The landmark set, lazily re-solved if a mutation staled it —
        the deferred half of the mutate() contract: staling is O(K) host
        tests at mutation time, the K-source re-solve only happens when a
        query actually consults the bounds (same ids, new version)."""
        if self.landmarks is not None and self.landmarks_stale:
            self.landmarks = build_landmarks(
                self.dyn if self.dyn is not None else self.cg,
                self.landmarks.k, csr_ops=self.csr_ops(),
                ids=self.landmarks.ids,
                sweep_fn=self.multisource_sweep_fn())
            self.landmarks_stale = False
            self.landmark_refreshes += 1
        return self.landmarks

    @property
    def nbytes(self) -> int:
        """Host container + landmark rows + every distinct staged tensor
        (frontier_ops shares csr_ops' tensors; each buffer, keyed by its
        address and size, is counted once).  Dynamic handles account the
        overlay's host mirrors and staged tensors through the overlay's own
        counters."""
        if self.dyn is not None:
            total = self.dyn.nbytes + self.dyn.staged_nbytes
        else:
            total = self.cg.nbytes
        if self.landmarks is not None:
            total += self.landmarks.nbytes
        if self._partition is not None:
            total += self._partition.nbytes      # host view (all owners)
        total += self._partition_remote_bytes    # the followers' blocks
        seen = set()
        for ops in (self._csr_ops, self._frontier_ops, self._partition_ops):
            if ops:
                seen.update((t.data_ptr(), t.nbytes) for t in ops.values())
        return total + sum(size for _, size in seen)


class GraphRegistry:
    """LRU-evicting map of name -> :class:`GraphHandle`, every handle
    staged on ``device`` (``"cuda"`` needs a GPU and raises without one).
    ``group``, a core/_dist.ServingGroup whose leader runs on ``device``,
    is where sharded-routed graphs stage their partitions.

    ``byte_budget=None`` disables eviction (the registry still accounts
    bytes).  ``on_evict(name)`` callbacks run for every evicted graph.

    Counters live on a `MetricsRegistry` (own instance by default, or a
    shared one via ``metrics=``) under the ``registry.*`` namespace; the
    legacy attributes and ``stats()`` dict are views over it.
    """

    def __init__(self, byte_budget: Optional[int] = None,
                 metrics: Optional[MetricsRegistry] = None, *,
                 device="cuda", group=None):
        from repro_torch.core.api import resolve_device

        self.device = resolve_device(device)
        if group is not None and group.device.type != self.device.type:
            raise ValueError(f"serving group on {group.device}, registry "
                             f"on {self.device}")
        self.group = group
        self.byte_budget = byte_budget
        self._graphs: "collections.OrderedDict[str, GraphHandle]" = (
            collections.OrderedDict())
        self._on_evict: list[Callable[[str], None]] = []
        self._on_mutate: list[Callable] = []
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._registered = self.metrics.counter("registry.registered")
        self._evicted = self.metrics.counter("registry.evicted")
        self._mutations = self.metrics.counter("registry.mutations")
        self._edges_mutated = self.metrics.counter("registry.edges_mutated")
        self.metrics.gauge("registry.graphs", fn=lambda: len(self._graphs))

    @property
    def registered(self) -> int:
        return self._registered.value

    @property
    def evicted(self) -> int:
        return self._evicted.value

    @property
    def mutations(self) -> int:
        return self._mutations.value

    @property
    def edges_mutated(self) -> int:
        return self._edges_mutated.value

    def __len__(self) -> int:
        return len(self._graphs)

    def __contains__(self, name: str) -> bool:
        return name in self._graphs

    @property
    def names(self) -> tuple:
        return tuple(self._graphs)

    @property
    def bytes_in_use(self) -> int:
        return sum(h.nbytes for h in self._graphs.values())

    def add_evict_hook(self, fn: Callable[[str], None]) -> None:
        self._on_evict.append(fn)

    def add_mutate_hook(self, fn: Callable) -> None:
        """``fn(name, handle, batch, old_ops)`` runs after every committed
        mutation batch: ``batch`` is the overlay's MutationBatch and
        ``old_ops`` the PRE-commit staged operands (None if the graph was
        never staged) — commit swaps fresh tensors into the live dict and
        never writes the old ones, so holding the old dict long enough to
        recover predecessor trees against the previous version is free.  The scheduler's selective cache
        invalidation/repair lives here."""
        self._on_mutate.append(fn)

    def register(
        self,
        name: str,
        g: "graph_mod.Graph | csr_mod.CsrGraph | object",
        *,
        landmarks: int = 0,
        landmark_seed: int = 0,
    ) -> GraphHandle:
        """Admit a graph under ``name`` (replacing any previous holder of
        the name, which counts as an eviction).  ``landmarks=K`` runs the
        one-time ALT precompute (serve/landmarks.py) before admission.
        A :class:`~repro_torch.dynamic.DynamicGraph` is admitted as a versioned
        mutable handle (see GraphHandle) whose edges ``mutate()`` can
        edit in place."""
        from repro_torch.dynamic.overlay import DynamicGraph

        if isinstance(g, DynamicGraph):
            handle = GraphHandle(name=name, device=self.device, dyn=g)
        else:
            cg = g if isinstance(g, csr_mod.CsrGraph) else g.to_csr()
            handle = GraphHandle(name=name, device=self.device, cg=cg,
                                 group=self.group)
        handle.landmark_seed = landmark_seed
        if landmarks:
            handle.landmarks = build_landmarks(
                handle.dyn if handle.dyn is not None else handle.cg,
                landmarks, seed=landmark_seed, csr_ops=handle.csr_ops(),
                sweep_fn=handle.multisource_sweep_fn())
        if name in self._graphs:
            self._evict(name)
        self._graphs[name] = handle
        self._registered.inc()
        self._maybe_evict()
        return handle

    def mutate(self, name: str, edits: Iterable[tuple]) -> "object":
        """Apply one batch of edge edits to a dynamic graph and publish
        the new version.

        ``edits`` is an iterable of ``("add"|"update"|"delete", u, v[,
        w])`` tuples, applied in order and committed as ONE batch (the
        repair granularity).  On commit: the landmark set is staled only
        if some landmark row is actually affected (the O(K·batch) host
        tightness test of dynamic/repair.row_affected) and re-solved
        lazily on next use; the mutate hooks then run with the pre-commit
        operands so the scheduler can keep/repair/invalidate cache rows
        per source (see add_mutate_hook).  Returns the MutationBatch.
        """
        from repro_torch.dynamic.repair import row_affected

        if name not in self._graphs:
            raise KeyError(f"graph {name!r} is not registered")
        handle = self._graphs[name]
        self._graphs.move_to_end(name)
        if handle.dyn is None:
            raise ValueError(
                f"graph {name!r} is static; register a DynamicGraph to "
                "mutate it")
        # pre-commit staged view (or None): commit swaps buffers into the
        # live operand dict in place, and the mutate hooks need the
        # previous version's buffers to recover pred trees for repair.
        old_ops = handle.dyn.staged_ops()
        try:
            for edit in edits:
                handle.dyn.apply(edit)
        except Exception:
            # a bad edit mid-batch must not leak the earlier edits into
            # the next commit: the batch applies atomically or not at all
            handle.dyn.rollback()
            raise
        batch = handle.dyn.commit()
        if batch.records:
            self._mutations.inc()
            self._edges_mutated.inc(len(batch.records))
            ls = handle.landmarks
            if ls is not None and not handle.landmarks_stale:
                handle.landmarks_stale = any(
                    row_affected(ls.D[k], batch, handle.dyn.directed)
                    for k in range(ls.k))
            for fn in self._on_mutate:
                fn(name, handle, batch, old_ops)
            self._maybe_evict()             # restaged buffers may have grown
        return batch

    def get(self, name: str) -> GraphHandle:
        """Fetch a handle, refreshing its LRU recency."""
        if name not in self._graphs:
            raise KeyError(
                f"graph {name!r} is not registered (evicted or never "
                f"admitted); registered: {list(self._graphs)}")
        self._graphs.move_to_end(name)
        return self._graphs[name]

    def touch_staged(self, name: str) -> None:
        """Re-run the budget check after a handle staged new device views
        (scheduler calls this after csr_ops()/frontier_ops() grow)."""
        if name in self._graphs:
            self._maybe_evict()

    def evict(self, name: str) -> None:
        """Force-evict one graph by name (administrative / chaos-harness
        seam; LRU budget eviction happens automatically).  Fires the
        evict hooks like any budget eviction; unknown names are a no-op
        so a racing double-evict stays idempotent."""
        if name in self._graphs:
            self._evict(name)

    def _evict(self, name: str) -> None:
        self._graphs.pop(name).drop_partition()
        self._evicted.inc()
        for fn in self._on_evict:
            fn(name)

    def _maybe_evict(self) -> None:
        if self.byte_budget is None:
            return
        # never evict the most recently touched graph: a lone over-budget
        # graph is admitted (visible via stats()['over_budget']).
        while len(self._graphs) > 1 and self.bytes_in_use > self.byte_budget:
            lru = next(iter(self._graphs))
            self._evict(lru)

    def stats(self) -> dict:
        """Legacy flat view; the event counts also appear in
        ``metrics.snapshot()`` under the ``registry.*`` namespace."""
        return {
            "graphs": len(self._graphs),
            "bytes_in_use": self.bytes_in_use,
            "byte_budget": self.byte_budget,
            "over_budget": (self.byte_budget is not None
                            and self.bytes_in_use > self.byte_budget),
            "registered": self.registered,
            "evicted": self.evicted,
            "mutations": self.mutations,
            "edges_mutated": self.edges_mutated,
            "landmark_refreshes": sum(h.landmark_refreshes
                                      for h in self._graphs.values()),
        }
