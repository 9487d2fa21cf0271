"""Micro-batching query scheduler — queue -> dedup -> bucket-padded solve
(port of repro/serve/scheduler.py: the same ticks, answers, counters and
snapshots on the same seeded trace).

The serving loop that turns the batched ``multisource_csr`` engine (so far
only exercised by benchmarks) into a query server.  Each ``tick()``:

1. drains the request queue and groups queries by graph;
2. answers what it can **without an engine**: trivial ``dist(s, s)``,
   cached source rows (serve/cache.py), landmark source rows and
   landmark-proven disconnection (serve/landmarks.py) — always from the
   query's own source direction, see ``_try_fast``;
3. **deduplicates** the remaining sources — fifty queries against one hot
   source cost one solved row — and coalesces up to ``max_batch`` distinct
   sources into ONE ``multisource_csr`` solve, **padding** the source axis
   up to a bucket size (powers of two) by repeating the first source.  Eager
   PyTorch compiles nothing per shape, but the buckets are kept so that
   ``batch``, occupancy and the ``sched.*`` counters equal the JAX
   scheduler's;
4. fans the solved rows back out to every waiting query and inserts them
   into the distance cache.

A tick whose residue is a single point-to-point query takes the
**target early-exit path** instead: one frontier solve with ``target=``
(core/frontier.py) sharpened by the landmark lower bound — the solve
stops once the target's label is provably final.  Its row is partial by
construction, so it is never cached.  On a CUDA registry a static
graph's frontier sweep is the ``frontier_relax`` kernel
(``GraphHandle.frontier_sweep_fn``).

Engine SELECTION routes through the dispatch seam (serve/dispatch.py).
Graphs the policy would shard (at or above its shard threshold, with
ranks to shard across) solve on the vertex-partitioned engines through
the registry's serving group (core/_dist.ServingGroup): this process is
its leader rank and drives the follower ranks, so the scheduler works in
process as JAX's does over a mesh.  A batch runs
``multisource_csr_sharded`` on the padded bucket; a point-to-point query
runs ``frontier_sharded`` to its FULL fixpoint (no early exit across
owners) and its complete row is cached, which a partial ``target=`` row
never is.  Sharded rows are cached under ``(name, owner shard, source)``
keys, the shard arity coming from the policy's pure size check.  A
policy that would shard without a serving group is refused when the
scheduler is built; a broken group (a rank died or raised) answers its
queries ``GroupBroken`` at once while single-device graphs go on serving.

Every path returns bytes some engine solved (or a bound that *proves* the
value), so served answers stay bitwise-equal to per-query ``serial``
solves — the invariant tests/test_serve.py and the --smoke driver verify.

Graphs registered as :class:`~repro_torch.dynamic.DynamicGraph` additionally
accept **mutation ticks**: ``submit_mutation`` queues edge edits that
``tick()`` applies BEFORE the tick's queries, one committed batch per
graph.  The registry's mutate hook then reconciles the distance cache
per row — rows no delta can touch are re-keyed to the new version
untouched, up to ``repair_rows`` hot rows are repaired incrementally
(dynamic/repair.py), the rest invalidated (or retained under their OLD
version key as degraded-serving candidates, see below) — and the
landmark set stales lazily.  Engine paths pick up each handle's dynamic
sweeps so solves run on the mutable overlay operands directly,
preserving the bitwise guarantee against the mutated snapshot.

**Fault tolerance** (serve/errors.py is the taxonomy):

* ``submit()`` validates eagerly (graph name, non-negative in-range
  integer endpoints, deadline sanity) and raises ``QueryRejected``
  instead of poisoning a later tick; with ``max_queue=`` set, a
  saturated queue rejects the newcomer or sheds the cheapest-to-
  recompute queued work (p2p before full rows, newest first) —
  reject-on-saturation backpressure.
* every post-admission failure becomes a per-query ``Answer`` with a
  typed ``status`` (``graph_gone``, ``deadline_exceeded``,
  ``solve_failed``, ``not_converged``) rather than an exception across
  the tick; transient solve/staging failures are retried with capped
  exponential backoff (``retry_budget`` attempts per query, backoff
  measured in ticks).
* ``tick(now=...)`` answers already-expired queries
  ``deadline_exceeded`` before solving; under deadline pressure
  (``deadline - now <= degrade_margin``, or admission overflow on a
  deadlined query) p2p queries may be served from ALT landmark
  lower/upper bounds and full-row queries from a stale-but-versioned
  cache row — always ``exact=False``, via="degraded": the bitwise
  exactness invariant binds only answers claiming ``exact=True``.
* a non-``converged`` engine result (``max_sweeps`` cap) is answered
  ``not_converged`` and its rows are never cached — no silent wrong
  answers.
* ``drain()`` has a progress guard: a tick that had eligible work but
  served zero and retired zero raises ``SchedulerStalled`` instead of
  looping forever.
* ``faults=`` accepts a serve/faults.FaultPlan whose seeded schedule is
  probed at the existing seams (solve, staging, mid-tick eviction,
  mutation rollback, sweep clipping) — a chaos replay.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core.bellman_csr import sssp_multisource_csr
from repro_torch.core.frontier import sssp_frontier
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.profile import backend_info, get_cost_log
from repro_torch.obs.trace import get_tracer
from repro_torch.serve.cache import DistanceCache
from repro_torch.serve.dispatch import DispatchPolicy, default_policy
from repro_torch.serve.errors import (STATUS_OK, DeadlineExceeded, GraphGone,
                                      GroupBroken, NotConverged,
                                      QueryRejected, SchedulerStalled,
                                      ServeError, SolveFailed)
from repro_torch.serve.registry import GraphRegistry

VIAS = ("trivial", "cache", "landmark", "batch", "target", "mutate",
        "degraded", "error")


@dataclasses.dataclass
class Query:
    """One request: ``target is None`` => full ``sssp(source)`` row,
    else a point-to-point ``dist(source, target)`` scalar.  ``deadline``
    (same clock as ``arrival``) makes the query droppable once passed;
    ``attempts``/``not_before`` are the retry-backoff state (a query
    whose solve failed is ineligible until tick ``not_before``)."""

    qid: int
    graph: str
    source: int
    target: Optional[int] = None
    arrival: float = 0.0
    deadline: Optional[float] = None
    attempts: int = 0
    not_before: int = 0


@dataclasses.dataclass
class Mutation:
    """One edge-edit request against a dynamic graph: ``edit`` is the
    registry wire tuple ``("add"|"update"|"delete", u, v[, w])``.  All of
    a graph's mutations drained in one tick commit as ONE version bump
    (the repair batch granularity)."""

    qid: int
    graph: str
    edit: tuple
    arrival: float = 0.0


@dataclasses.dataclass
class Answer:
    query: "Query | Mutation"
    value: "np.ndarray | float | int | None"  # (n,) row for sssp, float
                                        # for dist, new version int for
                                        # mutate; None iff via == "error"
    via: str                            # one of VIAS
    done_at: float = 0.0                # stamped by the driver (wall clock)
    status: str = STATUS_OK             # STATUS_OK or a ServeError code
    exact: bool = True                  # True => bitwise-equal-to-serial
                                        # guarantee applies to ``value``
    error: Optional[ServeError] = None  # the typed failure, iff not ok
    bounds: Optional[tuple] = None      # (lb, ub) for degraded p2p answers
    service_start: Optional[float] = None   # clock at which the answering
                                        # tick began (tick(now=...)); the
                                        # queue-wait / service-time pivot
                                        # for workload.LatencyRecorder

    @property
    def ok(self) -> bool:
        return self.status == STATUS_OK


class MicroBatchScheduler:
    """See module docstring.  ``max_batch`` caps distinct sources per
    tick per graph (overflow is requeued ahead of newer arrivals);
    ``p2p_solo=False`` disables the target early-exit path (everything
    residual goes through the batched engine).

    Robustness knobs (all optional; defaults preserve the permissive
    pre-fault-tolerance behavior except eager submit validation, which
    is always on):

    ``max_queue``
        Bounded-queue admission: a submit that would push the query
        queue past this raises :class:`QueryRejected` — unless a
        cheaper-to-recompute queued query (a p2p, newest first) can be
        shed in its favor, acked ``rejected`` on the next tick.
    ``retry_budget`` / ``backoff_cap``
        A query whose solve raised is requeued with capped exponential
        backoff (``2**(attempts-1)`` ticks, capped) up to
        ``retry_budget`` attempts, then answered ``solve_failed``.
    ``max_sweeps``
        Fixpoint-sweep cap passed to every engine solve; a capped
        non-converged result is answered ``not_converged`` and its rows
        are never cached.
    ``degrade`` / ``degrade_margin``
        Inexact fallbacks under deadline pressure: p2p from landmark
        bounds, full rows from a stale-version cache row (retained by
        the mutate hook when ``degrade`` is on).  ``degrade_margin`` is
        the seconds-to-deadline threshold below which an admitted query
        is degraded pre-solve (0.0 = only admission overflow degrades).
    ``faults``
        A serve/faults.FaultPlan probed at the solve / stage / evict /
        mutate / clip seams (chaos harness).

    All event counters live on a `MetricsRegistry` under the ``sched.*``
    namespace (``metrics=`` shares one across components; the default is
    a fresh instance per scheduler so two schedulers never alias).  The
    legacy plain-attribute reads (``sched.engine_batches`` ...) resolve
    through ``__getattr__`` onto the registry, ``stats()`` keeps its
    historical shape, and ``snapshot()`` is the uniform merged view of
    scheduler + cache + registry series.
    """

    # every legacy int counter, now one sched.* series each
    _COUNTER_NAMES = (
        "ticks", "engine_batches", "engine_sources", "sharded_batches",
        "sharded_p2p", "sharded_sources", "sharded_edges", "target_solves",
        "dedup_saved", "rows_kept", "rows_repaired", "rows_invalidated",
        "rows_staled", "repair_edges", "submissions_rejected", "shed",
        "deadline_expired", "degraded_p2p", "degraded_batch",
        "solve_exceptions", "retries", "not_converged",
    )

    def __init__(
        self,
        registry: GraphRegistry,
        cache: DistanceCache,
        *,
        max_batch: int = 16,
        p2p_solo: bool = True,
        repair_rows: int = 8,
        dispatch: Optional[DispatchPolicy] = None,
        max_queue: Optional[int] = None,
        retry_budget: int = 2,
        backoff_cap: int = 8,
        max_sweeps: Optional[int] = None,
        degrade: bool = True,
        degrade_margin: float = 0.0,
        faults=None,
        metrics: Optional[MetricsRegistry] = None,
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if retry_budget < 0:
            raise ValueError(f"retry_budget must be >= 0, got {retry_budget}")
        self.registry = registry
        self.cache = cache
        self.max_batch = max_batch
        self.p2p_solo = p2p_solo
        self.repair_rows = repair_rows
        self.dispatch = (dispatch if dispatch is not None
                         else default_policy(registry.device))
        self._check_group(registry, self.dispatch)
        self.max_queue = max_queue
        self.retry_budget = retry_budget
        self.backoff_cap = backoff_cap
        self.max_sweeps = max_sweeps
        self.degrade = degrade
        self.degrade_margin = float(degrade_margin)
        self.faults = faults
        registry.add_evict_hook(cache.purge_graph)
        registry.add_mutate_hook(self._on_mutate)
        self._queue: "collections.deque[Query]" = collections.deque()
        self._mutations: "collections.deque[Mutation]" = collections.deque()
        self._next_qid = 0
        # one sched.* series per legacy counter; __getattr__ serves the
        # old plain-attribute reads from these.
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._c = {name: self.metrics.counter(f"sched.{name}")
                   for name in self._COUNTER_NAMES}
        # running sum of per-batch occupancy (distinct/bucket) plus the
        # last observed value as the per-tick occupancy gauge
        self._occ_sum = self.metrics.gauge("sched.occupancy_sum")
        self._occ_last = self.metrics.gauge("sched.occupancy")
        self._via = {v: self.metrics.counter("sched.answered", via=v)
                     for v in VIAS}
        self.last_mutation_error: Optional[str] = None
        self._shed_acks: list = []          # delivered at next tick's start
        self._last_tick_stalled = False     # drain()'s progress-guard flag

    @staticmethod
    def _check_group(registry, dispatch) -> None:
        """A policy that can route sharded needs the registry's serving
        group, of the policy's arity, to stage and solve on: refuse it
        here rather than in the middle of a tick."""
        if not (dispatch.nprocs > 1
                and dispatch.shard_threshold is not None):
            return
        group = getattr(dispatch, "group", None)
        if group is None or group is not registry.group:
            raise ValueError(
                f"the dispatch policy shards across {dispatch.nprocs} "
                "ranks but has no serving group, or not the registry's: "
                "open one (core/_dist.open_serving_group) and pass it to "
                "both GraphRegistry(group=) and the policy (group=)")
        if group.size != dispatch.nprocs:
            raise ValueError(f"the policy shards across {dispatch.nprocs} "
                             f"ranks, its serving group has {group.size}")

    def __getattr__(self, name: str):
        # legacy counter attributes (sched.ticks, sched.engine_batches,
        # ...) read straight off the metrics registry
        c = self.__dict__.get("_c")
        if c is not None and name in c:
            return c[name].value
        raise AttributeError(
            f"{type(self).__name__!r} object has no attribute {name!r}")

    @property
    def occupancy_sum(self) -> float:
        return self._occ_sum.value

    @property
    def answered_via(self) -> dict:
        return {v: c.value for v, c in self._via.items()}

    @property
    def answered_status(self) -> "collections.Counter[str]":
        out: "collections.Counter[str]" = collections.Counter()
        for s in self.metrics.find("sched.answered_status"):
            labels = dict(s.labels)
            out[labels.get("status", "?")] = s.value
        return out

    # -- queue ------------------------------------------------------------

    @staticmethod
    def _check_vertex(value, what: str) -> int:
        """Eager endpoint validation: a non-negative integer (bool is an
        int subclass but never a vertex id)."""
        if isinstance(value, bool) or not isinstance(
                value, (int, np.integer)):
            raise QueryRejected(
                f"{what} must be an integer vertex id, got "
                f"{type(value).__name__} {value!r}")
        v = int(value)
        if v < 0:
            raise QueryRejected(f"{what} must be >= 0, got {v}")
        return v

    def submit(self, graph: str, source: int, target: Optional[int] = None,
               *, arrival: float = 0.0,
               deadline: Optional[float] = None) -> Query:
        """Enqueue one query, validating EAGERLY — a malformed request
        fails its caller with :class:`QueryRejected` here instead of
        poisoning the tick that would have drained it.  Range checks run
        against the graph's current handle when it is registered; an
        unregistered name is accepted (it may be registered before the
        serving tick) and answered ``graph_gone`` at tick time if not.

        ``deadline`` (same clock as ``arrival``) marks the query
        droppable: ``tick(now=...)`` answers it ``deadline_exceeded``
        once passed, and may serve it degraded under pressure.  With
        ``max_queue`` set, a full queue either sheds a cheaper queued
        query in this one's favor or rejects this one (backpressure).
        """
        try:
            if not isinstance(graph, str) or not graph:
                raise QueryRejected(
                    f"graph must be a non-empty name string, got {graph!r}")
            src = self._check_vertex(source, "source")
            tgt = (None if target is None
                   else self._check_vertex(target, "target"))
            if deadline is not None:
                deadline = float(deadline)
                if not np.isfinite(deadline):
                    raise QueryRejected(f"deadline must be finite, got "
                                        f"{deadline!r}")
            if graph in self.registry:
                n = self.registry.get(graph).n
                for what, v in (("source", src), ("target", tgt)):
                    if v is not None and v >= n:
                        raise QueryRejected(
                            f"{what} {v} out of range for graph {graph!r} "
                            f"(n={n})")
        except QueryRejected:
            self._c["submissions_rejected"].inc()
            raise
        q = Query(qid=self._next_qid, graph=graph, source=src, target=tgt,
                  arrival=arrival, deadline=deadline)
        self._next_qid += 1
        if (self.max_queue is not None
                and len(self._queue) >= self.max_queue):
            self._admit_saturated(q)
        else:
            self._queue.append(q)
        tr = get_tracer()
        if tr.enabled:
            tr.instant("submit", qid=q.qid, graph=graph, source=src,
                       target=tgt)
        return q

    def _admit_saturated(self, q: Query) -> None:
        """Bounded-queue admission: shed the cheapest-to-recompute queued
        work — a p2p query (bounded early-exit re-solve, its partial row
        is never cached), newest first (least queue investment) — in the
        newcomer's favor; if the newcomer is itself in the cheapest
        class, reject it instead (reject-on-saturation backpressure)."""
        victim_i = None
        if q.target is None:
            for i in range(len(self._queue) - 1, -1, -1):
                if self._queue[i].target is not None:
                    victim_i = i
                    break
        if victim_i is None:
            self._c["submissions_rejected"].inc()
            raise QueryRejected(
                f"queue saturated ({self.max_queue} pending); resubmit "
                "after a tick drains")
        victim = self._queue[victim_i]
        del self._queue[victim_i]
        self._c["shed"].inc()
        err = QueryRejected(
            f"shed under saturation in favor of query {q.qid}")
        self._shed_acks.append(Answer(victim, None, "error",
                                      status=err.code, exact=False,
                                      error=err))
        self._queue.append(q)

    def submit_mutation(self, graph: str, op: str, u: int, v: int,
                        w: Optional[float] = None, *,
                        arrival: float = 0.0) -> Mutation:
        """Queue one edge edit against a dynamic graph.  Edits are
        applied at the START of the next tick (before any query drained
        in the same tick is answered), all of a graph's pending edits
        committing as one mutation batch."""
        edit = (op, int(u), int(v)) if w is None else (op, int(u), int(v),
                                                       float(w))
        m = Mutation(qid=self._next_qid, graph=graph, edit=edit,
                     arrival=arrival)
        self._next_qid += 1
        self._mutations.append(m)
        tr = get_tracer()
        if tr.enabled:
            tr.instant("submit", qid=m.qid, graph=graph, op=op)
        return m

    @property
    def pending(self) -> int:
        return len(self._queue) + len(self._mutations)

    # -- mutation ticks ---------------------------------------------------

    def _apply_mutations(self) -> list:
        """Drain the mutation queue: one ``registry.mutate`` batch per
        graph (the registry fires :meth:`_on_mutate` to reconcile the
        cache), acked with via="mutate" answers whose value is the
        graph's new version."""
        if not self._mutations:
            return []
        drained, self._mutations = list(self._mutations), collections.deque()
        by_graph: "collections.OrderedDict[str, list]" = (
            collections.OrderedDict())
        for m in drained:
            by_graph.setdefault(m.graph, []).append(m)
        acks = []
        tr = get_tracer()
        for name, muts in by_graph.items():
            edits = [m.edit for m in muts]
            if self.faults is not None and self.faults.roll(
                    "mutate", graph=name, detail="poisoned edit"):
                # chaos seam: a poisoned edit forces the registry's
                # atomic-rollback path — the whole batch must roll back
                # and every mutation in it is acked rejected.
                edits = edits + [("update", -1, -1, 1.0)]
            try:
                with tr.span("mutate", graph=name, edits=len(edits)):
                    self.registry.mutate(name, edits)
                version = self.registry.get(name).version
                acks.extend(Answer(m, version, "mutate") for m in muts)
            except (KeyError, ValueError, IndexError) as e:
                # unknown/static graph or invalid edit: fail the whole
                # graph's batch — a half-applied batch would leave the
                # trace's edge-set bookkeeping unverifiable.
                err = QueryRejected(f"mutation batch rolled back: {e}")
                acks.extend(Answer(m, None, "error", status=err.code,
                                   exact=False, error=err) for m in muts)
                self.last_mutation_error = str(e)
        return acks

    def _on_mutate(self, name, handle, batch, old_ops) -> None:
        """Registry mutate hook: reconcile this graph's cached rows with
        the new version.  Per row (hottest first): if no delta can touch
        it (dynamic/repair.row_affected) it is RE-KEYED to the new
        version untouched; otherwise up to ``repair_rows`` rows are
        REPAIRED in place (pred recovered against the pre-commit
        operands, then one incremental repair on the new ones —
        dynamic/repair.py) and the rest are invalidated — or, when
        degraded serving is on, RETAINED under their old version key as
        stale-but-versioned fallbacks (never served exact: exact lookups
        only ever consult the current version's key)."""
        if not batch.records:
            return
        tr = get_tracer()
        if not tr.enabled:
            self._reconcile_rows(name, handle, batch, old_ops)
            return
        with tr.span("repair", graph=name, version=handle.version,
                     edits=len(batch.records)) as sp:
            kept0, rep0, inv0 = (self.rows_kept, self.rows_repaired,
                                 self.rows_invalidated)
            edges0 = self.repair_edges
            self._reconcile_rows(name, handle, batch, old_ops)
            sp.set(rows_kept=self.rows_kept - kept0,
                   rows_repaired=self.rows_repaired - rep0,
                   rows_invalidated=self.rows_invalidated - inv0,
                   repair_edges=self.repair_edges - edges0)

    def _reconcile_rows(self, name, handle, batch, old_ops) -> None:
        from repro_torch.core.api import SsspResult
        from repro_torch.dynamic.repair import (
            predecessors_from_dist_dynamic, repair_sssp, row_affected)

        cl = get_cost_log()
        # walk LRU -> MRU so the re-puts (which append at the MRU end)
        # PRESERVE the graph's recency order; the repair budget still
        # goes to the hottest rows — the affected keys nearest the MRU
        # end — by slicing the affected list from its tail.  Only the
        # PRE-COMMIT version's keys are reconciled: older keys are stale
        # retainees from earlier batches (this delta says nothing about
        # their version) and are left for the LRU to age out.
        keys = self.cache.keys_for(name)
        rows = {k: self.cache.peek(k) for k in keys}
        prev_version = handle.version - 1
        current = [k for k in keys if len(k) == 3 and k[1] == prev_version]
        affected = {k for k in current
                    if row_affected(rows[k], batch, handle.dyn.directed)}
        budget = self.repair_rows if old_ops is not None else 0
        repair = set([k for k in current if k in affected][-budget:]
                     if budget else [])
        for key in current:
            source = key[-1]
            row = rows[key]
            if key not in affected:
                self.cache.pop(key)
                self.cache.put(handle.row_key(source), row)
                self._c["rows_kept"].inc()
            elif key in repair:
                self.cache.pop(key)
                t0 = time.perf_counter() if cl.enabled else 0.0
                pred = predecessors_from_dist_dynamic(
                    torch.tensor(row, device=handle.device), old_ops,
                    int(source))
                prev = SsspResult(
                    dist=row, pred=pred.cpu().numpy(), sweeps=None,
                    engine="cache", sources=np.asarray([source], np.int32))
                res, _ = repair_sssp(handle.dyn, prev, batch,
                                     device=handle.device)
                self.cache.put(handle.row_key(source), res.dist)
                self._c["rows_repaired"].inc()
                self._c["repair_edges"].inc(res.edges_relaxed or 0)
                if cl.enabled:
                    be, kind = backend_info(handle.device)
                    cl.emit(engine="repair", graph=name, n=handle.n,
                            m=handle.m, sweeps=int(res.sweeps or 0),
                            edges_relaxed=int(res.edges_relaxed or 0),
                            wall_ms=(time.perf_counter() - t0) * 1e3,
                            converged=True, backend=be, device_kind=kind)
            else:
                self._c["rows_invalidated"].inc()
                if self.degrade:
                    # retained under its OLD version key: invisible to
                    # exact lookups, available to _try_degraded.
                    self._c["rows_staled"].inc()
                else:
                    self.cache.pop(key)

    # -- dispatch ---------------------------------------------------------

    def _shards(self, handle) -> int:
        """Shard arity of this graph's cache keys: the policy's PURE size
        check (no mesh, no staging), so lookups and inserts agree on the
        key shape from the first tick onward."""
        if self.dispatch.would_shard(handle.n,
                                     dynamic=handle.dyn is not None):
            return self.dispatch.nprocs
        return 1

    def _row_key(self, handle, source: int) -> tuple:
        return handle.row_key(source, shards=self._shards(handle))

    # -- answer-without-engine paths --------------------------------------

    def _try_fast(self, handle, q: Query) -> Optional[Answer]:
        """Trivial / cache / landmark answers; None if an engine is needed.

        Only SAME-DIRECTION rows are served: an undirected graph has
        d(s, t) == d(t, s) in exact arithmetic, but f32 path sums round
        differently when traversed from the other end, so answering
        ``dist(s, t)`` from a cached/landmark *t*-row would break the
        bitwise-equal-to-serial guarantee by an ulp.  Symmetry is still
        exploited where it is exact: the landmark disconnection proof.
        """
        if q.target is not None and q.target == q.source:
            return Answer(q, 0.0, "trivial")
        row = self.cache.get(self._row_key(handle, q.source))
        if row is not None:
            val = row if q.target is None else float(row[q.target])
            return Answer(q, val, "cache")
        ls = handle.landmarks_ready()
        if ls is not None:
            row = ls.row_of(q.source)
            if row is not None:
                val = row if q.target is None else float(row[q.target])
                return Answer(q, val, "landmark")
            if (q.target is not None
                    and not np.isfinite(ls.lower_bound(q.source, q.target))):
                # some landmark reaches exactly one endpoint: s and t are
                # provably disconnected (undirected graphs only — which
                # is the only kind landmarks are built for), so inf is
                # the exact answer, no solve needed; inf is ulp-proof.
                return Answer(q, float("inf"), "landmark")
        return None

    def _try_degraded(self, handle, q: Query) -> Optional[Answer]:
        """Inexact fallback under deadline pressure; None if no degraded
        source exists (the query then solves, or expires).

        p2p: the ALT landmark bracket — value is the UPPER bound (a real
        path length through the best landmark, so always achievable),
        with ``bounds=(lb, ub)`` attached.  Full row: the most recently
        used stale-version cache row for this source (dynamic graphs
        whose mutate hook retained it).  Both are ``exact=False`` with
        status "ok" — approximate, not failed."""
        if not self.degrade:
            return None
        if q.target is not None:
            ls = handle.landmarks_ready()
            if ls is None:
                return None
            ub = ls.upper_bound(q.source, q.target)
            if not np.isfinite(ub):
                return None
            lb = ls.lower_bound(q.source, q.target)
            self._c["degraded_p2p"].inc()
            return Answer(q, float(ub), "degraded", exact=False,
                          bounds=(float(lb), float(ub)))
        if handle.dyn is None:
            return None
        for key in reversed(self.cache.keys_for(handle.name)):  # MRU first
            if (len(key) == 3 and key[2] == q.source
                    and key[1] != handle.version):
                self._c["degraded_batch"].inc()
                return Answer(q, self.cache.peek(key), "degraded",
                              exact=False)
        return None

    # -- engine paths -----------------------------------------------------

    def _bucket(self, count: int, cap: Optional[int] = None) -> int:
        """Smallest power of two >= count, clamped to max_batch — JAX's
        source-axis sizes (there they keep repeat ticks on one compiled
        solve; here they keep ``batch`` and occupancy equal).  ``cap`` (a
        policy's calibrated ``EngineChoice.batch_cap``) tightens the clamp
        further, but never below ``count`` — every admitted distinct
        source must fit."""
        b = 1
        while b < count:
            b *= 2
        b = min(b, self.max_batch)
        if cap is not None:
            b = max(count, min(b, int(cap)))
        return b

    def _admission_limit(self, handle) -> int:
        """Distinct sources admitted per tick for ``handle``: the
        scheduler's ``max_batch`` tightened by the dispatch policy's
        calibrated per-graph bucket ceiling (``DispatchPolicy.batch_cap``
        — None from the threshold policy, the measured-best B from a
        tuned one)."""
        cap = self.dispatch.batch_cap(handle)
        if cap is None:
            return self.max_batch
        return max(1, min(self.max_batch, int(cap)))

    def _probe(self, site: str, name: str) -> None:
        """Fault-plan probe at a raising seam (solve / stage)."""
        if self.faults is not None:
            self.faults.maybe_raise(site, graph=name)

    def _sweep_cap(self, name: str) -> Optional[int]:
        """The effective ``max_sweeps`` for one engine solve: the
        configured cap, unless the fault plan's ``clip`` site fires and
        forces its (tighter) clip — the solver-guardrail seam.  Probed
        LAST, after the stage/solve fault seams, so a fired clip always
        governs a solve that actually runs (a same-attempt injected
        exception cannot mask it from the chaos reconciliation)."""
        if self.faults is not None and self.faults.roll("clip", graph=name):
            return self.faults.clip_sweeps
        return self.max_sweeps

    def _solve_target(self, handle, q: Query) -> Answer:
        """Point-to-point residue of a tick: one frontier solve that
        early-exits on the target (plus the landmark bound when one is
        admissibly available); the row is partial — never cached.  Raises
        :class:`NotConverged` when a sweep cap stopped the engine short —
        capped labels are never served or cached."""
        tr = get_tracer()
        cl = get_cost_log()
        obs = tr.enabled or cl.enabled
        choice = self.dispatch.choose(handle, kind="p2p")
        if choice.sharded:
            return self._solve_target_sharded(handle, q, choice)
        with tr.span("p2p_solve", qids=(q.qid,)) as sp:
            with tr.span("stage", graph=handle.name):
                self._probe("stage", handle.name)
                ops = handle.frontier_ops()
                self.registry.touch_staged(handle.name)
            lb = None
            ls = handle.landmarks_ready()
            if ls is not None:
                lb = ls.conservative_lb(q.source, q.target)
                lb = None if not np.isfinite(lb) else lb
            self._probe("solve", handle.name)
            ms = self._sweep_cap(handle.name)
            # a model-chosen Δ rides the choice; it changes only the
            # schedule, never the fixpoint bytes (the port's frontier
            # engine has no scatter chunk to take).
            skw = {}
            if choice.delta is not None:
                skw["delta"] = float(choice.delta)
            t0 = time.perf_counter() if obs else 0.0
            d, _, sw, e, conv = sssp_frontier(
                ops, q.source, n=handle.n,
                sweep_fn=handle.frontier_sweep_fn(), max_sweeps=ms,
                target=q.target, target_lb=lb, **skw,
            )
            value = float(d[q.target])
            conv = bool(conv)
            self._c["target_solves"].inc()
            if obs:
                wall_ms = (time.perf_counter() - t0) * 1e3
                if tr.enabled:
                    sp.set(engine=choice.engine, graph=handle.name,
                           n=handle.n, m=handle.m, B=1, P=1,
                           sweeps=int(sw), edges_relaxed=int(e),
                           converged=conv)
                be, kind = backend_info(handle.device)
                cl.emit(engine=choice.engine, graph=handle.name, n=handle.n,
                        m=handle.m, sweeps=int(sw), edges_relaxed=int(e),
                        wall_ms=wall_ms, converged=conv, backend=be,
                        device_kind=kind)
        if not conv:
            raise NotConverged(
                f"p2p solve on {handle.name!r} capped at max_sweeps={ms} "
                "before the target settled")
        return Answer(q, value, "target")

    def _stage_partition(self, handle, nprocs: int) -> int:
        """The stage seam of a sharded solve: the graph's partition staged
        on every rank of the serving group (once); returns its slot."""
        with get_tracer().span("stage", graph=handle.name):
            self._probe("stage", handle.name)
            handle.partition_ops(nprocs)
            self.registry.touch_staged(handle.name)
        return handle.partition_slot

    def _solve_target_sharded(self, handle, q: Query, choice) -> Answer:
        """Point-to-point residue on the sharded route: one
        ``frontier_sharded`` FULL fixpoint on the serving group — no early
        exit exists across owners, but the complete row is cacheable
        (``dist[target]`` bytes identical either way).  Raises
        :class:`NotConverged` when a sweep cap stopped the engine short;
        capped labels are never served or cached."""
        tr = get_tracer()
        cl = get_cost_log()
        obs = tr.enabled or cl.enabled
        with tr.span("p2p_solve", qids=(q.qid,)) as sp:
            slot = self._stage_partition(handle, choice.nprocs)
            self._probe("solve", handle.name)
            ms = self._sweep_cap(handle.name)
            t0 = time.perf_counter() if obs else 0.0
            d, _, sw, e, conv = choice.mesh.solve(slot, q.source,
                                                  max_sweeps=ms)
            conv = bool(conv)
            self._c["target_solves"].inc()
            self._c["sharded_p2p"].inc()
            self._c["sharded_sources"].inc()
            self._c["sharded_edges"].inc(int(e))
            if obs:
                wall_ms = (time.perf_counter() - t0) * 1e3
                if tr.enabled:
                    sp.set(engine=choice.engine, graph=handle.name,
                           n=handle.n, m=handle.m, B=1, P=choice.nprocs,
                           sweeps=int(sw), edges_relaxed=int(e),
                           converged=conv)
                be, kind = backend_info(handle.device)
                cl.emit(engine=choice.engine, graph=handle.name, n=handle.n,
                        m=handle.m, nprocs=choice.nprocs, sweeps=int(sw),
                        edges_relaxed=int(e), wall_ms=wall_ms,
                        converged=conv, backend=be, device_kind=kind)
        if not conv:
            raise NotConverged(
                f"sharded p2p solve on {handle.name!r} capped at "
                f"max_sweeps={ms}")
        row = d[:handle.n].cpu().numpy()
        self.cache.put(self._row_key(handle, q.source), row)
        return Answer(q, float(row[q.target]), "target")

    def _solve_batch(self, handle, queries: list) -> list:
        """One bucket-padded multisource solve answering ``queries``
        (all on ``handle``'s graph, <= max_batch distinct sources).
        Raises :class:`NotConverged` on a capped solve BEFORE any row is
        cached — non-fixpoint labels never enter the cache."""
        distinct: list[int] = []
        seen: set[int] = set()
        for q in queries:
            if q.source not in seen:
                seen.add(q.source)
                distinct.append(q.source)
        choice = self.dispatch.choose(handle, kind="batch")
        bucket = self._bucket(len(distinct), choice.batch_cap)
        padded = distinct + [distinct[0]] * (bucket - len(distinct))
        tr = get_tracer()
        cl = get_cost_log()
        obs = tr.enabled or cl.enabled
        qids = tuple(q.qid for q in queries) if obs else ()
        engine = choice.engine
        nprocs = choice.nprocs if choice.sharded else 1
        with tr.span("batch_solve", qids=qids) as sp:
            if choice.sharded:
                slot = self._stage_partition(handle, nprocs)
                self._probe("solve", handle.name)
                ms = self._sweep_cap(handle.name)
                t0 = time.perf_counter() if obs else 0.0
                D, sw, e, conv = choice.mesh.solve_batch(slot, padded,
                                                         max_sweeps=ms)
                rows = D[:, :handle.n].cpu().numpy()
                converged = bool(conv)
                edges = int(e)
                self._c["sharded_batches"].inc()
                self._c["sharded_sources"].inc(len(distinct))
                self._c["sharded_edges"].inc(edges)
            else:
                with tr.span("stage", graph=handle.name):
                    self._probe("stage", handle.name)
                    ops = handle.csr_ops()
                    self.registry.touch_staged(handle.name)
                self._probe("solve", handle.name)
                ms = self._sweep_cap(handle.name)
                t0 = time.perf_counter() if obs else 0.0
                D, sw, conv = sssp_multisource_csr(
                    ops, torch.tensor(padded, dtype=torch.int64,
                                      device=handle.device),
                    n=handle.n, sweep_fn=handle.multisource_sweep_fn(),
                    max_sweeps=ms)
                rows = D.cpu().numpy()
                converged = bool(conv)
                # the segment engine relaxes every stored arc for every
                # bucket lane each sweep — exact, not sampled
                edges = int(sw) * handle.m * bucket if obs else 0
            self._c["engine_batches"].inc()
            self._c["engine_sources"].inc(len(distinct))
            self._c["dedup_saved"].inc(len(queries) - len(distinct))
            occupancy = len(distinct) / bucket
            self._occ_sum.add(occupancy)
            self._occ_last.set(occupancy)
            if obs:
                wall_ms = (time.perf_counter() - t0) * 1e3
                if tr.enabled:
                    sp.set(engine=engine, graph=handle.name, n=handle.n,
                           m=handle.m, B=bucket, P=nprocs, sweeps=int(sw),
                           edges_relaxed=edges,
                           occupancy=round(occupancy, 4),
                           converged=converged)
                be, kind = backend_info(handle.device)
                cl.emit(engine=engine, graph=handle.name, n=handle.n,
                        m=handle.m, batch=bucket, nprocs=nprocs,
                        sweeps=int(sw), edges_relaxed=edges,
                        wall_ms=wall_ms, converged=converged, backend=be,
                        device_kind=kind)
        if not converged:
            raise NotConverged(
                f"batched solve on {handle.name!r} ({len(distinct)} "
                f"sources) capped at max_sweeps={ms}")
        by_source = {s: rows[i] for i, s in enumerate(distinct)}
        out = []
        for q in queries:
            row = by_source[q.source]
            self.cache.put(self._row_key(handle, q.source), row)
            val = row if q.target is None else float(row[q.target])
            out.append(Answer(q, val, "batch"))
        return out

    # -- the tick ---------------------------------------------------------

    def _fail(self, q, err: ServeError) -> Answer:
        """A typed per-query failure answer (never raised mid-tick)."""
        return Answer(q, None, "error", status=err.code, exact=False,
                      error=err)

    def _retry_or_fail(self, queries: list, exc: Exception,
                       requeue: list) -> list:
        """A solve raised: requeue each query with capped exponential
        backoff (ineligible for ``2**(attempts-1)`` ticks, capped at
        ``backoff_cap``) until its retry budget is spent, then answer it
        ``solve_failed``."""
        failed = []
        for q in queries:
            q.attempts += 1
            if q.attempts > self.retry_budget:
                failed.append(self._fail(q, SolveFailed(
                    f"solve raised on attempt {q.attempts} "
                    f"(budget {self.retry_budget} retries): {exc}")))
            else:
                q.not_before = self.ticks + min(
                    2 ** (q.attempts - 1), self.backoff_cap)
                self._c["retries"].inc()
                requeue.append(q)
        return failed

    def tick(self, now: Optional[float] = None) -> list:
        """Drain the queues once; returns the Answers produced this tick
        (overflow beyond max_batch distinct sources per graph is requeued
        ahead of newer arrivals).  Pending mutations are applied FIRST —
        one committed batch per graph — so every query drained in the
        same tick is answered against the post-mutation version (the
        interleaving contract).

        ``now`` (the driver's clock, same units as arrival/deadline)
        activates deadline handling: expired queries are answered
        ``deadline_exceeded`` before any solve, and near-deadline ones
        (within ``degrade_margin``) may be served degraded.  A solve
        exception fails only ITS queries (retried under backoff first) —
        never the tick: every other graph's drained queries still serve.
        """
        self._last_tick_stalled = False
        if not self._queue and not self._mutations and not self._shed_acks:
            return []
        tr = get_tracer()
        if not tr.enabled:
            return self._tick(now)
        with tr.span("tick", tick=self.ticks + 1) as sp:
            answers = self._tick(now)
            sp.set(answers=len(answers), pending=self.pending)
            # emitted inside the span: an answer belongs to its tick,
            # which is what obs/validate's chain reconstruction pins
            for a in answers:
                tr.instant("answer", qid=a.query.qid, via=a.via,
                           status=a.status, exact=a.exact)
        return answers

    def _tick(self, now: Optional[float]) -> list:
        self._c["ticks"].inc()
        retries0 = self.retries
        answers: list = list(self._shed_acks)
        self._shed_acks = []
        answers.extend(self._apply_mutations())
        # backoff gate: queries parked by a failed solve sit out their
        # not_before ticks without blocking the rest of the queue.
        batch: list = []
        held: "collections.deque[Query]" = collections.deque()
        for q in self._queue:
            (batch if q.not_before <= self.ticks else held).append(q)
        self._queue = held
        if now is not None:
            live = []
            for q in batch:
                if q.deadline is not None and now > q.deadline:
                    self._c["deadline_expired"].inc()
                    answers.append(self._fail(q, DeadlineExceeded(
                        f"deadline {q.deadline:.6f} passed at "
                        f"now={now:.6f} before serving")))
                else:
                    live.append(q)
            batch = live
        by_graph: "collections.OrderedDict[str, list]" = (
            collections.OrderedDict())
        for q in batch:
            by_graph.setdefault(q.graph, []).append(q)
        requeue: list = []
        for name, queries in by_graph.items():
            if (self.faults is not None and name in self.registry
                    and self.faults.roll("evict", graph=name)):
                # chaos seam: the graph vanishes mid-tick, after
                # admission but before its solve — the evicted-graph
                # race the GraphGone path below must absorb.
                self.registry.evict(name)
            if name not in self.registry:
                # the graph was evicted (or never registered): fail these
                # queries with typed answers rather than crashing the
                # tick and losing every other graph's drained queries.
                err = GraphGone(f"graph {name!r} is not registered "
                                "(evicted or never admitted)")
                answers.extend(self._fail(q, err) for q in queries)
                continue
            handle = self.registry.get(name)
            need_engine = []
            for q in queries:
                ans = self._try_fast(handle, q)
                if ans is None:
                    need_engine.append(q)
                else:
                    answers.append(ans)
            if now is not None and self.degrade and need_engine:
                # deadline pressure: a query too close to its deadline to
                # risk an engine solve takes the degraded fallback when
                # one exists (else it still solves — it may make it).
                still = []
                for q in need_engine:
                    if (q.deadline is not None
                            and q.deadline - now <= self.degrade_margin):
                        d = self._try_degraded(handle, q)
                        if d is not None:
                            answers.append(d)
                            continue
                    still.append(q)
                need_engine = still
            if not need_engine:
                continue
            # cap distinct sources at max_batch; queries on uncovered
            # sources wait for the next tick.  Admission is O(1) per
            # query via the set; the list keeps admission order (and is
            # what _solve_batch's dedup re-derives per-query order from).
            allowed: list[int] = []
            allowed_set: set[int] = set()
            take, defer = [], []
            limit = self._admission_limit(handle)
            for q in need_engine:
                if q.source in allowed_set:
                    take.append(q)
                elif len(allowed) < limit:
                    allowed.append(q.source)
                    allowed_set.add(q.source)
                    take.append(q)
                else:
                    defer.append(q)
            for q in defer:
                # admission overflow on a deadlined query: a degraded
                # answer NOW beats an exact answer after the deadline.
                d = (self._try_degraded(handle, q)
                     if q.deadline is not None else None)
                if d is not None:
                    answers.append(d)
                else:
                    requeue.append(q)
            if not take:
                continue
            try:
                if (self.p2p_solo and len(take) == 1
                        and take[0].target is not None):
                    answers.append(self._solve_target(handle, take[0]))
                else:
                    answers.extend(self._solve_batch(handle, take))
            except NotConverged as e:
                # a capped solve is NOT transient — retrying under the
                # same cap re-runs the identical truncation, so answer
                # typed immediately (satisfying the guardrail contract).
                self._c["not_converged"].inc(len(take))
                answers.extend(self._fail(q, e) for q in take)
            except GroupBroken as e:
                # the serving group lost a rank: no retry can serve it
                self._c["solve_exceptions"].inc()
                answers.extend(self._fail(q, e) for q in take)
            except Exception as e:    # injected or real engine failure
                self._c["solve_exceptions"].inc()
                answers.extend(self._retry_or_fail(take, e, requeue))
        for q in reversed(requeue):
            self._queue.appendleft(q)
        # progress accounting for drain()'s guard: a tick progressed if
        # it answered anything, advanced some query's retry state, or
        # simply had no eligible work (backoff holds drain by design).
        self._last_tick_stalled = (bool(batch) and not answers
                                   and self.retries == retries0)
        for a in answers:
            if now is not None and a.service_start is None:
                a.service_start = now
            self._via[a.via].inc()
            self.metrics.counter("sched.answered_status",
                                 status=a.status).inc()
        return answers

    def drain(self, now: Optional[float] = None) -> list:
        """Tick until the queues are empty (closed-loop replay).

        Progress guard: a tick that had eligible work but served zero
        answers and retired zero queries (everything requeued unchanged)
        raises :class:`SchedulerStalled` instead of spinning forever —
        the failure mode a requeue-path bug would otherwise turn into a
        silent infinite loop."""
        out = []
        while self.pending:
            out.extend(self.tick(now))
            if self._last_tick_stalled:
                raise SchedulerStalled(
                    f"tick {self.ticks} had eligible work but served "
                    f"zero and retired zero ({self.pending} pending)")
        return out

    # -- metrics ----------------------------------------------------------

    @property
    def mean_occupancy(self) -> float:
        return (self.occupancy_sum / self.engine_batches
                if self.engine_batches else 0.0)

    def snapshot(self) -> dict:
        """The uniform metrics view: every scheduler, cache, and registry
        series merged into one flat sorted ``{name: value}`` dict (the
        components may share one registry or own separate ones — the
        ``sched.`` / ``cache.`` / ``registry.`` prefixes cannot collide).
        Deterministic under seeded replay: only event counts and set
        gauges, no wall-clock values."""
        merged = dict(self.metrics.snapshot())
        for reg in (self.cache.metrics, self.registry.metrics):
            if reg is not self.metrics:
                merged.update(reg.snapshot())
        return dict(sorted(merged.items()))

    def stats(self) -> dict:
        """Legacy nested view, unchanged shape; every count in it is
        derived from the same series :meth:`snapshot` reports."""
        return {
            "ticks": self.ticks,
            "engine_batches": self.engine_batches,
            "engine_sources": self.engine_sources,
            "sharded_batches": self.sharded_batches,
            "sharded_p2p": self.sharded_p2p,
            "sharded_sources": self.sharded_sources,
            "sharded_edges": self.sharded_edges,
            "target_solves": self.target_solves,
            "dedup_saved": self.dedup_saved,
            "mean_occupancy": round(self.mean_occupancy, 4),
            "rows_kept": self.rows_kept,
            "rows_repaired": self.rows_repaired,
            "rows_invalidated": self.rows_invalidated,
            "rows_staled": self.rows_staled,
            "repair_edges": self.repair_edges,
            "answered_via": dict(self.answered_via),
            "answered_status": dict(self.answered_status),
            "submissions_rejected": self.submissions_rejected,
            "shed": self.shed,
            "deadline_expired": self.deadline_expired,
            "degraded_p2p": self.degraded_p2p,
            "degraded_batch": self.degraded_batch,
            "solve_exceptions": self.solve_exceptions,
            "retries": self.retries,
            "not_converged": self.not_converged,
            "faults": (self.faults.summary()
                       if self.faults is not None else None),
            "cache": self.cache.stats(),
            "registry": self.registry.stats(),
        }
