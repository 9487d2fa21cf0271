"""SSSP serving driver: replay open-loop query traces against the port's
serve subsystem and report latency/throughput/cache metrics (port of
repro/launch/sssp_serve.py, with the same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.sssp_serve --smoke \
        [--device cuda|cpu]

Per scenario (uniform / zipf / p2p, see repro_torch/serve/workload.py)
it registers the graphs (with ALT landmarks) on the device,
generates an open-loop arrival trace, and replays it in wall-clock time —
events are submitted when their arrival time passes, the scheduler ticks
whenever work is queued, and latency = completion - arrival (queueing
included, the open-loop penalty for falling behind).

Reported per scenario: p50/p99/max latency, queries/s, mean batch
occupancy, dedup savings, answers-by-path, cache hit rate.

``--verify`` (default under ``--smoke``) re-solves every distinct
(graph, source) with the reference engine and asserts each served answer
is bitwise-equal — the end-to-end form of the serving exactness
guarantee.  The reference is JAX's, ``serial``, by default;
``--verify-engine frontier_kernel`` takes fresh kernel solves instead,
for sizes where serial's O(n²) a row is out of reach, and then holds
every reference row against scipy's float64 Dijkstra within the float32
rounding bound too (serial is the paper's exact oracle itself).

``--chaos`` replays a **seeded fault schedule** (serve/faults.py)
through a deterministic closed-loop replay instead of the wall-clock one:
a mixed static + dynamic (churn) trace is submitted in fixed-size chunks
with the event clock as ``tick(now=)``, while the fault plan fires
injected solve/staging failures, mid-tick evictions, poisoned mutation
batches, and sweep clips at the scheduler's seams.  The verifier then
asserts (1) every answer carries a typed status, (2) every ``exact=True``
answer is bitwise-equal to a fresh reference solve on the answer-time
graph version, and (3) every fired fault site surfaced through its
expected status (or the retry counters).

``--calibration PATH`` (``CALIBRATION_torch.json`` for the card, written
by ``python -m repro_torch.tune.calibrate``) serves through the port's
``TunedPolicy``, which refuses a calibration measured on another
backend.

``--devices P`` opens a serving group of P ranks (core/_dist.
open_serving_group: this process is the leader, P - 1 followers are
spawned; gloo ranks on the CPU, NCCL ranks one GPU each) and
``--shard-threshold N`` routes graphs with >= N vertices through the
vertex-partitioned sharded engines on it (serve/dispatch.py); ``--verify``
covers the sharded answers identically.  ``--shared-card`` puts all P
ranks on the one card of ``--device`` over gloo, the only way one GPU
holds P ranks; without it ``--device cuda --devices P`` needs P GPUs.  A
rank that dies or raises breaks the group: its answers fail typed, and
the driver exits non-zero.

    PYTHONPATH=src python -m repro_torch.launch.sssp_serve --smoke \
        --devices 4 --shard-threshold 128 --device cpu

``main`` returns a summary dict (per scenario: latency, throughput,
answers by path, rows verified) for in-process callers.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import csr as C
from repro_torch.core.api import resolve_device, shortest_paths
from repro_torch.serve import (STATUS_OK, STATUSES, DispatchPolicy,
                               DistanceCache, GraphRegistry, LatencyRecorder,
                               MicroBatchScheduler, MutationEvent,
                               QueryRejected, SCENARIOS, make_churn_trace,
                               make_trace, policy_override)
from repro_torch.serve.dispatch import DEFAULT_SHARD_THRESHOLD


def replay(sched: MicroBatchScheduler, events, verify=None) -> tuple:
    """Wall-clock open-loop replay; returns ``(answers, wall_s,
    verify_s)`` with each answer's ``done_at`` stamped.  Query events are
    submitted as the clock passes their arrival (one rejected by
    bounded-queue backpressure is dropped, counted in the scheduler's
    ``submissions_rejected``); mutation events (a churn trace) go into
    the same clock.  ``verify(answers)``, where given, runs after every
    tick with the clock stopped, so checking leaves arrivals and
    latencies as they were; ``verify_s`` is the time it took."""
    events = sorted(events, key=lambda e: e.arrival)
    t0, paused = time.perf_counter(), 0.0

    def clock():
        return time.perf_counter() - t0 - paused

    i, answers = 0, []
    while i < len(events) or sched.pending:
        now = clock()
        while i < len(events) and events[i].arrival <= now:
            e = events[i]
            try:
                if isinstance(e, MutationEvent):
                    sched.submit_mutation(e.graph, e.op, e.u, e.v, e.w,
                                          arrival=e.arrival)
                else:
                    sched.submit(e.graph, e.source, e.target,
                                 arrival=e.arrival,
                                 deadline=getattr(e, "deadline", None))
            except QueryRejected:
                pass
            i += 1
        if sched.pending:
            out = sched.tick(now)
            done = clock()
            for a in out:
                a.done_at = done
            answers.extend(out)
            if verify is not None:
                v0 = time.perf_counter()
                verify(out)
                paused += time.perf_counter() - v0
        elif i < len(events):
            time.sleep(min(events[i].arrival - now, 1e-3))
    return answers, clock(), paused


class Verifier:
    """Holds served answers to fresh reference solves, memoized per
    (graph, version, source).

    ``graphs`` is a :class:`GraphRegistry` or a mapping of name ->
    CsrGraph / DynamicGraph; a dynamic graph is solved as the snapshot of
    its version at check time, so call the verifier after every tick of
    a replay that mutates.  ``reference`` names the engine of the
    reference solves on ``device`` (``"serial"``, JAX's, by default);
    ``oracle=True`` also holds each reference row against scipy's float64
    Dijkstra, with the float32 rounding bound of launch/sssp_run.py.

    Per answer, JAX's rules: an unknown status fails; a non-ok status
    fails unless it is in ``allow``; mutation acks are skipped; an
    inexact answer is counted, and with ``bounds=True`` a p2p bound pair
    must bracket the reference distance; every ``exact=True`` answer is
    bitwise equal to its reference row (a p2p answer to the row's
    ``dist[target]``).  A failure raises ``SystemExit`` naming the query.

    The reference solves run outside any installed tracer and cost log,
    and their kernel launches are taken back out of the kernel wrappers'
    counts: checking is not serving.
    """

    def __init__(self, graphs, *, reference: str = "serial",
                 device="cuda", oracle: bool = False, allow=(),
                 bounds: bool = True):
        self.graphs = graphs
        self.reference = reference
        self.device = resolve_device(device)
        self.oracle = oracle
        self.allow = tuple(allow)
        self.bounds = bounds
        self.rows: dict = {}
        # graph -> (version, source, CsrGraph) of its first reference
        # solve, for a check against scipy outside the replay
        self.first: dict = {}
        self.exact = self.inexact = 0
        self.oracle_max_rel_err = 0.0

    def _graph(self, name: str):
        if isinstance(self.graphs, GraphRegistry):
            h = self.graphs.get(name)
            return h.dyn if h.dyn is not None else h.cg
        return self.graphs[name]

    def row(self, graph: str, source: int) -> np.ndarray:
        """The reference row of ``graph`` at its current version."""
        from repro_torch.dynamic import DynamicGraph

        g = self._graph(graph)
        dynamic = isinstance(g, DynamicGraph)
        key = (graph, g.version if dynamic else 0, source)
        if key not in self.rows:
            cg = g.snapshot() if dynamic else g
            self.first.setdefault(graph, (key[1], source, cg))
            ref = shortest_paths(cg, source, engine=self.reference,
                                 device=self.device).dist
            if self.oracle:
                self._hold_to_scipy(key, cg, source, ref)
            self.rows[key] = ref
        return self.rows[key]

    def _hold_to_scipy(self, key, cg, source: int, ref) -> None:
        from repro_torch.launch.sssp_run import VERIFY_RTOL, scipy_distances

        want = scipy_distances(cg, [source])[0]
        got = np.asarray(ref, np.float64)
        if not np.array_equal(np.isinf(got), np.isinf(want)):
            raise SystemExit(f"reference row {key} reaches other vertices "
                             f"than scipy's Dijkstra")
        fin = np.isfinite(want) & (want > 0)
        rel = (float(np.max(np.abs(got[fin] - want[fin]) / want[fin]))
               if fin.any() else 0.0)
        if rel > VERIFY_RTOL:
            raise SystemExit(f"reference row {key}: relative error {rel} "
                             f"against scipy > {VERIFY_RTOL}")
        self.oracle_max_rel_err = max(self.oracle_max_rel_err, rel)

    def __call__(self, answers) -> None:
        from repro_torch.kernels import wrappers
        from repro_torch.obs import set_cost_log, set_tracer

        kernels = wrappers()
        counts = {k: fn.launches for k, fn in kernels.items()}
        tracer, cost_log = set_tracer(None), set_cost_log(None)
        try:
            self._check(answers)
        finally:
            set_tracer(tracer)
            set_cost_log(cost_log)
            for k, fn in kernels.items():
                fn.launches = counts[k]

    def _check(self, answers) -> None:
        for a in answers:
            q = a.query
            if a.status not in STATUSES:
                raise SystemExit(f"unknown answer status {a.status!r} "
                                 f"for {q}")
            if a.status != STATUS_OK:
                if a.status in self.allow:
                    continue
                raise SystemExit(f"scheduler returned a {a.status} answer "
                                 f"for {q}: {a.error}")
            if a.via == "mutate":
                continue
            if not a.exact:
                # degraded answers are approximate by contract; a p2p
                # bound pair must still bracket the true distance.
                self.inexact += 1
                if self.bounds and q.target is not None \
                        and a.bounds is not None:
                    lb, ub = a.bounds
                    want = float(self.row(q.graph, q.source)[q.target])
                    if not (lb <= want * (1 + 1e-4) + 1e-3
                            and want <= ub * (1 + 1e-4) + 1e-3):
                        raise SystemExit(
                            f"degraded bounds ({lb}, {ub}) do not bracket "
                            f"{self.reference} {want} for {q}")
                continue
            ref = self.row(q.graph, q.source)
            if q.target is None:
                if np.asarray(a.value).tobytes() != ref.tobytes():
                    raise SystemExit(f"row mismatch vs {self.reference}: "
                                     f"{q} (via {a.via})")
            else:
                got, want = np.float32(a.value), ref[q.target]
                if not (got == want or (np.isinf(got) and np.isinf(want))):
                    raise SystemExit(
                        f"dist mismatch vs {self.reference}: {q} (via "
                        f"{a.via}): served {got!r}, reference {want!r}")
            self.exact += 1


def verify_answers(answers, graphs_by_name, *, allow=(),
                   reference: str = "serial", device="cuda",
                   oracle: bool = False) -> int:
    """Assert every ``exact=True`` answer is bitwise-equal to a fresh
    ``reference`` solve on ``device`` (degraded p2p answers are instead
    checked to BRACKET the reference distance); returns the number of
    distinct (graph, source) rows checked.  Non-ok statuses listed in
    ``allow`` are skipped; any other failure answer aborts — in a
    fault-free replay every answer must be exact."""
    check = Verifier(graphs_by_name, reference=reference, device=device,
                     oracle=oracle, allow=allow)
    check(answers)
    return len(check.rows)


def run_chaos(args, dispatch) -> dict:
    """Seeded chaos replay (see module docstring).  Deterministic closed
    loop: events are submitted in fixed-size chunks with the event clock
    as ``tick(now=)``, so a given (seed, chaos-seed, rates) triple
    replays the exact same fault schedule and answer stream every run.
    Returns the answers, their statuses and the faults fired."""
    from collections import Counter

    from repro_torch.dynamic import DynamicGraph
    from repro_torch.serve import FaultPlan

    n = args.n or (256 if args.smoke else 2000)
    queries = args.queries or (80 if args.smoke else 400)
    scale = args.fault_rate
    # per-site probe volumes differ by orders of magnitude (solve/clip
    # probe every engine call, mutate only per drained batch), so the
    # multipliers are tuned so every site fires a few times per smoke
    # replay — the reconciliation below is vacuous for a silent site.
    plan = FaultPlan(seed=args.chaos_seed, rates={
        "solve": 0.8 * scale, "stage": 0.4 * scale, "evict": 0.6 * scale,
        "mutate": min(1.0, 4.0 * scale), "clip": 0.5 * scale})

    statics = [(f"g{i}", C.random_csr_graph(n, 3 * n, seed=args.seed + i))
               for i in range(args.graphs)]
    dyn = DynamicGraph(C.random_csr_graph(n, 3 * n, seed=args.seed + 77))
    registry = GraphRegistry(device=dispatch.device, group=dispatch.group)
    cache = DistanceCache(capacity=args.cache_rows)
    sched = MicroBatchScheduler(
        registry, cache, max_batch=args.batch, dispatch=dispatch,
        faults=plan, retry_budget=2, max_queue=args.max_queue)
    for name, cg in statics:
        registry.register(name, cg, landmarks=args.landmarks,
                          landmark_seed=args.seed)
    registry.register("dyn0", dyn, landmarks=args.landmarks,
                      landmark_seed=args.seed)

    events = make_trace(
        "p2p", [(name, cg.n) for name, cg in statics], num_queries=queries,
        rate=1000.0, seed=args.seed, deadline=args.deadline)
    events += make_churn_trace(
        [("dyn0", dyn.base)], num_events=queries // 2, rate=1000.0,
        mutate_frac=0.25, p2p_frac=0.3, seed=args.seed + 1,
        hot_seed=args.seed + 101)
    events.sort(key=lambda e: e.arrival)

    # reference rows memoized per (graph, version, source) over the
    # graphs themselves (a chaos eviction must not hide a graph from the
    # check); dynamic versions are immutable once committed, so
    # verifying each tick's answers at the then-current version is exact.
    check_tick = Verifier(dict(statics, dyn0=dyn),
                          reference=args.verify_engine,
                          device=dispatch.device, allow=STATUSES,
                          bounds=False)

    answers, rejected, i = [], 0, 0
    submitted = 0
    max_iters = 8 * len(events) + 256   # progress backstop (backoff ticks)
    iters = 0
    while i < len(events) or sched.pending:
        iters += 1
        if iters > max_iters:
            raise SystemExit(
                f"chaos replay made no progress: {sched.pending} pending "
                f"after {iters} ticks")
        now = events[i].arrival if i < len(events) else events[-1].arrival
        chunk = 0
        while i < len(events) and chunk < 8:
            e = events[i]
            now = e.arrival
            try:
                if isinstance(e, MutationEvent):
                    sched.submit_mutation(e.graph, e.op, e.u, e.v, e.w,
                                          arrival=e.arrival)
                else:
                    sched.submit(e.graph, e.source, e.target,
                                 arrival=e.arrival, deadline=e.deadline)
                submitted += 1
            except QueryRejected:
                rejected += 1
            i += 1
            chunk += 1
        out = sched.tick(now)
        for a in out:
            a.done_at = now
        check_tick(out)     # verify at the tick's graph version
        answers.extend(out)

    # every accepted submission must be answered exactly once — the
    # scheduler made progress through every injected fault.
    if len(answers) != submitted:
        raise SystemExit(f"progress violation: {submitted} accepted "
                         f"submissions but {len(answers)} answers")
    statuses = Counter(a.status for a in answers)
    fired = plan.counts()
    print(f"[sssp_serve] chaos: {len(answers)} answers "
          f"({rejected} rejected at submit) | statuses {dict(statuses)} | "
          f"faults fired {fired} (probes {plan.summary()['probes']})",
          flush=True)

    # reconcile: every fired fault site must have surfaced through its
    # typed status (or, for retried transients, the exception counter).
    recon = []
    if fired["evict"] and not statuses["graph_gone"]:
        recon.append("evict fired but no graph_gone answers")
    if fired["mutate"] and not statuses["rejected"]:
        recon.append("mutate fired but no rejected mutation acks")
    if fired["clip"] and not statuses["not_converged"]:
        recon.append("clip fired but no not_converged answers")
    if sched.solve_exceptions < fired["solve"] + fired["stage"]:
        recon.append(
            f"{fired['solve']}+{fired['stage']} solve/stage faults fired "
            f"but only {sched.solve_exceptions} exceptions were caught")
    if recon:
        raise SystemExit("chaos reconciliation failed: " + "; ".join(recon))
    print(f"[sssp_serve] chaos: verified {len(check_tick.rows)} distinct "
          f"{args.verify_engine} rows bitwise; retries {sched.retries}, "
          f"solve exceptions {sched.solve_exceptions}, deadline expired "
          f"{sched.deadline_expired}; all fired sites reconciled",
          flush=True)
    return {"answers": answers, "statuses": dict(statuses),
            "faults_fired": dict(fired), "rejected_at_submit": rejected,
            "verified_rows": len(check_tick.rows),
            "exact_checked": check_tick.exact,
            "answered_via": dict(sched.stats()["answered_via"])}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.sssp_serve")
    ap.add_argument("--smoke", action="store_true",
                    help="small graphs, short traces, verify on (CI-sized)")
    ap.add_argument("--scenario", default="all",
                    choices=("all",) + SCENARIOS)
    ap.add_argument("--n", type=int, default=None,
                    help="vertices per graph (default 10000; smoke 256)")
    ap.add_argument("--graphs", type=int, default=2,
                    help="number of registered graphs")
    ap.add_argument("--queries", type=int, default=None,
                    help="queries per scenario (default 400; smoke 60)")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrival rate, queries/s "
                         "(default 500; smoke 2000)")
    ap.add_argument("--batch", type=int, default=16,
                    help="max distinct sources per tick per graph")
    ap.add_argument("--landmarks", type=int, default=8,
                    help="ALT landmarks per graph (0 disables)")
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--devices", type=int, default=1,
                    help="ranks of the serving group for the sharded "
                         "route (1 = never shard)")
    ap.add_argument("--shard-threshold", type=int,
                    default=DEFAULT_SHARD_THRESHOLD,
                    help="route graphs with >= this many vertices through "
                         "the sharded engines (needs --devices > 1)")
    ap.add_argument("--shared-card", action="store_true",
                    help="run every rank on the one card of --device, "
                         "over gloo (otherwise one GPU a rank)")
    ap.add_argument("--verify", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="bitwise-check every answer vs the reference "
                         "engine (default: on under --smoke)")
    ap.add_argument("--verify-engine", default="serial",
                    help="engine of the reference solves (default serial, "
                         "as the JAX driver; frontier_kernel for sizes "
                         "where serial's O(n^2) a row is out of reach, "
                         "each row then held to scipy's Dijkstra)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-query deadline in seconds after arrival "
                         "(None = queries never expire)")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bounded-queue admission: reject/shed submits "
                         "past this many pending queries")
    ap.add_argument("--chaos", action="store_true",
                    help="deterministic seeded fault-injection replay "
                         "(serve/faults.py); verifies every exact answer "
                         "bitwise and reconciles fired faults vs statuses")
    ap.add_argument("--chaos-seed", type=int, default=0,
                    help="fault-plan seed (independent of --seed)")
    ap.add_argument("--fault-rate", type=float, default=0.1,
                    help="chaos fault-rate scale factor across sites")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="capture observability: Chrome trace JSON to "
                         "PATH, per-solve cost records to "
                         "PATH-with-.cost.jsonl; both are schema-"
                         "validated at exit (repro_torch/obs)")
    ap.add_argument("--calibration", default=None, metavar="PATH",
                    help="serve through the measured cost model fitted "
                         "from this calibration file (repro_torch/tune) "
                         "instead of the hard-coded thresholds; "
                         "out-of-support queries still fall back to "
                         "them")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    group = None
    if args.devices > 1:
        from repro_torch.core._dist import open_serving_group

        group = open_serving_group(args.devices, device=dev,
                                   shared=args.shared_card)
    kw = dict(shard_threshold=args.shard_threshold, nprocs=args.devices,
              device=dev, group=group)
    try:
        if args.calibration:
            from repro_torch.tune.model import load_model
            from repro_torch.tune.select import TunedPolicy
            dispatch = TunedPolicy(load_model(args.calibration), **kw)
            print(f"[sssp_serve] tuned dispatch from {args.calibration}: "
                  f"{dispatch.model.coverage()['engines']}", flush=True)
        else:
            dispatch = DispatchPolicy(**kw)
        if dispatch.nprocs > 1:
            print(f"[sssp_serve] sharded route: {dispatch.nprocs} devices, "
                  f"threshold n>={args.shard_threshold} ({group.backend} "
                  f"ranks on {'one card' if args.shared_card else dev.type},"
                  f" started in {group.start_s:.2f}s)", flush=True)
        report = _run(args, dispatch)
        if group is not None and group.broken is not None:
            raise SystemExit(f"[sssp_serve] {group.broken}")
    finally:
        if group is not None:
            group.close()
    print("[sssp_serve] done", flush=True)
    return report


def _run(args, dispatch) -> dict:
    """The replay (chaos or wall-clock) under ``dispatch``, with the
    tracer and cost log restored after."""
    from repro_torch.obs import get_cost_log, get_tracer, set_cost_log, \
        set_tracer

    prev = get_tracer(), get_cost_log()
    capture = None
    if args.trace_out:
        from repro_torch.obs import install_capture
        capture = install_capture()
    try:
        # engine="auto" callers agree with us for the run's length
        with policy_override(dispatch):
            if args.chaos:
                report = run_chaos(args, dispatch)
            else:
                report = _serve(args, dispatch)
        if capture is not None:
            _finalize_capture(capture, args.trace_out)
    finally:
        set_tracer(prev[0])
        set_cost_log(prev[1])
    if args.calibration:
        report["tuned"] = {"calibration": args.calibration,
                           "model_routed": dispatch.model_routed,
                           "fallback_routed": dispatch.fallback_routed}
    return report


def _serve(args, dispatch) -> dict:
    """The wall-clock replay of every scenario; returns the summary."""
    n = args.n or (256 if args.smoke else 10000)
    queries = args.queries or (60 if args.smoke else 400)
    rate = args.rate or (2000.0 if args.smoke else 500.0)
    verify = args.verify if args.verify is not None else args.smoke
    scenarios = SCENARIOS if args.scenario == "all" else (args.scenario,)

    graphs = [(f"g{i}", C.random_csr_graph(n, 3 * n, seed=args.seed + i))
              for i in range(args.graphs)]
    graphs_by_name = dict(graphs)
    sizes = [(name, cg.n) for name, cg in graphs]

    report = {}
    for scen in scenarios:
        # fresh serving state per scenario so metrics don't bleed across
        registry = GraphRegistry(device=dispatch.device, group=dispatch.group)
        cache = DistanceCache(capacity=args.cache_rows)
        sched = MicroBatchScheduler(registry, cache, max_batch=args.batch,
                                    dispatch=dispatch,
                                    max_queue=args.max_queue)
        t0 = time.perf_counter()
        for name, cg in graphs:
            registry.register(name, cg, landmarks=args.landmarks,
                              landmark_seed=args.seed)
        prep_s = time.perf_counter() - t0

        events = make_trace(scen, sizes, num_queries=queries, rate=rate,
                            seed=args.seed, deadline=args.deadline)
        answers, wall_s, _ = replay(sched, events)
        rec = LatencyRecorder()
        for a in answers:
            rec.observe(a, a.done_at)
        s, lat = sched.stats(), rec.summary()
        print(f"[sssp_serve] {scen}: {lat['queries']} queries "
              f"({args.graphs} graphs, n={n}, prep {prep_s:.2f}s) | "
              f"p50 {lat['p50_ms']:.1f} ms, p99 {lat['p99_ms']:.1f} ms, "
              f"{lat['qps']:.0f} q/s | "
              f"occupancy {s['mean_occupancy']:.2f}, "
              f"dedup saved {s['dedup_saved']}, "
              f"cache hit rate {s['cache']['hit_rate']:.2f} | "
              f"via {s['answered_via']}", flush=True)
        if "queue_p50_ms" in lat:
            # end-to-end latency split: time queued before the serving
            # tick vs time inside it (LatencyRecorder's two components)
            print(f"[sssp_serve] {scen}: queue wait "
                  f"p50 {lat['queue_p50_ms']:.1f} ms / "
                  f"p99 {lat['queue_p99_ms']:.1f} ms | service "
                  f"p50 {lat['service_p50_ms']:.1f} ms / "
                  f"p99 {lat['service_p99_ms']:.1f} ms", flush=True)
        if s["sharded_batches"] or s["sharded_p2p"]:
            print(f"[sssp_serve] {scen}: sharded route "
                  f"{s['sharded_batches']} batches + {s['sharded_p2p']} "
                  f"p2p ({s['sharded_sources']} sources, "
                  f"{s['sharded_edges']} edges relaxed) on "
                  f"{dispatch.nprocs} devices", flush=True)
        # end-of-run accounting: the cache and registry counters the
        # scheduler aggregates but the per-scenario line above elides
        c, r = s["cache"], s["registry"]
        print(f"[sssp_serve] {scen}: cache {c['hits']} hits / "
              f"{c['misses']} misses / {c['evictions']} evictions "
              f"({c['rows']}/{c['capacity']} rows) | registry "
              f"{r['graphs']} graphs, {r['bytes_in_use'] / 1e6:.1f} MB "
              f"in use (budget "
              f"{'none' if r['byte_budget'] is None else r['byte_budget']}"
              f"{', OVER' if r['over_budget'] else ''}), "
              f"{r['registered']} registered / {r['evicted']} evicted",
              flush=True)
        if (s["shed"] or s["deadline_expired"] or s["submissions_rejected"]
                or s["degraded_p2p"] or s["degraded_batch"]):
            print(f"[sssp_serve] {scen}: robustness: "
                  f"{s['submissions_rejected']} rejected at submit, "
                  f"{s['shed']} shed, {s['deadline_expired']} expired, "
                  f"{s['degraded_p2p']}+{s['degraded_batch']} degraded | "
                  f"statuses {s['answered_status']}", flush=True)
        row = {"n": n, "prep_s": prep_s, "wall_s": wall_s, **lat,
               "mean_occupancy": s["mean_occupancy"],
               "dedup_saved": s["dedup_saved"],
               "cache_hit_rate": s["cache"]["hit_rate"],
               "answered_via": dict(s["answered_via"]),
               **{k: s[k] for k in ("sharded_batches", "sharded_p2p",
                                    "sharded_sources", "sharded_edges")}}
        if verify:
            # deadline / bounded-queue runs legitimately produce typed
            # failures; every exact answer must still match the reference.
            allow = (("deadline_exceeded", "rejected")
                     if (args.deadline is not None
                         or args.max_queue is not None) else ())
            oracle = args.verify_engine != "serial"
            check = Verifier(graphs_by_name, reference=args.verify_engine,
                             device=dispatch.device, oracle=oracle,
                             allow=allow)
            check(answers)
            row |= {"verified_rows": len(check.rows),
                    "exact_checked": check.exact}
            if oracle:
                row["oracle_max_rel_err"] = check.oracle_max_rel_err
            print(f"[sssp_serve] {scen}: verified bitwise vs "
                  f"{args.verify_engine} ({len(check.rows)} distinct rows"
                  f"{', each against scipy' if oracle else ''})",
                  flush=True)
        report[scen] = row
        for name in registry.names:     # frees the followers' blocks too
            registry.evict(name)
    return report


def _finalize_capture(capture, path: str) -> None:
    """Write + validate the observability artifacts; abort on schema or
    answer-chain violations."""
    from repro_torch.obs import cost_path_for, finalize_capture

    tr, cl = capture
    errs = finalize_capture(tr, cl, path)
    print(f"[sssp_serve] trace: {len(tr.spans)} spans, "
          f"{len(tr.instants)} instants -> {path} | "
          f"{len(cl.records)} cost records -> {cost_path_for(path)}",
          flush=True)
    if errs:
        for e in errs[:20]:
            print(f"[sssp_serve] trace INVALID: {e}", flush=True)
        raise SystemExit(f"observability capture invalid "
                         f"({len(errs)} errors)")
    print("[sssp_serve] trace: schema + answer chains valid", flush=True)


if __name__ == "__main__":
    main()
