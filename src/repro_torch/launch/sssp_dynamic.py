"""Dynamic-serving driver: replay open-loop CHURN traces (mixed edge
mutations + queries) against the port's serve subsystem over mutable
graphs (port of repro/launch/sssp_dynamic.py, with the same flags plus
``--device``).

    PYTHONPATH=src python -m repro_torch.launch.sssp_dynamic --smoke \
        [--device cuda|cpu]

Mirrors launch/sssp_serve.py, but the registered graphs are
:class:`~repro_torch.dynamic.DynamicGraph` overlays and the trace
interleaves ``add``/``update``/``delete`` edge edits with the query stream
(serve/workload.make_churn_trace).  Each scheduler tick commits the
pending edits as one mutation batch BEFORE answering the tick's queries;
the registry's mutate hook then keeps, incrementally repairs, or
invalidates the affected distance-cache rows and lazily re-solves staled
landmarks (see serve/scheduler.py and dynamic/repair.py).

Two replay modes:

* default — wall-clock open loop (arrivals vs a real clock, latency
  includes queueing; launch/sssp_serve.py's ``replay``): reports
  p50/p99/qps plus the dynamic accounting (versions committed, rows
  kept/repaired/invalidated, repair edge work, landmark refreshes,
  overlay occupancy / compactions).
* ``--verify`` (default under ``--smoke``) — deterministic event-order
  replay: after EVERY event the queue is drained and each served answer
  is checked **bitwise** against a fresh ``serial`` solve on the mutated
  snapshot of the answer-time version.

``main`` returns a summary dict for in-process callers.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.core import csr as C
from repro_torch.core.api import resolve_device, shortest_paths
from repro_torch.dynamic import DynamicGraph
from repro_torch.launch.sssp_serve import replay
from repro_torch.serve import (DistanceCache, GraphRegistry, LatencyRecorder,
                               MicroBatchScheduler, MutationEvent,
                               make_churn_trace)


def _submit(sched: MicroBatchScheduler, e) -> None:
    if isinstance(e, MutationEvent):
        sched.submit_mutation(e.graph, e.op, e.u, e.v, e.w,
                              arrival=e.arrival)
    else:
        sched.submit(e.graph, e.source, e.target, arrival=e.arrival)


def replay_wallclock(sched: MicroBatchScheduler, events) -> list:
    """Open-loop wall-clock replay (launch/sssp_serve.py's, with mutation
    events submitted into the same clock); returns the answers."""
    return replay(sched, events)[0]


def replay_verified(sched: MicroBatchScheduler, events,
                    dyns: dict, device="cuda") -> tuple:
    """Deterministic event-order replay with bitwise verification: every
    answer is compared against a fresh ``serial`` solve on ``device`` on
    the snapshot of the graph version the answer was computed for (rows
    memoized per (graph, version, source) — versions are immutable once
    committed).  Returns (answers, distinct rows checked)."""
    rows: dict = {}

    def serial_row(graph: str, source: int) -> np.ndarray:
        key = (graph, dyns[graph].version, source)
        if key not in rows:
            rows[key] = shortest_paths(
                dyns[graph].snapshot(), source, engine="serial",
                device=device).dist
        return rows[key]

    answers = []
    for e in events:
        _submit(sched, e)
        for a in sched.drain(e.arrival):
            answers.append(a)
            if a.via == "mutate":
                continue
            q = a.query
            if a.via == "error":
                raise SystemExit(
                    f"scheduler returned an error answer for {q} "
                    f"(last mutation error: {sched.last_mutation_error})")
            ref = serial_row(q.graph, q.source)
            if q.target is None:
                if np.asarray(a.value).tobytes() != ref.tobytes():
                    raise SystemExit(
                        f"row mismatch vs serial: {q} (via {a.via}, "
                        f"version {dyns[q.graph].version})")
            else:
                got, want = np.float32(a.value), ref[q.target]
                if not (got == want or (np.isinf(got) and np.isinf(want))):
                    raise SystemExit(
                        f"dist mismatch vs serial: {q} (via {a.via}): "
                        f"served {got!r}, serial {want!r}")
    return answers, len(rows)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.sssp_dynamic")
    ap.add_argument("--smoke", action="store_true",
                    help="small graphs, short traces, verify on (CI-sized)")
    ap.add_argument("--n", type=int, default=None,
                    help="vertices per graph (default 10000; smoke 256)")
    ap.add_argument("--graphs", type=int, default=2)
    ap.add_argument("--events", type=int, default=None,
                    help="trace events incl. mutations "
                         "(default 400; smoke 120)")
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop arrival rate, events/s "
                         "(default 500; smoke 2000)")
    ap.add_argument("--mutate-frac", type=float, default=0.15)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--landmarks", type=int, default=8)
    ap.add_argument("--cache-rows", type=int, default=256)
    ap.add_argument("--repair-rows", type=int, default=8,
                    help="max cache rows repaired in place per "
                         "mutation batch (rest invalidated)")
    ap.add_argument("--overlay-capacity", type=int, default=256)
    ap.add_argument("--compact-threshold", type=int, default=None,
                    help="live overlay arcs that trigger compaction "
                         "(default: half the overlay capacity)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--verify", action=argparse.BooleanOptionalAction,
                    default=None,
                    help="deterministic bitwise replay vs serial "
                         "(default: on under --smoke)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="capture observability: Chrome trace JSON to "
                         "PATH, per-solve cost records to "
                         "PATH-with-.cost.jsonl; both are schema-"
                         "validated at exit (repro_torch/obs)")
    args = ap.parse_args(argv)

    from repro_torch.obs import get_cost_log, get_tracer, set_cost_log, \
        set_tracer

    dev = resolve_device(args.device)
    prev = get_tracer(), get_cost_log()
    capture = None
    if args.trace_out:
        from repro_torch.obs import install_capture
        capture = install_capture()
    try:
        return _run(args, dev, capture)
    finally:
        set_tracer(prev[0])
        set_cost_log(prev[1])


def _run(args, dev, capture) -> dict:
    n = args.n or (256 if args.smoke else 10000)
    events_n = args.events or (120 if args.smoke else 400)
    rate = args.rate or (2000.0 if args.smoke else 500.0)
    verify = args.verify if args.verify is not None else args.smoke
    threshold = (args.compact_threshold if args.compact_threshold is not None
                 else "auto")

    dyns = {}
    for i in range(args.graphs):
        cg = C.random_csr_graph(n, 3 * n, seed=args.seed + i)
        dyns[f"g{i}"] = DynamicGraph(
            cg, overlay_capacity=args.overlay_capacity,
            compact_threshold=threshold)

    registry = GraphRegistry(device=dev)
    cache = DistanceCache(capacity=args.cache_rows)
    sched = MicroBatchScheduler(registry, cache, max_batch=args.batch,
                                repair_rows=args.repair_rows)
    t0 = time.perf_counter()
    for name, dyn in dyns.items():
        registry.register(name, dyn, landmarks=args.landmarks,
                          landmark_seed=args.seed)
    prep_s = time.perf_counter() - t0

    events = make_churn_trace(
        [(name, dyn.base) for name, dyn in dyns.items()],
        num_events=events_n, rate=rate, mutate_frac=args.mutate_frac,
        seed=args.seed, hot_seed=args.seed + 101)
    n_mut = sum(isinstance(e, MutationEvent) for e in events)

    report = {"n": n, "events": len(events), "mutations": n_mut,
              "prep_s": prep_s}
    if verify:
        answers, checked = replay_verified(sched, events, dyns, device=dev)
        print(f"[sssp_dynamic] verified bitwise vs serial: "
              f"{len(answers)} answers ({n_mut} mutations) against "
              f"{checked} distinct (graph, version, source) rows",
              flush=True)
        report["verified_rows"] = checked
    else:
        answers = replay_wallclock(sched, events)
        rec = LatencyRecorder()
        for a in answers:
            rec.observe(a, a.done_at)
        lat = rec.summary()
        print(f"[sssp_dynamic] churn: {lat['queries']} answers "
              f"({n_mut} mutations, {args.graphs} graphs, n={n}, "
              f"prep {prep_s:.2f}s) | p50 {lat['p50_ms']:.1f} ms, "
              f"p99 {lat['p99_ms']:.1f} ms, {lat['qps']:.0f} ev/s",
              flush=True)
        if "queue_p50_ms" in lat:
            print(f"[sssp_dynamic] churn: queue wait "
                  f"p50 {lat['queue_p50_ms']:.1f} ms / "
                  f"p99 {lat['queue_p99_ms']:.1f} ms | service "
                  f"p50 {lat['service_p50_ms']:.1f} ms / "
                  f"p99 {lat['service_p99_ms']:.1f} ms", flush=True)
        report |= lat
    report["answers"] = len(answers)

    s = sched.stats()
    versions = {name: dyn.version for name, dyn in dyns.items()}
    overlays = {name: f"{dyn.overlay_used}/{dyn.overlay_capacity}"
                f"(+{dyn.compactions} compactions)"
                for name, dyn in dyns.items()}
    print(f"[sssp_dynamic] via {s['answered_via']}", flush=True)
    print(f"[sssp_dynamic] mutation batches {s['registry']['mutations']} "
          f"({s['registry']['edges_mutated']} edge deltas) -> versions "
          f"{versions} | cache rows kept {s['rows_kept']}, repaired "
          f"{s['rows_repaired']} ({s['repair_edges']} edges relaxed), "
          f"invalidated {s['rows_invalidated']} | landmark refreshes "
          f"{s['registry']['landmark_refreshes']} | overlay {overlays}",
          flush=True)
    c = s["cache"]
    print(f"[sssp_dynamic] cache: {c['hits']} hits / {c['misses']} misses "
          f"(rate {c['hit_rate']:.2f}), {c['evictions']} evictions, "
          f"{c['rows']}/{c['capacity']} rows", flush=True)
    report |= {"answered_via": dict(s["answered_via"]),
               "versions": versions, "rows_repaired": s["rows_repaired"],
               "rows_invalidated": s["rows_invalidated"]}
    if capture is not None:
        from repro_torch.obs import cost_path_for, finalize_capture
        tr, cl = capture
        errs = finalize_capture(tr, cl, args.trace_out)
        print(f"[sssp_dynamic] trace: {len(tr.spans)} spans, "
              f"{len(tr.instants)} instants -> {args.trace_out} | "
              f"{len(cl.records)} cost records -> "
              f"{cost_path_for(args.trace_out)}", flush=True)
        if errs:
            for e in errs[:20]:
                print(f"[sssp_dynamic] trace INVALID: {e}", flush=True)
            raise SystemExit(f"observability capture invalid "
                             f"({len(errs)} errors)")
        print("[sssp_dynamic] trace: schema + answer chains valid",
              flush=True)
    print("[sssp_dynamic] done", flush=True)
    return report


if __name__ == "__main__":
    main()
