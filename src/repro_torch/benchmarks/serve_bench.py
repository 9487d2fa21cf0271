"""Tracked serving benchmark gate — batched serving vs per-query solving
(port of benchmarks/serve_bench.py, with JAX's gates).

Replays the three synthetic workload scenarios (repro_torch/serve/
workload.py) through the serving subsystem in closed loop (submit
everything, drain) and measures queries/s, then replays the SAME trace
sequentially — one fresh single-source solve per query, no dedup, no
cache, no batching — and writes the comparison to
``BENCH_torch_serve.json``.  The sequential solves use the engine the
device's dispatch names for the frontier family: ``frontier_kernel`` on a
CUDA device (the best per-query solve the port has), ``frontier`` on the
CPU; each record names it (``sequential_engine``).

The ``gate`` section asserts, on the largest Zipf point:

* batched-serving queries/s >= ``min_ratio`` x sequential per-query
  solving (1.5x at the full n=10000 scale; 1.0x for smoke-sized corpora
  where fixed overheads dominate), and
* the distance cache actually hits on the skewed scenario (hit rate > 0).

Correctness rides along: every served answer on the verified points
(n <= 2000) is checked bitwise against a fresh ``serial`` solve.

``--overload`` adds the DEGRADED-MODE leg: the sustainable p2p service
rate is measured closed-loop, then the same workload is offered OPEN-LOOP
at 2x that rate against (a) an unprotected scheduler and (b) a protected
one (bounded queue + per-query deadlines + landmark/stale degradation).
Its ``gate_overload`` asserts the protected scheduler SHEDS OR DEGRADES
rather than collapses: every accepted query is answered, the overload
protection actually engages, and the p99 latency of served (ok) answers
stays <= 2x the deadline.

``--obs`` adds the tracing-overhead leg: ``gate_obs`` asks traced steady
Zipf throughput >= 0.9x untraced (best of paired drains).

``--devices P > 1`` (JAX's sharded leg and ``gate_sharded``) raises
``NotImplementedError``: the sharded engines are not ported yet (ROADMAP
A.11).

    PYTHONPATH=src python -m repro_torch.benchmarks.serve_bench [--smoke]
        [--device cuda|cpu] [--overload] [--obs] [--out PATH]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

from repro_torch.benchmarks.common import REPO, device_meta
from repro_torch.core import csr as C
from repro_torch.core.api import refuse_sharded, resolve_device, shortest_paths
from repro_torch.serve import (DispatchPolicy, DistanceCache, GraphRegistry,
                               MicroBatchScheduler, SCENARIOS, make_trace)
from repro_torch.serve.dispatch import engine_for

DEFAULT_OUT = str(REPO / "BENCH_torch_serve.json")

# scenario trace parameters (rate only shapes arrival stamps; both sides
# replay closed-loop so the comparison is pure service throughput)
RATE = 1000.0
LANDMARKS = 8
MAX_BATCH = 16
CACHE_ROWS = 256


def _make_scheduler(cg, device, dispatch=None, **sched_kwargs):
    """Serving stack for one graph on ``device``, warmed: one batched
    solve per source-bucket size a drain can hit, plus the p2p path (on a
    CUDA device the first launch of a kernel builds it), so set-up stays
    outside the timed windows.  Default policy: the device's threshold
    policy at one device.  Extra kwargs reach the scheduler (the overload
    leg's max_queue/degrade knobs)."""
    from repro_torch.core.bellman_csr import sssp_multisource_csr
    from repro_torch.core.frontier import sssp_frontier

    if dispatch is None:
        dispatch = DispatchPolicy(shard_threshold=None, nprocs=1,
                                  device=device)
    registry = GraphRegistry(device=device)
    cache = DistanceCache(capacity=CACHE_ROWS)
    sched = MicroBatchScheduler(registry, cache, max_batch=MAX_BATCH,
                                dispatch=dispatch, **sched_kwargs)
    handle = registry.register("g", cg, landmarks=LANDMARKS)
    b = 1
    while True:
        sssp_multisource_csr(handle.csr_ops(),
                             torch.zeros(b, dtype=torch.int64,
                                         device=handle.device),
                             n=cg.n, sweep_fn=handle.multisource_sweep_fn())
        if b >= MAX_BATCH:
            break
        b *= 2
    for lb in (0.0, None):
        sssp_frontier(handle.frontier_ops(), 0, n=cg.n,
                      sweep_fn=handle.frontier_sweep_fn(), target=1,
                      target_lb=lb)
    return sched


def _drain_timed(sched, events, cg, *, verify: bool):
    """Submit + drain one trace closed-loop; returns (qps, hit_rate over
    this drain only)."""
    h0, m0 = sched.cache.hits, sched.cache.misses
    t0 = time.perf_counter()
    for e in events:
        sched.submit("g", e.source, e.target, arrival=e.arrival)
    answers = sched.drain()
    dt = time.perf_counter() - t0
    if verify:
        _verify(cg, answers, sched.registry.device)
    probes = (sched.cache.hits - h0) + (sched.cache.misses - m0)
    hit_rate = (sched.cache.hits - h0) / probes if probes else 0.0
    return len(events) / dt, hit_rate


def _replay_sequential(cg, events, device):
    """The pre-serve baseline: one fresh single-source frontier-family
    solve per query (``frontier_kernel`` on CUDA, ``frontier`` on the
    CPU), in trace order — no dedup, no cache, no batching.  Point-to-point
    queries index the solved row (no target early exit — that optimization
    belongs to the serving layer under test).  Returns (qps, engine)."""
    engine = engine_for("frontier", device)
    shortest_paths(cg, 0, engine=engine, device=device)     # warm
    t0 = time.perf_counter()
    for e in events:
        res = shortest_paths(cg, e.source, engine=engine, device=device)
        _ = res.dist if e.target is None else float(res.dist[e.target])
    return len(events) / (time.perf_counter() - t0), engine


def _verify(cg, answers, device):
    # serial rows memoized on the graph: every drain of the run checks
    # against the same fresh solve of a source
    rows = cg._memo(("serve_bench_serial_rows", str(device)), dict)
    for a in answers:
        q = a.query
        if q.source not in rows:
            rows[q.source] = shortest_paths(cg, q.source, engine="serial",
                                            device=device).dist
        ref = rows[q.source]
        if q.target is None:
            ok = np.asarray(a.value).tobytes() == ref.tobytes()
        else:
            got, want = np.float32(a.value), ref[q.target]
            ok = got == want or (np.isinf(got) and np.isinf(want))
        if not ok:
            raise SystemExit(
                f"served answer mismatch vs serial: {q} via {a.via}")


def _replay_open_loop(sched, events):
    """Wall-clock open-loop replay with deadlines (launch/sssp_serve.py's
    ``replay``: backpressure-rejected submits are dropped, ticks take the
    live clock so expiry/degradation engage).  Returns (answers,
    rejected)."""
    from repro_torch.launch.sssp_serve import replay

    rejected0 = sched.submissions_rejected
    answers, _, _ = replay(sched, events)
    return answers, sched.submissions_rejected - rejected0


def _p99(latencies) -> float:
    lat = np.asarray(sorted(latencies), np.float64)
    return float(np.percentile(lat, 99)) if lat.size else 0.0


def _run_overload(smoke: bool, device):
    """The --overload leg (see module docstring): 2x-sustainable offered
    load against the unprotected vs the protected scheduler.  Returns
    (record, gate_overload)."""
    n = 1000 if smoke else 10000
    span = 0.5 if smoke else 1.0          # seconds of offered arrivals
    cg = C.random_csr_graph(n, 3 * n, seed=n)

    # Both schedulers under test are warmed IN PLACE (distance cache +
    # staged operands) before the overload arrives: the leg measures a
    # steady-state server hit with 2x load, not a cold start whose first
    # tick alone outlives every deadline.
    warm = make_trace("p2p", [("g", n)], num_queries=160, rate=RATE,
                      seed=7, hot_seed=13)
    steady = make_trace("p2p", [("g", n)], num_queries=160, rate=RATE,
                        seed=8, hot_seed=13)
    schedU = _make_scheduler(cg, device)
    _drain_timed(schedU, warm, cg, verify=False)
    # sustainable service rate: closed-loop steady drain, warm cache
    capacity, _ = _drain_timed(schedU, steady, cg, verify=False)
    # service-time-aware deadline: a full batch costs ~MAX_BATCH/capacity
    # seconds of solve time on THIS host at THIS graph size, so each query
    # gets a few batch-times of budget.
    deadline = float(min(max(6.0 * MAX_BATCH / capacity, 0.1), 1.0))
    # protected: bounded queue + deadlines + degraded fallbacks.
    # margin = deadline/2: a query that has burned half its budget in the
    # queue is answered from landmark bounds instead of gambling on an
    # exact solve it may not get.
    schedP = _make_scheduler(cg, device, max_queue=16 * MAX_BATCH,
                             degrade_margin=deadline / 2)
    _drain_timed(schedP, warm, cg, verify=False)
    _drain_timed(schedP, steady, cg, verify=False)
    offered = 2.0 * capacity
    # enough arrivals to span many ticks at the offered rate — an
    # open-loop trace shorter than one tick is just a burst, not load.
    queries = int(min(max(offered * span, 240), 4000))
    trace = make_trace("p2p", [("g", n)], num_queries=queries,
                       rate=offered, seed=9, hot_seed=13,
                       deadline=deadline)

    # unprotected: unbounded queue, no deadlines — queueing compounds
    ansU, _ = _replay_open_loop(
        schedU, [dataclasses.replace(e, deadline=None) for e in trace])
    p99_unprotected = _p99(a.done_at - a.query.arrival for a in ansU)

    ansP, rejected = _replay_open_loop(schedP, trace)
    served = [a for a in ansP if a.status == "ok"]
    _verify(cg, [a for a in served if a.exact], device)
    p99_served = _p99(a.done_at - a.query.arrival for a in served)
    sP = schedP.stats()
    shed_total = rejected + sP["shed"] + sP["deadline_expired"]
    accepted = queries - rejected

    rec = {
        "scenario": "p2p-overload", "n": n, "m": 3 * n,
        "queries": queries, "deadline_s": round(deadline, 3),
        "sustainable_qps": round(capacity, 2),
        "offered_qps": round(offered, 2),
        "unprotected_p99_s": round(p99_unprotected, 4),
        "protected_p99_served_s": round(p99_served, 4),
        "accepted": accepted,
        "answered": len(ansP),
        "served_ok": len(served),
        "served_degraded": sP["degraded_p2p"] + sP["degraded_batch"],
        "rejected_at_submit": rejected,
        "shed": sP["shed"],
        "deadline_expired": sP["deadline_expired"],
        "statuses": sP["answered_status"],
    }
    degraded = rec["served_degraded"]
    print(f"  overload n={n}: offered {offered:7.1f} q/s (2x sustainable "
          f"{capacity:.1f}) | protected p99 {p99_served * 1e3:.1f} ms "
          f"({len(served)} served, {degraded} degraded, "
          f"{shed_total} shed/rejected/expired) vs unprotected p99 "
          f"{p99_unprotected * 1e3:.1f} ms", flush=True)
    gate = {
        "rule": (f"at 2x sustainable offered load the protected scheduler "
                 f"sheds or degrades instead of collapsing: every accepted "
                 f"query is answered, overload protection actually engages "
                 f"(rejected/shed/expired or degraded answers > 0), and "
                 f"served-answer p99 stays <= 2x the {deadline:.3f}s "
                 f"service-time-scaled deadline "
                 f"(unprotected p99 recorded for contrast)"),
        "protected_p99_served_s": rec["protected_p99_served_s"],
        "p99_bound_s": 2 * deadline,
        "shed_total": shed_total,
        "degraded": degraded,
        "all_accepted_answered": bool(len(ansP) == accepted),
        "pass": bool(len(ansP) == accepted and shed_total + degraded > 0
                     and p99_served <= 2 * deadline),
    }
    return rec, gate


def _run_obs(smoke: bool, device, trace_out=None):
    """The --obs leg: TWO identically-warmed serving stacks drain the
    same fresh-seeded Zipf steady traces — one with tracing disabled,
    one with a live Tracer + CostLog installed.  The gate pins the
    enabled/disabled throughput ratio >= 0.9 (best of paired drains).
    With ``trace_out`` the enabled side's artifacts are written +
    validated.  Returns (record, gate_obs)."""
    from repro_torch.obs import (CostLog, Tracer, cost_path_for,
                                 finalize_capture, set_cost_log, set_tracer)

    n = 1000 if smoke else 10000
    queries = 120 if smoke else 400
    # smoke drains finish in tens of ms, where run-to-run jitter swamps
    # any real tracing cost — take best-of-more there.
    reps = 7 if smoke else 3
    cg = C.random_csr_graph(n, 3 * n, seed=n)
    cold = make_trace("zipf", [("g", n)], num_queries=queries,
                      rate=RATE, seed=7, hot_seed=13)
    sched_off = _make_scheduler(cg, device)
    sched_on = _make_scheduler(cg, device)
    _drain_timed(sched_off, cold, cg, verify=False)
    _drain_timed(sched_on, cold, cg, verify=False)
    tr, cl = Tracer(), CostLog()
    off_qps, on_qps = [], []
    for rep in range(reps):
        # fresh event seed per rep, shared hot set; both sides replay the
        # identical trace, and the side order flips each rep so clock /
        # cache drift cannot bias one leg.
        steady = make_trace("zipf", [("g", n)], num_queries=queries,
                            rate=RATE, seed=8 + rep, hot_seed=13)

        def _off():
            off_qps.append(_drain_timed(sched_off, steady, cg,
                                        verify=False)[0])

        def _on():
            prev_tr, prev_cl = set_tracer(tr), set_cost_log(cl)
            try:
                on_qps.append(_drain_timed(sched_on, steady, cg,
                                           verify=False)[0])
            finally:
                set_tracer(prev_tr)
                set_cost_log(prev_cl)

        first, second = (_off, _on) if rep % 2 == 0 else (_on, _off)
        first()
        second()
    qps_off, qps_on = max(off_qps), max(on_qps)
    ratio = qps_on / qps_off
    if trace_out:
        errs = finalize_capture(tr, cl, trace_out)
        print(f"  obs      trace: {len(tr.spans)} spans -> {trace_out} | "
              f"{len(cl.records)} cost records -> {cost_path_for(trace_out)}",
              flush=True)
        if errs:
            for e in errs[:20]:
                print(f"  obs      trace INVALID: {e}", flush=True)
            raise SystemExit("observability capture invalid")
    rec = {
        "scenario": "zipf-obs", "n": n, "m": 3 * n,
        "queries_per_trace": queries, "reps": reps,
        "tracing_off_qps": round(qps_off, 2),
        "tracing_on_qps": round(qps_on, 2),
        "tracing_ratio": round(ratio, 4),
        "spans": len(tr.spans),
        "cost_records": len(cl.records),
    }
    print(f"  obs      n={n}: tracing off {qps_off:8.1f} / on "
          f"{qps_on:8.1f} q/s ({ratio:.3f}x, best of {reps}), "
          f"{len(tr.spans)} spans, {len(cl.records)} cost records",
          flush=True)
    gate = {
        "rule": (f"tracing-enabled steady Zipf serving throughput >= 0.9x "
                 f"tracing-disabled on the same warm trace at n={n} "
                 f"(best of {reps} drains each)"),
        "tracing_ratio": rec["tracing_ratio"],
        "min_ratio": 0.9,
        "pass": bool(ratio >= 0.9),
    }
    return rec, gate


def run(smoke: bool = False, out: str = DEFAULT_OUT, devices: int = 1,
        overload: bool = False, obs: bool = False, trace_out=None,
        device="cuda") -> str:
    refuse_sharded(devices, "serve_bench")
    dev = resolve_device(device)
    n = 1000 if smoke else 10000
    queries = 120 if smoke else 400
    verify = smoke or n <= 2000       # serial verify is O(n^2)/row: cap it
    cg = C.random_csr_graph(n, 3 * n, seed=n)
    records = []
    for scen in SCENARIOS:
        # two traces per scenario, different event seeds but a SHARED
        # Zipf hot set (hot_seed): the first drain is the cold start, the
        # second measures the steady serving state where the hot rows are
        # already cached.
        cold_trace = make_trace(scen, [("g", n)], num_queries=queries,
                                rate=RATE, seed=7, hot_seed=13)
        steady_trace = make_trace(scen, [("g", n)], num_queries=queries,
                                  rate=RATE, seed=8, hot_seed=13)
        sched = _make_scheduler(cg, dev)
        qps_cold, _ = _drain_timed(sched, cold_trace, cg, verify=verify)
        qps_steady, hit_steady = _drain_timed(sched, steady_trace, cg,
                                              verify=verify)
        qps_s, seq_engine = _replay_sequential(cg, steady_trace, dev)
        stats = sched.stats()
        rec = {
            "scenario": scen, "n": n, "m": 3 * n,
            "queries_per_trace": queries,
            "batched_cold_qps": round(qps_cold, 2),
            "batched_steady_qps": round(qps_steady, 2),
            "sequential_qps": round(qps_s, 2),
            "sequential_engine": seq_engine,
            "speedup_steady": round(qps_steady / qps_s, 3),
            "speedup_cold": round(qps_cold / qps_s, 3),
            "steady_cache_hit_rate": round(hit_steady, 4),
            "mean_occupancy": stats["mean_occupancy"],
            "dedup_saved": stats["dedup_saved"],
            "answered_via": stats["answered_via"],
            "verified_bitwise": verify,
        }
        records.append(rec)
        print(f"  {scen:8s} n={n}: batched cold {qps_cold:8.1f} / steady "
              f"{qps_steady:8.1f} q/s, sequential ({seq_engine}) "
              f"{qps_s:7.1f} q/s ({rec['speedup_steady']:.2f}x steady), "
              f"steady hit rate {hit_steady:.2f}", flush=True)

    zipf = next(r for r in records if r["scenario"] == "zipf")
    min_ratio = 1.5 if n >= 10000 else 1.0
    gate = {
        "rule": (f"steady-state batched serving >= {min_ratio}x sequential "
                 f"per-query {zipf['sequential_engine']} solves on the Zipf "
                 f"trace at n={n}, and the distance cache hits on the "
                 f"skewed scenario"),
        "zipf_speedup_steady": zipf["speedup_steady"],
        "min_ratio": min_ratio,
        "zipf_steady_cache_hit_rate": zipf["steady_cache_hit_rate"],
        "pass": bool(zipf["speedup_steady"] >= min_ratio
                     and zipf["steady_cache_hit_rate"] > 0),
    }
    from repro_torch.obs import backend_info

    backend, device_kind = backend_info(dev)
    doc = {
        "schema": 2,
        "meta": {
            "created_unix": int(time.time()),
            "backend": backend, "device_kind": device_kind,
            **device_meta(dev),
            "smoke": smoke,
            "devices": devices,
            "rate": RATE, "landmarks": LANDMARKS,
            "max_batch": MAX_BATCH, "cache_rows": CACHE_ROWS,
        },
        "results": records,
        "gate": gate,
    }
    if overload:
        orec, ogate = _run_overload(smoke, dev)
        doc["overload_results"] = [orec]
        doc["gate_overload"] = ogate
    if obs:
        brec, bgate = _run_obs(smoke, dev, trace_out=trace_out)
        doc["obs_results"] = [brec]
        doc["gate_obs"] = bgate
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"\nwrote {len(records)} scenario records to {out}")
    from repro_torch.benchmarks.gates import enforce
    enforce(doc)
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.serve_bench")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized corpus (n=1000, short traces)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--devices", type=int, default=1,
                    help="mesh size for the sharded leg; only 1 runs (the "
                         "sharded engines are not ported yet)")
    ap.add_argument("--overload", action="store_true",
                    help="add the 2x-offered-load degraded-mode leg and "
                         "its shed-don't-collapse gate")
    ap.add_argument("--obs", action="store_true",
                    help="add the observability-overhead leg: tracing on "
                         "vs off on the same warm Zipf trace, gated at "
                         ">= 0.9x")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="with --obs: write + validate the enabled leg's "
                         "Chrome trace (and .cost.jsonl) here")
    args = ap.parse_args(argv)
    return run(args.smoke, out=args.out, devices=args.devices,
               overload=args.overload, obs=args.obs,
               trace_out=args.trace_out, device=args.device)


if __name__ == "__main__":
    main()
