"""Tracked dynamic-graph benchmark of the port: incremental repair against a
full re-solve (port of benchmarks/dynamic_bench.py).

On the paper's sparse corpus shape (m = 3n), for each mutation-batch size
B in {1, 8}: starting from a solved source row, apply WARMUP + ROUNDS
seeded batches of B edits (``EdgeChurn``: add / delete / update mixed, so
both repair directions run) and after each commit time

* ``repair_sssp``, chained (each round repairs the previous round's
  result), and
* ``solve_dynamic``, a full frontier re-solve on the same committed
  operands (same sweep, same staged tensors),

holding the two bitwise equal, dist and pred, every round (a mismatch is a
hard exit).  Steady state is the median over the counted rounds; the
warm-up rounds are discarded.  Walls are host clock around each call,
which returns numpy, so the device work has ended.

The ``gate``, per batch size: repair relaxes strictly fewer edges than the
full re-solve (medians of the engines' own ``edges_relaxed``, both
counting base-arc slots) and is at least ``min_ratio`` times faster (2.0
at n = 10000; 1.2 at the smoke size, where fixed costs dominate).

    PYTHONPATH=src python -m repro_torch.benchmarks.dynamic_bench \
        [--smoke] [--device cuda|cpu] [--out PATH]

writes ``BENCH_torch_dynamic.json`` (never the JAX package's
``BENCH_dynamic.json``).  ``--cost-out`` of the JAX bench comes with
``obs/``.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.benchmarks.common import REPO, device_meta
from repro_torch.core import csr as C
from repro_torch.core.api import resolve_device
from repro_torch.dynamic import DynamicGraph, repair_sssp, solve_dynamic
from repro_torch.serve.workload import EdgeChurn

DEFAULT_OUT = str(REPO / "BENCH_torch_dynamic.json")

BATCH_SIZES = (1, 8)
ROUNDS = 12            # counted rounds per batch size
WARMUP = 2             # discarded
SOURCE = 0
OVERLAY_CAPACITY = 512  # > ROUNDS * max batch: no mid-measurement compaction

NOT_PORTED = {"--cost-out": "per-round cost records come with obs/"}


def apply_batch(dyn: DynamicGraph, churn: EdgeChurn, size: int) -> None:
    """One mutation batch: ``size`` edits drawn by the churn sampler,
    applied to the overlay."""
    for _ in range(size):
        op, u, v, w = churn.sample()
        dyn.apply((op, u, v) if w is None else (op, u, v, w))


def churn_rounds(dyn: DynamicGraph, churn: EdgeChurn, B: int, prev,
                 rounds: int, device):
    """``rounds`` rounds of B-edit batches on ``dyn``, chained from the
    solved row ``prev``: each round applies a batch, commits, and times a
    ``repair_sssp`` of the previous round's row and a full
    ``solve_dynamic`` (host clock; both return numpy, so the device work
    has ended), holding the two bitwise equal, dist and pred (SystemExit
    otherwise).  Yields ``(prev, batch, res, stats, full, t_rep, t_full)``
    a round, ``prev`` being the row that round repaired."""
    source = int(prev.sources[0])
    for rnd in range(rounds):
        apply_batch(dyn, churn, B)
        batch = dyn.commit()
        t0 = time.perf_counter()
        res, stats = repair_sssp(dyn, prev, batch, device=device)
        t_rep = time.perf_counter() - t0
        t0 = time.perf_counter()
        full = solve_dynamic(dyn, source, device=device)
        t_full = time.perf_counter() - t0
        if not (res.dist.tobytes() == full.dist.tobytes()
                and np.array_equal(res.pred, full.pred)):
            raise SystemExit(
                f"repair != full re-solve at n={dyn.n} B={B} round {rnd}")
        yield prev, batch, res, stats, full, t_rep, t_full
        prev = res


def run_batch_size(n: int, B: int, seed: int, device) -> dict:
    """WARMUP + ROUNDS rounds of B-edit batches on a fresh sparse graph;
    returns the record of medians over the counted rounds."""
    cg = C.random_csr_graph(n, 3 * n, seed=seed)
    dyn = DynamicGraph(cg, overlay_capacity=OVERLAY_CAPACITY)
    churn = EdgeChurn(dyn.base, np.random.default_rng(seed + 1))
    prev = solve_dynamic(dyn, SOURCE, device=device)
    t_rep, t_full, e_rep, e_full, cones = [], [], [], [], []
    for rnd, (_, _, res, stats, full, dt_rep, dt_full) in enumerate(
            churn_rounds(dyn, churn, B, prev, WARMUP + ROUNDS, device)):
        if rnd >= WARMUP:
            t_rep.append(dt_rep)
            t_full.append(dt_full)
            e_rep.append(res.edges_relaxed)
            e_full.append(full.edges_relaxed)
            cones.append(stats.cone)
    med = lambda xs: float(np.median(xs))
    rec = {
        "n": n, "m": 3 * n, "batch_edges": B, "rounds": ROUNDS,
        "repair_time_s": med(t_rep),
        "full_time_s": med(t_full),
        "speedup": med(t_full) / med(t_rep),
        "repair_edges": int(med(e_rep)),
        "full_edges": int(med(e_full)),
        "edge_ratio": med(e_rep) / max(med(e_full), 1),
        "cone_median": int(med(cones)),
        "verified_bitwise_vs_full": True,
    }
    print(f"  n={n} B={B}: repair {rec['repair_time_s'] * 1e3:8.2f} ms "
          f"({rec['repair_edges']:>8d} edges, cone {rec['cone_median']}) "
          f"vs full {rec['full_time_s'] * 1e3:8.2f} ms "
          f"({rec['full_edges']:>8d} edges) -> {rec['speedup']:.2f}x",
          flush=True)
    return rec


def run(smoke: bool = False, out: str = DEFAULT_OUT, device="cuda") -> str:
    """Run the bench on ``device``, write ``out``, then exit non-zero if
    the gate fails (after writing)."""
    dev = resolve_device(device)
    n = 1000 if smoke else 10000
    records = [run_batch_size(n, B, seed=n + B, device=dev)
               for B in BATCH_SIZES]
    min_ratio = 2.0 if n >= 10000 else 1.2
    points, ok = [], True
    for r in records:
        fewer = r["repair_edges"] < r["full_edges"]
        fast = r["speedup"] >= min_ratio
        points.append({
            "batch_edges": r["batch_edges"],
            "repair_edges": r["repair_edges"],
            "full_edges": r["full_edges"],
            "repair_fewer": fewer,
            "speedup": r["speedup"],
            "fast_enough": fast,
        })
        ok = ok and fewer and fast
    gate = {
        "rule": (f"per mutation-batch size in {list(BATCH_SIZES)} at sparse "
                 f"n={n}: incremental repair relaxes strictly fewer edges "
                 f"than a full frontier re-solve and is >= {min_ratio}x "
                 "faster steady-state (medians, bitwise-verified rounds)"),
        "min_ratio": min_ratio,
        "points": points,
        "pass": bool(ok),
    }
    doc = {
        "schema": 1,
        "meta": {
            "created_unix": int(time.time()),
            **device_meta(dev),
            "smoke": smoke,
            "rounds": ROUNDS, "warmup": WARMUP,
            "overlay_capacity": OVERLAY_CAPACITY, "source": SOURCE,
            "not_ported": NOT_PORTED,
        },
        "results": records,
        "gate": gate,
    }
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"\nwrote {len(records)} batch-size records to {out}")
    from repro_torch.benchmarks.gates import enforce
    enforce(doc)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.dynamic_bench")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke-sized corpus (n = 1000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    run(args.smoke, out=args.out, device=args.device)


if __name__ == "__main__":
    main()
