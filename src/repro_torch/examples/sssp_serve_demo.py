"""Serving subsystem demo: two registered graphs, interleaved scenarios —
the port of the JAX package's ``examples/sssp_serve_demo.py``.

Registers a road-network-ish sparse graph and a denser small-world-ish
graph in one ``GraphRegistry`` on ``--device`` (with ALT landmarks), then
interleaves the three workload scenarios — uniform full-row queries,
Zipf-skewed repeat sources, and point-to-point pairs — against BOTH graphs
through a single ``MicroBatchScheduler``, printing where each answer came
from (cache / landmark / batched engine / target early exit) and the
end-of-run stats.  Two answers are checked against ``serial``.

    PYTHONPATH=src python -m repro_torch.examples.sssp_serve_demo \\
        [--device cuda|cpu]

Returns a summary dict; a mismatch exits non-zero.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    from repro_torch.core import csr as C
    from repro_torch.core.api import resolve_device, shortest_paths
    from repro_torch.serve import (DistanceCache, GraphRegistry,
                                   MicroBatchScheduler, make_trace)

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # two graphs with different shapes: Table-II sparsity vs 8x denser
    road = C.random_csr_graph(600, 1800, seed=0)
    web = C.random_csr_graph(400, 3200, seed=1)

    registry = GraphRegistry(byte_budget=64 << 20, device=dev)
    cache = DistanceCache(capacity=128)
    sched = MicroBatchScheduler(registry, cache, max_batch=8)
    registry.register("road", road, landmarks=6)
    registry.register("web", web, landmarks=6)
    print(f"registered: {registry.names}, "
          f"{registry.bytes_in_use / 1e6:.2f} MB in use on {dev}")

    sizes = [("road", road.n), ("web", web.n)]
    vias = {}
    for scen in ("uniform", "zipf", "p2p"):
        for ev in make_trace(scen, sizes, num_queries=30, rate=1e4,
                             seed=42):
            sched.submit(ev.graph, ev.source, ev.target, arrival=ev.arrival)
        answers = sched.drain()
        by_via = {}
        for a in answers:
            by_via.setdefault(a.via, 0)
            by_via[a.via] += 1
        vias[scen] = by_via
        print(f"{scen:8s}: {len(answers)} answers via {by_via}")

    # spot-check two answers against the serial engine (the full bitwise
    # sweep lives in the serving tests and the --smoke driver)
    sched.submit("road", 17)
    (ans,) = sched.drain()
    ref = shortest_paths(road, 17, engine="serial", device=dev).dist
    if not np.array_equal(ans.value, ref):
        raise SystemExit("sssp(road, 17) differs from serial")
    print(f"spot-check: sssp(road, 17) via {ans.via!r} == serial row")
    row = ans.value

    sched.submit("web", 3, 250)
    (ans,) = sched.drain()
    ref = shortest_paths(web, 3, engine="serial", device=dev).dist
    if np.float32(ans.value) != ref[250]:
        raise SystemExit(f"dist(web, 3, 250) = {ans.value} differs from "
                         f"serial's {ref[250]}")
    print(f"spot-check: dist(web, 3, 250) via {ans.via!r} == serial "
          f"({ans.value:.4f})")

    stats = sched.stats()
    print("\nfinal stats:")
    for k, v in stats.items():
        print(f"  {k}: {v}")
    return {"device": str(dev), "answered_via": vias, "road_17": row,
            "web_3_250": float(ans.value), "stats": stats}


if __name__ == "__main__":
    main()
