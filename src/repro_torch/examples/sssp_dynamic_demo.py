"""Dynamic-graph demo: one graph, interleaved inserts / deletes / queries
— the port of the JAX package's ``examples/sssp_dynamic_demo.py``.

Walks the mutation API end to end: an initial solve, then edge inserts,
weight updates and deletes — including disconnecting and reconnecting a
region — each committed as a mutation batch and repaired incrementally
(dynamic/repair.py) on ``--device``, with every repaired distance row
checked **bitwise** (dist and pred) against a fresh ``serial`` solve on the
mutated snapshot.  The same graph is then registered in the serving stack
to show the mutation tick and the cache's selective reconciliation.

    PYTHONPATH=src python -m repro_torch.examples.sssp_dynamic_demo \\
        [--device cuda|cpu]

Returns a summary dict; a mismatch exits non-zero.
"""
from __future__ import annotations

import argparse

import numpy as np

SOURCE = 0


def check(dyn, res, label, device):
    from repro_torch.core.api import shortest_paths

    ref = shortest_paths(dyn.snapshot(), SOURCE, engine="serial",
                         device=device)
    if not np.array_equal(res.dist, ref.dist):
        raise SystemExit(f"{label}: dist mismatch")
    if not np.array_equal(res.pred, ref.pred):
        raise SystemExit(f"{label}: pred mismatch")
    reach = int(np.isfinite(res.dist).sum())
    print(f"  {label:28s} == serial on snapshot "
          f"(v{dyn.version}, {reach}/{dyn.n} reachable, "
          f"{res.edges_relaxed} edges relaxed)")


def main(argv=None) -> dict:
    from repro_torch.core import csr as C
    from repro_torch.core.api import resolve_device, shortest_paths
    from repro_torch.dynamic import DynamicGraph, repair_sssp, solve_dynamic
    from repro_torch.serve import (DistanceCache, GraphRegistry,
                                   MicroBatchScheduler)

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    checked = 0

    cg = C.random_csr_graph(500, 1500, seed=7)
    dyn = DynamicGraph(cg, overlay_capacity=64, compact_threshold=48)
    res = solve_dynamic(dyn, SOURCE, device=dev)
    print(f"graph: n={dyn.n}, live arcs={dyn.nnz_live}, "
          f"initial solve {res.edges_relaxed} edges relaxed, on {dev}")
    check(dyn, res, "initial solve", dev)
    checked += 1

    # a batch of inserts: new shortcuts lower a few rows
    dyn.add_edge(3, 441, 0.9)
    dyn.add_edge(17, 202, 2.5)
    res, stats = repair_sssp(dyn, res, dyn.commit(), device=dev)
    check(dyn, res, "2 inserts", dev)
    checked += 1

    # weight updates in both directions (decrease seeds, increase cones)
    dyn.update_edge(3, 441, 55.0)          # increase: invalidates a cone
    dyn.update_edge(17, 202, 0.4)          # decrease: seeds a frontier
    res, stats = repair_sssp(dyn, res, dyn.commit(), device=dev)
    print(f"    (cone {stats.cone}, seeds {stats.seeds}, "
          f"updates {stats.updates})")
    check(dyn, res, "increase + decrease", dev)
    checked += 1

    # delete the source's own tree edges until part of the graph falls off
    cut = np.nonzero(res.pred == SOURCE)[0].tolist()
    for v in cut:
        dyn.delete_edge(SOURCE, v)
    res, stats = repair_sssp(dyn, res, dyn.commit(), device=dev)
    print(f"    (cut {len(cut)} tree edges at the source, "
          f"cone {stats.cone})")
    check(dyn, res, f"delete {len(cut)} tree edges", dev)
    checked += 1

    # reconnect with one cheap highway
    far = int(np.argmax(np.where(np.isfinite(res.dist), -1.0,
                                 np.arange(dyn.n, dtype=float))))
    if not np.isfinite(res.dist[far]):
        dyn.add_edge(SOURCE, far, 1.0)
        res, _ = repair_sssp(dyn, res, dyn.commit(), device=dev)
        check(dyn, res, "reconnect via new edge", dev)
        checked += 1

    print(f"overlay {dyn.overlay_used}/{dyn.overlay_capacity} live arcs, "
          f"{dyn.compactions} compactions so far")

    # the serving stack on the same mutable graph
    registry = GraphRegistry(device=dev)
    sched = MicroBatchScheduler(registry, DistanceCache(64), max_batch=8)
    registry.register("road", dyn, landmarks=4)
    for s in (2, 9, 2, 31):
        sched.submit("road", s)
    sched.drain()
    sched.submit_mutation("road", "add", 2, 490, 1.25)
    sched.submit("road", 2)                # same tick: post-mutation answer
    (ack, ans) = sched.tick()
    if not (ack.via == "mutate" and ans.query.source == 2):
        raise SystemExit(f"mutation tick answered {ack.via!r} / "
                         f"{ans.query.source}")
    ref = shortest_paths(dyn.snapshot(), 2, engine="serial",
                         device=dev).dist
    if not np.array_equal(ans.value, ref):
        raise SystemExit("served post-mutation row differs from serial")
    checked += 1
    s = sched.stats()
    print(f"serving: mutation tick ok (via {ans.via!r}, version "
          f"{registry.get('road').version}); cache rows kept "
          f"{s['rows_kept']}, repaired {s['rows_repaired']}, "
          f"invalidated {s['rows_invalidated']}")
    print("all repaired rows bitwise-equal to serial on the mutated graph")
    return {"device": str(dev), "rows_checked": checked,
            "version": registry.get("road").version,
            "compactions": dyn.compactions, "dist": res.dist,
            "stats": {k: s[k] for k in ("rows_kept", "rows_repaired",
                                        "rows_invalidated")}}


if __name__ == "__main__":
    main()
