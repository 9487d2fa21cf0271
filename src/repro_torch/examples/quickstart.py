"""Quickstart: the paper's SSSP engines through the public API, in seconds
— the SSSP part of the JAX package's ``examples/quickstart.py`` (its LM
part comes with the training substrate, ROADMAP A.13).

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``serial`` (Alg. 1), ``bellman`` (Alg. 3/4) and ``bellman_kernel`` (the
min-plus matvec kernel on CUDA) on one graph, then ``multisource``; every
distance row is checked bitwise against ``serial``'s.  Returns the
distances by engine.
"""
from __future__ import annotations

import argparse

import numpy as np


def main(argv=None) -> dict:
    from repro_torch.core import graph as G
    from repro_torch.core.api import resolve_device, shortest_paths

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- 1. SSSP: serial (Alg.1), fixpoint (Alg.3/4), CUDA kernel --------
    g = G.random_graph(500, 1500, seed=0)
    print(f"graph: {g.n} vertices, {g.num_edges} edges, on {dev}")

    dists = {}
    for engine in ("serial", "bellman", "bellman_kernel"):
        res = shortest_paths(g, source=0, engine=engine, device=dev)
        reached = int(np.isfinite(res.dist).sum())
        extra = f", {res.sweeps} sweeps" if res.sweeps is not None else ""
        print(f"  {engine:16s}: reached {reached}/{g.n}{extra}; max dist "
              f"{np.nanmax(np.where(np.isfinite(res.dist), res.dist, np.nan)):.2f}")
        dists[engine] = res.dist

    # --- 2. multi-source batching (beyond-paper) --------------------------
    sources = np.array([0, 7, 99])
    res = shortest_paths(g, sources, engine="multisource", device=dev)
    print(f"  multisource     : dist matrix {res.dist.shape}, "
          f"{res.sweeps} sweeps")
    dists["multisource"] = res.dist

    for engine in ("bellman", "bellman_kernel"):
        if dists[engine].tobytes() != dists["serial"].tobytes():
            raise SystemExit(f"quickstart: {engine} differs from serial")
    for i, s in enumerate(sources):
        ref = shortest_paths(g, int(s), engine="serial", device=dev).dist
        if res.dist[i].tobytes() != ref.tobytes():
            raise SystemExit(f"quickstart: multisource row {s} differs "
                             f"from serial")
    print("\nquickstart OK: every row bitwise equal to serial's")
    return dists


if __name__ == "__main__":
    main()
