"""Weak scaling — the experiment the paper could NOT run (footnote 7: "the
current implementation cannot perform efficient weak scaling because ...
the graph file is difficult to generate"); the port of the JAX package's
``benchmarks/weak_scaling.py``, same sizes, same CSV.

The generators are procedural, so weak scaling is one loop: hold vertices
per process constant (n = base_n × procs) and time every sharded engine,
each P in its own ``sssp_run --procs P`` subprocess of ``--ranks-device``
ranks (gloo on the host for ``cpu``; NCCL with one GPU a rank for
``cuda``, where fewer GPUs than P raise).  The Dijkstra engine's time grows
~linearly with procs at fixed n/proc (n iterations, each a collective
round) — the paper's diagnosis again; the fixpoint engine stays near-flat
until the sweep work dominates.

The CSR engines never build the dense matrix, so their leg holds 8 ×
``base_n`` vertices a process (still m = 3n, the Table II shape): the
paper's footnote-7 experiment run with edges, ``frontier_sharded`` keeping
the per-sweep exchange at O(|frontier|), the MPI-message analogue.

    PYTHONPATH=src python -m repro_torch.benchmarks.weak_scaling \\
        [--quick] [--ranks-device cuda|cpu]
"""
from __future__ import annotations

import argparse
import re

from repro_torch.benchmarks.common import (device_meta, ranks_label,
                                           run_with_procs, write_csv)

PROCS = (1, 2, 4, 8)
ENGINES = ("dijkstra_sharded", "bellman_sharded",
           "bellman_csr_sharded", "frontier_sharded")


def run(quick: bool = False, base_n: int = 512, ranks_device="cuda"):
    base_n = 256 if quick else base_n
    rows = []
    for engine in ENGINES:
        # CSR engines never build the dense matrix: scale their leg 8x
        # further per process (still m = 3n, the Table II shape).
        eng_base = base_n if engine in ("dijkstra_sharded",
                                        "bellman_sharded") else 8 * base_n
        t1 = None
        for procs in PROCS:
            n = eng_base * procs
            out = run_with_procs(
                ["--engine", engine, "--nodes", str(n), "--edges", str(3 * n),
                 "--repeats", "2"], procs, ranks_device)
            t = float(re.search(r"time=([\d.e+-]+)s", out).group(1))
            t1 = t1 or t
            eff = t1 / t * 100            # weak-scaling efficiency
            rows.append([engine, procs, n, f"{t:.6f}", f"{eff:.2f}"])
            print(f"{engine:18s} procs={procs:2d} n={n:6d} "
                  f"time={t:.5f}s weak-eff={eff:6.1f}% "
                  f"[{ranks_label(procs, ranks_device)}]", flush=True)
    return write_csv("weak_scaling.csv",
                     ["engine", "procs", "nodes", "time_s",
                      "weak_efficiency_pct"], rows,
                     meta=device_meta(ranks_device) | {"columns": {
                         "time_s": ranks_label("P", ranks_device)}})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--ranks-device", default="cuda",
                    help="device of the P ranks: 'cuda' (NCCL, one GPU a "
                         "rank) or 'cpu' (gloo ranks on the host)")
    args = ap.parse_args(argv)
    return run(args.quick, ranks_device=args.ranks_device)


if __name__ == "__main__":
    main()
