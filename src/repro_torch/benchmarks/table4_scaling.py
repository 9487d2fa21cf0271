"""Paper Table IV / Fig. 6: strong scaling of the MPI-analogue Dijkstra —
the port of the JAX package's ``benchmarks/table4_scaling.py``, same sizes,
same efficiency formula, same CSV.

Each process count runs ``sssp_run --procs P`` in its own subprocess: P
ranks of ``--ranks-device`` (gloo ranks on the host for ``cpu``, the
paper's MPI ``-np`` on CPU cores; NCCL with one GPU a rank for ``cuda``,
where fewer GPUs than P raise).  The paper's observation — scaling
efficiency collapses because each of the n iterations carries a MINLOC
all-reduce — shows with ``dijkstra_sharded``; ``bellman_sharded`` (one
collective per *sweep*) is the fix the paper's §V.2 calls for.

    PYTHONPATH=src python -m repro_torch.benchmarks.table4_scaling \\
        [--quick] [--ranks-device cuda|cpu]
"""
from __future__ import annotations

import argparse
import re

from repro_torch.benchmarks.common import (device_meta, ranks_label,
                                           run_with_procs, write_csv)

PROCS = (1, 2, 4, 8, 16)


def _time_of(out: str) -> float:
    return float(re.search(r"time=([\d.e+-]+)s", out).group(1))


def run(quick: bool = False, n: int = 2048, ranks_device="cuda"):
    n = 1024 if quick else n
    m = 3 * n
    rows = []
    base = {}
    for engine in ("dijkstra_sharded", "bellman_sharded"):
        for procs in PROCS if not quick else PROCS[:4]:
            out = run_with_procs(
                ["--engine", engine, "--nodes", str(n), "--edges", str(m),
                 "--repeats", "2"], procs, ranks_device)
            t = _time_of(out)
            if procs == 1:
                base[engine] = t
            eff = base[engine] / (t * procs) * 100
            rows.append([engine, procs, f"{t:.6f}", f"{eff:.2f}"])
            print(f"{engine:18s} procs={procs:3d} time={t:.6f}s "
                  f"efficiency={eff:6.2f}% "
                  f"[{ranks_label(procs, ranks_device)}]", flush=True)
    return write_csv("table4_scaling.csv",
                     ["engine", "procs", "time_s", "efficiency_pct"], rows,
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
