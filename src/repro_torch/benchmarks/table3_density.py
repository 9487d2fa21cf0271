"""Paper Table III: dense vs sparse graphs at equal node counts — the port
of the JAX package's ``benchmarks/table3_density.py``, same graphs, same
CSV.

The paper's claim: with an adjacency matrix, processing time depends on n,
not edge count.  Three implementations are timed on the paper's corpus:
``serial`` (Alg. 1) and ``bellman`` (the CUDA analogue's algorithm) on
``--device``, and ``dijkstra_sharded`` (the MPI analogue, Alg. 2) on 8
ranks of ``--ranks-device`` started by ``sssp_run --procs 8`` in a
subprocess.  The paper ran MPI as CPU processes, so ``--ranks-device cpu``
(8 gloo ranks on the host) is its counterpart on a one-GPU machine; CUDA
ranks take one GPU each, and fewer than 8 GPUs raise.

    PYTHONPATH=src python -m repro_torch.benchmarks.table3_density \\
        [--quick] [--device cuda|cpu] [--ranks-device cuda|cpu]
"""
from __future__ import annotations

import argparse
import re

from repro_torch.benchmarks.common import (device_meta, ranks_label,
                                           run_with_procs, time_engine,
                                           write_csv)
from repro_torch.core import graph as G
from repro_torch.core.api import resolve_device, shortest_paths

PAIRS = [
    (10, 30), (10, 45),
    (100, 300), (100, 4950),
    (1000, 3000), (1000, 499500),
    (2000, 6000), (2000, 1899500),
]
RANKS = 8


def run(quick: bool = False, device="cuda", ranks_device="cuda"):
    dev = resolve_device(device)
    ranks = ranks_label(RANKS, ranks_device)
    pairs = PAIRS[:6] if quick else PAIRS
    rows = []
    for n, m in pairs:
        g = G.random_graph(n, m, seed=n + m)
        t_serial = time_engine(
            lambda: shortest_paths(g, 0, engine="serial", device=dev),
            device=dev)
        t_bell = time_engine(
            lambda: shortest_paths(g, 0, engine="bellman", device=dev),
            device=dev)
        out = run_with_procs(
            ["--engine", "dijkstra_sharded", "--nodes", str(n),
             "--edges", str(m), "--repeats", "2"], RANKS, ranks_device)
        t_mpi = float(re.search(r"time=([\d.e+-]+)s", out).group(1))
        rows.append([n, m, f"{t_serial:.6f}", f"{t_mpi:.6f}",
                     f"{t_bell:.6f}"])
        print(f"n={n:6d} m={m:8d} serial={t_serial:.6f}s "
              f"dijkstra_sharded(8)={t_mpi:.6f}s bellman={t_bell:.6f}s "
              f"[serial, bellman on {dev}; mpi8 on {ranks}]", flush=True)
    path = write_csv("table3_density.csv",
                     ["nodes", "edges", "serial_s", "mpi8_s", "bellman_s"],
                     rows, meta=device_meta(dev) | {"columns": {
                         "serial_s": str(dev), "mpi8_s": ranks,
                         "bellman_s": str(dev)}})
    # density-invariance check (the paper's Table III conclusion)
    by_n = {}
    for n, m, ts, tm, tb in rows:
        by_n.setdefault(n, []).append(float(tb))
    for n, ts in by_n.items():
        if len(ts) == 2 and min(ts) > 0:
            ratio = max(ts) / min(ts)
            print(f"  density ratio n={n}: sparse/dense bellman "
                  f"time ratio {ratio:.2f} (paper: ~1)")
    return path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of serial and bellman")
    ap.add_argument("--ranks-device", default="cuda",
                    help="device of the 8 dijkstra_sharded ranks: 'cuda' "
                         "(NCCL, one GPU a rank) or 'cpu' (gloo ranks on "
                         "the host, as the paper's MPI ran)")
    args = ap.parse_args(argv)
    return run(args.quick, device=args.device,
               ranks_device=args.ranks_device)


if __name__ == "__main__":
    main()
