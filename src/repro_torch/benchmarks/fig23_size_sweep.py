"""Paper Figs. 2/3: execution time vs graph size for ``serial`` (Alg. 1)
and ``bellman`` (Alg. 3/4), plus the beyond-paper multisource batching
amortization (per-source time drops as the adjacency traffic is shared
across sources) — the port of the JAX package's
``benchmarks/fig23_size_sweep.py``, same graphs, same two CSVs.

    PYTHONPATH=src python -m repro_torch.benchmarks.fig23_size_sweep \\
        [--quick] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.benchmarks.common import device_meta, time_engine, write_csv
from repro_torch.core import graph as G
from repro_torch.core.api import resolve_device, shortest_paths

SIZES = (10, 100, 500, 1000, 2000, 4000)


def run(quick: bool = False, device="cuda"):
    dev = resolve_device(device)
    meta = device_meta(dev)
    sizes = SIZES[:4] if quick else SIZES
    rows = []
    for n in sizes:
        g = G.sparse_graph(n, seed=n)
        t_serial = time_engine(
            lambda: shortest_paths(g, 0, engine="serial", device=dev),
            device=dev)
        t_bell = time_engine(
            lambda: shortest_paths(g, 0, engine="bellman", device=dev),
            device=dev)
        rows.append([n, 3 * n, f"{t_serial:.6f}", f"{t_bell:.6f}"])
        print(f"n={n:6d} serial={t_serial:.6f}s bellman={t_bell:.6f}s "
              f"speedup={t_serial / max(t_bell, 1e-12):.2f}x [{dev}]",
              flush=True)
    p1 = write_csv("fig23_size_sweep.csv",
                   ["nodes", "edges", "serial_s", "bellman_s"], rows,
                   meta=meta | {"columns": {"serial_s": str(dev),
                                            "bellman_s": str(dev)}})

    # multisource amortization (beyond-paper)
    n = sizes[-1]
    g = G.sparse_graph(n, seed=1)
    rows2 = []
    for s in (1, 4, 16, 64):
        srcs = np.arange(s) % n
        t = time_engine(
            lambda: shortest_paths(g, srcs, engine="multisource", device=dev),
            device=dev)
        rows2.append([n, s, f"{t:.6f}", f"{t / s:.6f}"])
        print(f"multisource n={n} S={s:3d}: total={t:.5f}s "
              f"per-source={t / s:.5f}s [{dev}]", flush=True)
    write_csv("multisource_amortization.csv",
              ["nodes", "sources", "total_s", "per_source_s"], rows2,
              meta=meta | {"columns": {"total_s": str(dev)}})
    return p1


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the engines; 'cpu' runs the "
                         "plain PyTorch path")
    args = ap.parse_args(argv)
    return run(args.quick, device=args.device)


if __name__ == "__main__":
    main()
