"""Paper Table II revisited: dense adjacency vs sparse CSR on the sparse
corpus (m = 3n) — the port of the JAX package's
``benchmarks/table2_sparse_csr.py``, same corpus, same CSV.

The paper's §V diagnosis: the dense matrix costs O(n²) memory and the dense
sweep O(n²) work per relaxation regardless of density — its 40,000-vertex
Table II point needs a 6.4 GB float32 matrix for 120k edges.  For each
corpus size this reports

  * memory: dense n²·4 bytes vs the CSR container's O(n + m) bytes,
  * time:   ``bellman`` (dense O(n²) sweep) vs ``bellman_csr`` (O(m)
            scatter-min sweep) on ``--device``, same fixpoint, same answers.

Above ``--dense-cap`` (default 10000) the dense engine is skipped — the
regime the dense formulation cannot reach — while the CSR engine keeps
going through the full corpus.  An 80 GB card holds the 40,000 point:
``--dense-cap 40000`` measures it.

    PYTHONPATH=src python -m repro_torch.benchmarks.table2_sparse_csr \\
        [--quick] [--dense-cap N] [--device cuda|cpu]
"""
from __future__ import annotations

import argparse

from repro_torch.benchmarks.common import device_meta, time_engine, write_csv
from repro_torch.core import csr as C
from repro_torch.core import graph as G
from repro_torch.core.api import resolve_device, shortest_paths


def run(quick: bool = False, dense_cap: int = 10000, device="cuda"):
    dev = resolve_device(device)
    pairs = [p for p in G.PAPER_SPARSE if p[0] <= (2000 if quick else 40000)]
    rows = []
    for n, m in pairs:
        cg = C.random_csr_graph(n, m, seed=n + m)
        dense_bytes = n * n * 4
        csr_bytes = cg.nbytes
        t_csr = time_engine(
            lambda: shortest_paths(cg, 0, engine="bellman_csr", device=dev),
            device=dev)
        if n <= dense_cap:
            g = cg.to_dense()
            t_dense = time_engine(
                lambda: shortest_paths(g, 0, engine="bellman", device=dev),
                device=dev)
            dense_s = f"{t_dense:.6f}"
        else:
            dense_s = "skipped"     # the paper's ceiling, made explicit
        rows.append([n, m, dense_bytes, csr_bytes,
                     f"{dense_bytes / csr_bytes:.1f}", dense_s,
                     f"{t_csr:.6f}"])
        print(f"n={n:6d} m={m:8d} dense={dense_bytes / 1e6:9.1f}MB "
              f"csr={csr_bytes / 1e6:7.2f}MB (x{dense_bytes / csr_bytes:6.1f}) "
              f"bellman={dense_s:>9s}s bellman_csr={t_csr:.6f}s "
              f"[{dev}]", flush=True)
    return write_csv(
        "table2_sparse_csr.csv",
        ["nodes", "edges", "dense_bytes", "csr_bytes", "mem_ratio",
         "bellman_s", "bellman_csr_s"],
        rows,
        meta=device_meta(dev) | {"dense_cap": dense_cap, "columns": {
            "bellman_s": str(dev), "bellman_csr_s": str(dev)}})


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--dense-cap", type=int, default=10000)
    ap.add_argument("--device", default="cuda",
                    help="torch device of both engines; 'cpu' runs the "
                         "plain PyTorch path")
    args = ap.parse_args(argv)
    return run(args.quick, dense_cap=args.dense_cap, device=args.device)


if __name__ == "__main__":
    main()
