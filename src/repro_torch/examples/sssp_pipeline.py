"""End-to-end SSSP pipeline reproducing the paper's workflow — the port of
the JAX package's ``examples/sssp_pipeline.py``:

    edge list -> adjacency matrix / CSR -> engine -> verified output,

for every engine, with timings in the paper's §III cost envelope (a warm
call, then one timed call) and each engine's distances checked against a
float64 oracle (``scipy.sparse.csgraph.dijkstra`` on the same arcs).

    PYTHONPATH=src python -m repro_torch.examples.sssp_pipeline \\
        [--nodes N] [--edges M] [--device cuda|cpu] [--procs P]

The sharded engines run on a group of ``--procs`` ranks, each called on
every rank: P spawned processes (gloo on ``--device cpu``, NCCL with one
GPU a rank on ``cuda``, where fewer GPUs than P raise), or at one rank on
``cuda`` an NCCL group of one in this process.  One rank on the CPU skips
them (the JAX package skips them on one device).  The engines that hold
the n × n matrix (``serial``, the dense engines, ``dijkstra_sharded``,
``bellman_sharded``) are skipped above :data:`DENSE_CAP` vertices, as
Table II's bench skips its dense column: at n = 100,000 the matrix is
40 GB, and Alg. 2's n collective rounds take minutes.  Every skip prints
its reason.  Returns a summary dict; a disagreement exits non-zero.
"""
from __future__ import annotations

import argparse
import tempfile
import time

import numpy as np

#: engines whose input is the n × n adjacency matrix
MATRIX_ENGINES = ("serial", "bellman", "bellman_kernel", "multisource",
                  "dijkstra_sharded", "bellman_sharded")
#: largest n for which the n × n matrix is built (Table II's bench skips
#: its dense column above the same cap)
DENSE_CAP = 10000
MULTI_ENGINES = ("multisource", "multisource_csr", "multisource_csr_sharded")


def _solve(g, cg, source, engine, device, group=None):
    """A warm call, then one timed call; returns (seconds, first row)."""
    from repro_torch.core.api import (CSR_ENGINES, DELTA_ENGINES,
                                      SHARDED_CSR_ENGINES, shortest_paths)

    src = np.array([source]) if engine in MULTI_ENGINES else source
    # CSR-native engines get the sparse container directly — no dense
    # matrix on their path at all.  The Δ engines thread delta="auto": the
    # bucket width comes per graph from the weight profile.
    arg_g = (cg if engine in CSR_ENGINES + DELTA_ENGINES + SHARDED_CSR_ENGINES
             + ("multisource_csr",) else g)
    kw = {"delta": "auto"} if engine in DELTA_ENGINES else {}
    if group is not None:
        kw["group"] = group
    shortest_paths(arg_g, src, engine=engine, device=device, **kw)
    t0 = time.perf_counter()
    res = shortest_paths(arg_g, src, engine=engine, device=device, **kw)
    dt = time.perf_counter() - t0
    return dt, (res.dist[0] if res.dist.ndim == 2 else res.dist)


def _rank_engines(group, g, cg, source, engines):
    """Every sharded engine of ``engines`` on this rank of ``group``."""
    return {e: _solve(g, cg, source, e, group.device, group)
            for e in engines}


def _verify(ref, got) -> tuple[bool, float]:
    """The JAX example's check (``allclose`` at rtol 1e-5 with INF as a big
    sentinel) and the largest relative error over finite entries (inf when
    the reachable sets differ)."""
    ok = np.allclose(np.where(np.isfinite(ref), ref, 1e30),
                     np.where(np.isfinite(got), got, 1e30), rtol=1e-5)
    fin = np.isfinite(ref)
    if not np.array_equal(fin, np.isfinite(got)):
        return False, float("inf")
    rel = (np.abs(got[fin] - ref[fin])
           / np.maximum(np.abs(ref[fin]), np.finfo(np.float32).tiny))
    return ok, float(rel.max(initial=0.0))


def main(argv=None) -> dict:
    from repro_torch.core import csr as C
    from repro_torch.core import graph as G
    from repro_torch.core._dist import BACKEND_OF, open_group, spawn
    from repro_torch.core.api import ENGINES, SHARDED_ENGINES, resolve_device
    from repro_torch.launch.sssp_run import scipy_distances

    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=800)
    ap.add_argument("--edges", type=int, default=2400)
    ap.add_argument("--source", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--procs", type=int, default=1,
                    help="ranks of the sharded engines' group")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n, m = args.nodes, args.edges

    # 1. edge list (the paper's input format) -> both containers; the CSR
    # comes from the same RNG stream as the matrix, so both hold one graph
    dense_bytes = n * n * 4
    if n <= DENSE_CAP:
        g = G.random_graph(n, m, seed=0)
        cg = g.to_csr()
        print(f"built adjacency matrix: {n}x{n}, {g.num_edges} edges "
              f"({dense_bytes / 1e6:.2f} MB dense)")
    else:
        g, cg = None, C.random_csr_graph(n, m, seed=0)
        print(f"no adjacency matrix: {n}x{n} float32 is "
              f"{dense_bytes / 1e9:.1f} GB, above the dense cap "
              f"{DENSE_CAP}")
    print(f"built CSR container:    {cg.nnz} arcs "
          f"({cg.nbytes / 1e6:.2f} MB, {dense_bytes / cg.nbytes:.1f}x "
          "smaller — the paper's §V Table II complaint, fixed)")

    # 2. oracle
    ref = scipy_distances(cg, [args.source])[0]

    # 3. every engine; the sharded ones together on one group
    summary = {"n": n, "m": m, "nnz": cg.nnz, "device": str(dev),
               "procs": args.procs, "engines": {}, "skipped": {}}

    def report(engine, dt, got):
        ok, err = _verify(ref, got)
        summary["engines"][engine] = {"time_s": dt, "verify": ok,
                                      "max_rel_err": err}
        print(f"  {engine:23s}: {dt:.5f}s  verify={'OK' if ok else 'FAIL'}"
              f"  max rel err {err:.3g}")
        if not ok:
            raise SystemExit(f"sssp_pipeline: {engine} disagrees with the "
                             f"oracle")

    def skip(engine, why):
        summary["skipped"][engine] = why
        print(f"  {engine:23s}: skipped ({why})")

    sharded = []
    for engine in ENGINES:
        if engine in MATRIX_ENGINES and g is None:
            skip(engine, f"needs the {dense_bytes / 1e9:.1f} GB matrix, "
                         f"n above the dense cap {DENSE_CAP}")
        elif engine in SHARDED_ENGINES:
            sharded.append(engine)
        else:
            report(engine, *_solve(g, cg, args.source, engine, dev))
    if sharded and dev.type == "cpu" and args.procs == 1:
        for engine in sharded:
            skip(engine, "one rank; run with --procs 2 or more for a group "
                         "of gloo ranks")
    elif sharded:
        print(f"  sharded engines on {args.procs} "
              f"{BACKEND_OF[dev.type]} rank(s):")
        with tempfile.TemporaryDirectory() as store:
            if args.procs == 1:
                with open_group(0, 1, backend=BACKEND_OF[dev.type],
                                device=dev, store_dir=store) as group:
                    out = _rank_engines(group, g, cg, args.source, sharded)
            else:
                out = spawn(_rank_engines, args.procs,
                            backend=BACKEND_OF[dev.type], store_dir=store,
                            args=(g, cg, args.source, sharded))[0]
        for engine in sharded:
            report(engine, *out[engine])
    print("all engines agree with the oracle")
    return summary


if __name__ == "__main__":
    main()
