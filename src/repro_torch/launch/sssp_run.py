"""Driver: run one of the port's SSSP engines on a generated graph.

    PYTHONPATH=src python -m repro_torch.launch.sssp_run \
        --engine frontier_kernel --nodes 1000000
    PYTHONPATH=src python -m repro_torch.launch.sssp_run --device cuda \
        --corpus road --nodes 4000000 --engine delta_stepping_kernel --verify
    PYTHONPATH=src python -m repro_torch.launch.sssp_run --device cuda \
        --engine bellman_kernel --nodes 40000 --edges 120000 --verify
    PYTHONPATH=src python -m repro_torch.launch.sssp_run --device cpu \
        --engine frontier_sharded --procs 4 --nodes 2000 --verify

Graphs are CSR (``--corpus random|road|hub``), except that ``serial`` and
the dense engines take the random corpus as a dense ``Graph`` (the
adjacency matrix of ``random_graph``, O(n²) memory; they densify the other
corpora).  The sharded engines (and ``multisource`` with ``--procs`` > 1)
run on ``--procs`` ranks spawned through core/_dist.spawn: gloo on
``--device cpu``, NCCL on ``cuda`` with one GPU a rank; rank 0 reports.
Timing covers staging to the device, the solve and the copy of the
result back; graph generation is excluded.  ``--verify`` holds the
distances against
``scipy.sparse.csgraph.dijkstra`` in float64 (the float32 path sums differ
from it by rounding only, hence the relative tolerance).
"""
from __future__ import annotations

import argparse
import time

import numpy as np

#: float32 vs float64 path sums: each of <= 4096 additions on a path rounds
#: by at most 2**-24 of the running sum.
VERIFY_RTOL = 4096 * 2.0 ** -24
#: seconds the spawned group may take, its solves included (and one
#: collective at most): Alg. 2 on 16 gloo ranks sharing 8 cores takes
#: minutes at the paper's n = 2048
GROUP_TIMEOUT = 900.0


def scipy_distances(cg, sources) -> np.ndarray:
    """float64 distances from ``sources`` by scipy's Dijkstra on the same
    arcs (the incoming CSR is the transpose of scipy's row = source form)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra

    a = csr_matrix((cg.weights.astype(np.float64), cg.indices, cg.indptr),
                   shape=(cg.n, cg.n)).T.tocsr()
    return dijkstra(a, directed=True, indices=sources)


def solve_timed(g, source, engine, device, repeats: int, group=None,
                **kw):
    """``repeats`` solves of ``g``; returns the walls (s) and the last
    result.  On a spawned rank ``group`` is its ShardGroup."""
    import torch

    from repro_torch.core.api import shortest_paths

    times, res = [], None
    for _ in range(repeats):
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = shortest_paths(g, source, engine=engine, device=device,
                             group=group, **kw)
        times.append(time.perf_counter() - t0)
    return times, res


def _rank_solve(group, g, source, engine, repeats, kw):
    return solve_timed(g, source, engine, group.device, repeats, group, **kw)


def main(argv=None, *, fork_cpu_ranks: bool = False):
    """Parse ``argv`` and run.  ``fork_cpu_ranks`` forks gloo ranks instead
    of spawning them, which skips each rank's import of torch (seconds a
    rank); it is for a process that has run no torch operation yet, as
    this module run as a program has not.  NCCL ranks always spawn."""
    import tempfile

    import torch

    from repro_torch.core import csr as C
    from repro_torch.core import graph as G
    from repro_torch.core._dist import BACKEND_OF, spawn
    from repro_torch.core.api import (DENSE_ENGINES, ENGINES,
                                      SHARDED_ENGINES, resolve_device)

    ap = argparse.ArgumentParser()
    ap.add_argument("--engine", default="frontier", choices=ENGINES)
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--corpus", default="random",
                    choices=["random", "road", "hub"],
                    help="'random': --nodes/--edges (the paper's Table II "
                         "shape at m = 3n); 'road': 4-neighbour grid, "
                         "--nodes rounded down to a square; 'hub': "
                         "heavy-tailed hub fan-outs")
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--edges", type=int, default=None,
                    help="random corpus only (default 3 * nodes)")
    ap.add_argument("--delta", default=None,
                    help="Δ bucket width, a positive float or 'auto' "
                         "(frontier and delta_stepping engines)")
    ap.add_argument("--procs", type=int, default=1,
                    help="ranks for the sharded engines and multisource "
                         "(gloo on the CPU, NCCL with one GPU a rank)")
    ap.add_argument("--source", type=int, default=0)
    ap.add_argument("--sources", type=int, default=8,
                    help="batch size for multisource and multisource_csr")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--directed", action="store_true",
                    help="the paper's -w flag (random corpus)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--verify", action="store_true")
    ap.add_argument("--save", default=None, metavar="PATH",
                    help="write the last solve's dist (and pred, where the "
                         "engine gives one) to PATH as an .npz, so a caller "
                         "can hold the answers of a --procs run, whose ranks "
                         "are other processes, against another solver")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    sharded = args.engine in SHARDED_ENGINES or (
        args.engine == "multisource" and args.procs > 1)
    if args.procs < 1 or (args.procs > 1 and not sharded):
        ap.error(f"--procs {args.procs} needs a sharded engine or "
                 f"multisource")
    dense = (args.corpus == "random" and args.engine in (
        "serial", "dijkstra_sharded", "bellman_sharded") + DENSE_ENGINES)
    m = 3 * args.nodes if args.edges is None else args.edges
    if args.corpus == "road":
        g = C.road_like_csr_graph(args.nodes, seed=args.seed)
    elif args.corpus == "hub":
        g = C.skewed_hub_csr_graph(args.nodes, seed=args.seed)
    elif dense:
        g = G.random_graph(args.nodes, m, seed=args.seed,
                           directed=args.directed)
    else:
        g = C.random_csr_graph(args.nodes, m, seed=args.seed,
                               directed=args.directed)
    cg = g.to_csr() if dense else g
    delta = args.delta
    if delta is not None and delta != "auto":
        delta = float(delta)
    multi = args.engine in ("multisource", "multisource_csr",
                            "multisource_csr_sharded")
    source = np.arange(args.sources) % g.n if multi else args.source
    kw = {} if delta is None else {"delta": delta}

    if sharded:
        with tempfile.TemporaryDirectory() as store:
            times, res = spawn(_rank_solve, args.procs,
                               backend=BACKEND_OF[dev.type], store_dir=store,
                               args=(g, source, args.engine, args.repeats,
                                     kw), timeout=GROUP_TIMEOUT,
                               start_method="fork" if fork_cpu_ranks
                               and dev.type == "cpu" else "spawn")[0]
    else:
        times, res = solve_timed(g, source, args.engine, dev, args.repeats,
                                 **kw)
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"engine={args.engine} corpus={args.corpus} n={g.n} m={cg.nnz} "
          f"device={name} procs={args.procs} time={min(times):.6f}s"
          + (f" sweeps={res.sweeps}" if res.sweeps is not None else "")
          + (f" edges_relaxed={res.edges_relaxed}"
             if res.edges_relaxed is not None else ""))

    if args.save:
        np.savez(args.save, dist=res.dist,
                 **({} if res.pred is None else {"pred": res.pred}))

    if args.verify:
        ref = scipy_distances(cg, np.atleast_1d(source))
        got = np.atleast_2d(res.dist).astype(np.float64)
        ok = (np.array_equal(np.isinf(ref), np.isinf(got))
              and np.allclose(np.where(np.isinf(ref), 0, ref),
                              np.where(np.isinf(got), 0, got),
                              rtol=VERIFY_RTOL, atol=0))
        print("verify:", "OK" if ok else "MISMATCH")
        if not ok:
            raise SystemExit(1)


if __name__ == "__main__":
    main(fork_cpu_ranks=True)
