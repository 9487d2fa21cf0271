"""Calibration harness: sweep the engine matrix on one device, write a
calibration file (port of repro/tune/calibrate.py).

The paper's central finding is that the winning strategy is workload-
dependent — so the crossovers must be *measured on the running device*,
not baked in.  This harness sweeps every engine the device's dispatch can
choose over a small design grid spanning the axes the selector will be
asked about:

- graph family (random sparse / road-grid / skewed-hub — i.e. degree
  skew and frontier width, see tune/features.py),
- size (n, m) and batch width S,
- Δ candidates for the Δ-stepping engine.

On a CUDA device the engines are the kernel twins the CUDA dispatch names
(``frontier_kernel``, ``bellman_csr_kernel``, ``delta_stepping_kernel``)
and ``multisource_csr``; on the CPU JAX's plain set (``frontier``,
``bellman_csr``, ``delta_stepping``, ``multisource_csr``).  Shard arity
is 1: the sharded engines are not ported yet (ROADMAP A.11).

Every solve goes through ``api.shortest_paths`` + ``obs.CostLog`` — the
calibration records ARE ordinary v2 cost records, plus the per-graph
topology features and corpus tag the model fits on.  Per configuration
the harness runs one warm-up call, whose record is discarded (on the card
the first call of a kernel builds it with ``nvcc``), plus ``repeats``
timed calls and keeps the MIN-wall record.

    PYTHONPATH=src python -m repro_torch.tune.calibrate [--smoke]
        [--device cuda|cpu] [--repeats N] [--out CALIBRATION_torch.json]

``--smoke`` shrinks the grid to CI size.  The output is versioned
(``schema``) and stamped with the measuring device's backend (``"gpu"``
or ``"cpu"``), name and power limit, and the torch version; a
``TunedPolicy`` refuses a model from another backend, and tune/replay.py
a cost log from another backend.  The default output is
``CALIBRATION_torch.json`` at the repository root; the JAX package's
``CALIBRATION.json`` is never written.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.benchmarks.common import REPO

CALIBRATION_SCHEMA = 1
DEFAULT_OUT = str(REPO / "CALIBRATION_torch.json")

# (corpus, n, m) grid points; m is None for the generator-shaped corpora
FULL_GRID = (
    ("sparse", 5000, 15000),
    ("sparse", 10000, 30000),
    ("sparse", 10000, 80000),     # m-variation: separates log m from log n
    ("sparse", 20000, 60000),
    ("road", 2500, None),
    ("road", 10000, None),
    ("road", 20000, None),
    ("hub", 2500, None),
    ("hub", 10000, None),
    ("hub", 20000, None),
)
SMOKE_GRID = (
    ("sparse", 256, 768),
    ("sparse", 512, 1536),
    ("sparse", 1024, 3072),
    ("sparse", 1024, 8192),
    ("road", 256, None),
    ("road", 1024, None),
    ("hub", 256, None),
    ("hub", 1024, None),
)

BATCHES_FULL = (4, 16)
BATCHES_SMOKE = (2, 4)


def make_graph(corpus: str, n: int, m: Optional[int]):
    from repro_torch.core import csr as C

    if corpus == "sparse":
        return C.random_csr_graph(n, m, seed=n + m)
    if corpus == "road":
        return C.road_like_csr_graph(n, seed=n)
    if corpus == "hub":
        return C.skewed_hub_csr_graph(n, seed=n)
    raise ValueError(f"unknown corpus {corpus!r}")


def _delta_candidates(cg, smoke: bool) -> List[float]:
    """Δ widths to race for one graph: the profile's auto width always;
    full runs bracket it so the model can find a measured-better one."""
    from repro_torch.core.delta_stepping import auto_delta

    d0 = float(auto_delta(cg))
    if smoke:
        return [d0]
    return [d0, d0 / 8.0, d0 * 2.0]


def _measure(fn, cost_log, repeats: int, extra: Dict[str, Any]):
    """warm-up + repeats through the api shim; returns the min-wall cost
    record (as a dict) annotated with ``extra``."""
    fn()                      # warm-up (kernel build); its record is discarded
    start = len(cost_log.records)
    for _ in range(repeats):
        fn()
    recs = cost_log.records[start:]
    best = min(recs, key=lambda r: r.wall_ms)
    row = best.to_dict()
    row.update(extra)
    return row


def sweep(grid, *, repeats: int = 3, devices: int = 1,
          smoke: bool = False, batches=None, verbose: bool = True,
          device="cuda") -> List[Dict[str, Any]]:
    """Run the calibration sweep over ``grid`` on ``device``; returns
    record dicts."""
    from repro_torch.core.api import refuse_sharded, resolve_device
    from repro_torch.core.api import shortest_paths as _solve
    from repro_torch.core.delta_stepping import delta_profile
    from repro_torch.obs import CostLog, set_cost_log
    from repro_torch.serve.dispatch import engine_for
    from repro_torch.tune.features import graph_features

    refuse_sharded(devices, "calibration")
    dev = resolve_device(device)

    def shortest_paths(g, source, *, engine, **kw):
        return _solve(g, source, engine=engine_for(engine, dev), device=dev,
                      **kw)

    batches = batches if batches is not None else (
        BATCHES_SMOKE if smoke else BATCHES_FULL)
    log = CostLog()
    prev = set_cost_log(log)
    records: List[Dict[str, Any]] = []
    try:
        for corpus, n, m in grid:
            cg = make_graph(corpus, n, m)
            feats = graph_features(cg)
            extra = {"corpus": corpus, "hops": feats["hops"],
                     "skew": round(feats["skew"], 4),
                     "width": round(feats["width"], 2),
                     "repeats": repeats}
            srcs = np.linspace(0, cg.n - 1, max(batches)).astype(np.int32)

            def tag(row):
                records.append(row)
                if verbose:
                    print(f"  {corpus} n={cg.n:6d} {row['engine']:24s} "
                          f"B={row['batch']:<3d} P={row['nprocs']} "
                          f"delta={row['delta']:<12.4g} "
                          f"{row['wall_ms']:9.2f}ms", flush=True)

            for engine in ("frontier", "bellman_csr"):
                tag(_measure(lambda e=engine: shortest_paths(cg, 0, engine=e),
                             log, repeats, extra))
            if delta_profile(cg)["routable"]:
                for j, dv in enumerate(_delta_candidates(cg, smoke)):
                    # the first candidate is the profile's auto width;
                    # model.best_delta only overrides it when an alt
                    # wins by a real margin (noise-robust statics)
                    kind = "auto" if j == 0 else "alt"
                    tag(_measure(
                        lambda d=dv: shortest_paths(
                            cg, 0, engine="delta_stepping", delta=d),
                        log, repeats, dict(extra, delta_kind=kind)))
            for b in batches:
                tag(_measure(
                    lambda b=b: shortest_paths(
                        cg, srcs[:b], engine="multisource_csr"),
                    log, repeats, extra))
    finally:
        set_cost_log(prev)
    return records


def run(smoke: bool = False, repeats: int = 3, devices: int = 1,
        out: str = DEFAULT_OUT, verbose: bool = True,
        device="cuda") -> str:
    from repro_torch.benchmarks.common import device_meta
    from repro_torch.core.api import resolve_device
    from repro_torch.obs import backend_info

    dev = resolve_device(device)
    grid = SMOKE_GRID if smoke else FULL_GRID
    t0 = time.time()
    records = sweep(grid, repeats=repeats, devices=devices, smoke=smoke,
                    verbose=verbose, device=dev)
    backend, device_kind = backend_info(dev)
    doc = {
        "schema": CALIBRATION_SCHEMA,
        "meta": {
            "created_unix": int(time.time()),
            "backend": backend,
            "device_kind": device_kind,
            **device_meta(dev),
            "devices": devices,
            "smoke": smoke,
            "repeats": repeats,
            "grid_points": len(grid),
            "sweep_seconds": round(time.time() - t0, 1),
        },
        "records": records,
    }
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    if verbose:
        print(f"\nwrote {len(records)} calibration records to {out} "
              f"({doc['meta']['sweep_seconds']}s)")
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.tune.calibrate")
    ap.add_argument("--smoke", action="store_true", help="CI-sized grid")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--devices", type=int, default=1,
                    help="shard arity; only 1 runs (the sharded engines "
                         "are not ported yet)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' calibrates the plain engines")
    ap.add_argument("--out", default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    return run(args.smoke, repeats=args.repeats, devices=args.devices,
               out=args.out, device=args.device)


if __name__ == "__main__":
    main()
