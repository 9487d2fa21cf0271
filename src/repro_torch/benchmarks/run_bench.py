"""Tracked SSSP benchmark of the port (port of benchmarks/run_bench.py).

Times the port's engines on the paper's Table I (dense) and Table II
(sparse) corpora and on the road-like and hub corpora of the Δ engines,
and writes one record, ``BENCH_torch_sssp.json`` (never the JAX
package's ``BENCH_sssp.json``):

    PYTHONPATH=src python -m repro_torch.benchmarks.run_bench \
        [--smoke | --full] [--device cuda|cpu] [--out PATH] [--repeats N] \
        [--cost-out PATH]

Every CSR-family record carries the engine's ``edges_relaxed``; every
``*_kernel`` record the launches of its CUDA kernel in that solve
(``<wrapper>.launches``: 0 on the CPU, where the wrappers run their plain
versions, and a hard exit when it is 0 on the GPU).  Per corpus point all
engines' distances must agree bitwise with the first engine run (min-plus
over float32 path sums is exact); a disagreement is a hard exit.

Gates (the JAX bench's, with the same rules and the same smoke honesty):

* ``gate``: frontier relaxes strictly fewer edges than ``bellman_csr`` on
  every sparse point with n >= 10000 (smoke runs: on every sparse point
  they have, and the rule says so);
* ``gate_delta``: ``delta_stepping`` takes strictly fewer bucket phases
  than frontier sweeps AND less wall-clock on every road/hub point with
  n >= 10000 (smoke runs gate the phase count only).

``--smoke`` caps the corpora (n <= 1000); ``--full`` extends the sparse
corpus to the paper's 40,000 vertices.  The per-engine caps are JAX's for
``serial``, ``bellman`` and the dense corpus.  JAX's cap of 1000 on the
kernel engines exists because Pallas runs in interpret mode on a CPU: on
the GPU it is lifted, on the CPU it stays.

``--cost-out PATH`` writes one cost record per engine call (the facade's
observability shim, repro_torch/obs), each stamped with the device, and
exits non-zero if they are not schema-valid.

Not ported yet, as ``meta["not_ported"]`` records: the sharded leg
(``--devices``, ``gate_sharded``) comes with the sharded slice.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from repro_torch.benchmarks.common import (REPO, capture_costs, device_meta,
                                           time_engine)
from repro_torch.core import csr as C
from repro_torch.core import graph as G
from repro_torch.core.api import resolve_device, shortest_paths

DEFAULT_OUT = str(REPO / "BENCH_torch_sssp.json")

# per-engine n ceilings: the O(n²)-total serial loop and the dense matrix
# as in the JAX bench; the kernel engines' caps apply on the CPU only
# (kernel_caps below lifts them on the GPU)
ENGINE_CAPS = {
    "serial": 2000,
    "bellman": 2000,              # dense matrix: the paper's own ceiling
    "bellman_kernel": 1000,
    "bellman_csr": None,
    "bellman_csr_kernel": 1000,
    "frontier": None,
    "frontier_kernel": 1000,
    "delta_stepping": None,
    "delta_stepping_kernel": 1000,
    "multisource_csr": None,
}
#: each kernel engine's CUDA kernel, by wrapper name
KERNEL_OF = {
    "bellman_kernel": "relax_matvec",
    "bellman_csr_kernel": "ell_relax",
    "frontier_kernel": "frontier_relax",
    "delta_stepping_kernel": "bucket_relax",
}

DENSE_ENGINES = ("serial", "bellman", "bellman_kernel",
                 "bellman_csr", "frontier")
SPARSE_ENGINES = ("serial", "bellman", "bellman_csr", "bellman_csr_kernel",
                  "frontier", "frontier_kernel", "multisource_csr")
# Δ leg: the engines raced on the road/hub corpora (gate_delta compares
# the first two)
DELTA_ENGINES = ("frontier", "delta_stepping", "delta_stepping_kernel")
DELTA_NS = (10000, 20000)         # gate-sized points (>= gate_delta min_n)
DELTA_NS_SMOKE = (1000,)

N_SOURCES = 4                     # batch width for multisource_csr

NOT_PORTED = {
    "gate_sharded": "the sharded engines come with the sharded slice",
    "--devices": "the sharded engines come with the sharded slice",
}


def engine_caps(smoke: bool, device) -> dict:
    """The n ceiling of each engine (None: no cap): ENGINE_CAPS with the
    kernel engines' caps lifted on the GPU, then every cap at most 1000
    (100 for the capped engines) in a smoke run, as in the JAX bench."""
    caps = dict(ENGINE_CAPS)
    if device.type == "cuda":
        caps.update({k: None for k in KERNEL_OF})
    if smoke:
        caps = {k: 1000 if v is None else 100 for k, v in caps.items()}
    return caps


def kernel_wrappers() -> dict:
    """The kernel wrappers by name (their ``launches`` counts)."""
    from repro_torch.kernels.bucket_relax.kernel import bucket_relax
    from repro_torch.kernels.csr_relax.kernel import ell_relax
    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.sssp_relax.kernel import relax_matvec

    return {"relax_matvec": relax_matvec, "ell_relax": ell_relax,
            "frontier_relax": frontier_relax, "bucket_relax": bucket_relax}


def _solve(arg, src, engine, device, record: dict):
    """One verified solve; for a kernel engine, record its kernel's launches
    in this solve and exit if none reached the GPU."""
    kernel = KERNEL_OF.get(engine)
    wrapper = kernel_wrappers()[kernel] if kernel else None
    before = wrapper.launches if wrapper else 0
    res = shortest_paths(arg, src, engine=engine, device=device)
    if wrapper is not None:
        launches = wrapper.launches - before
        record.update(kernel=kernel, kernel_launches=launches)
        if device.type == "cuda" and launches == 0:
            raise SystemExit(f"{engine}: kernel {kernel} never launched on "
                             f"{device}")
    return res


def _bench_point(corpus: str, n: int, m: int, engines, caps, repeats,
                 device) -> list:
    """Run every applicable engine on one corpus point; returns records."""
    cg = C.random_csr_graph(n, m, seed=n + m)
    g = cg.to_dense() if n <= 2000 else None      # dense engines' input
    srcs = np.linspace(0, n - 1, N_SOURCES).astype(np.int32)
    records, anchor = [], None
    for engine in engines:
        cap = caps.get(engine)
        if cap is not None and n > cap:
            continue
        needs_dense = engine in ("serial", "bellman", "bellman_kernel")
        if needs_dense and g is None:
            continue
        arg = g if needs_dense else cg
        src = srcs if engine == "multisource_csr" else 0
        rec = {"corpus": corpus, "n": n, "m": m, "nnz": cg.nnz,
               "engine": engine}
        res = _solve(arg, src, engine, device, rec)      # warm + verify
        t = time_engine(
            lambda: shortest_paths(arg, src, engine=engine, device=device),
            repeats=repeats, device=device)
        d0 = res.dist[0] if res.dist.ndim == 2 else res.dist
        if anchor is None:
            anchor = d0
        rec.update(time_s=t, sweeps=res.sweeps,
                   edges_relaxed=res.edges_relaxed,
                   sources=N_SOURCES if engine == "multisource_csr" else 1,
                   agrees_bitwise=d0.tobytes() == anchor.tobytes())
        records.append(rec)
        print(f"  {corpus} n={n:6d} {engine:22s} "
              f"{t / rec['sources']:9.5f}s/src sweeps={res.sweeps} "
              f"edges={res.edges_relaxed}", flush=True)
    return records


def _bench_delta_point(corpus: str, n: int, caps, repeats, device) -> list:
    """One road/hub corpus point raced across DELTA_ENGINES; ``sweeps`` of
    the Δ engines counts outer bucket phases, the number gate_delta sets
    against the frontier sweep count."""
    make = (C.road_like_csr_graph if corpus == "road"
            else C.skewed_hub_csr_graph)
    cg = make(n, seed=n)
    records, anchor = [], None
    for engine in DELTA_ENGINES:
        cap = caps.get(engine)
        if cap is not None and cg.n > cap:
            continue
        rec = {"corpus": corpus, "n": cg.n, "m": cg.nnz, "nnz": cg.nnz,
               "engine": engine}
        res = _solve(cg, 0, engine, device, rec)
        t = time_engine(
            lambda: shortest_paths(cg, 0, engine=engine, device=device),
            repeats=repeats, device=device)
        if anchor is None:
            anchor = res.dist
        rec.update(time_s=t, sweeps=res.sweeps,
                   edges_relaxed=res.edges_relaxed, sources=1,
                   agrees_bitwise=res.dist.tobytes() == anchor.tobytes())
        records.append(rec)
        print(f"  {corpus} n={cg.n:6d} {engine:22s} {t:9.5f}s/src "
              f"sweeps={res.sweeps} edges={res.edges_relaxed}", flush=True)
    return records


def _gate(results, min_n: int = 10000) -> dict:
    """Frontier must relax strictly fewer edges than bellman_csr per solve
    on every sparse point with n >= min_n (smoke runs gate whatever sparse
    points they have, so the check never silently vanishes)."""
    by_point = {}
    for r in results:
        if r["corpus"] == "sparse" and r["engine"] in ("bellman_csr",
                                                       "frontier"):
            by_point.setdefault(r["n"], {})[r["engine"]] = r
    pts, have_target = [], False
    for n in sorted(by_point):
        pair = by_point[n]
        if "bellman_csr" not in pair or "frontier" not in pair:
            continue
        fe = pair["frontier"]["edges_relaxed"]
        be = pair["bellman_csr"]["edges_relaxed"]
        counted = n >= min_n
        have_target = have_target or counted
        pts.append({
            "n": n, "m": pair["frontier"]["m"],
            "frontier_edges": fe, "bellman_csr_edges": be,
            "edge_ratio": fe / be if be else None,
            "frontier_fewer": fe < be,
            "counted": counted,
        })
    counted = [p for p in pts if (p["counted"] if have_target else True)]
    if have_target:
        rule = (f"frontier relaxes strictly fewer edges than bellman_csr "
                f"on every sparse point with n >= {min_n}")
    else:
        rule = (f"frontier relaxes strictly fewer edges than bellman_csr "
                f"on every available sparse point (none with n >= {min_n} "
                f"in this run)")
    return {
        "rule": rule,
        "points": pts,
        "pass": bool(counted) and all(p["frontier_fewer"] for p in counted),
    }


def _gate_delta(results, min_n: int = 10000):
    """Δ-stepping must beat the frontier engine where it claims to: on every
    road/hub point with n >= min_n, strictly fewer bucket phases than
    frontier sweeps AND strictly less wall-clock.  Runs without such a
    point (smoke) gate the phase count only, and the rule says so."""
    by_point = {}
    for r in results:
        if r["corpus"] in ("road", "hub") and r["engine"] in (
                "frontier", "delta_stepping"):
            by_point.setdefault((r["corpus"], r["n"]), {})[r["engine"]] = r
    pts, have_target = [], False
    for key in sorted(by_point):
        pair = by_point[key]
        if "frontier" not in pair or "delta_stepping" not in pair:
            continue
        f, d = pair["frontier"], pair["delta_stepping"]
        counted = key[1] >= min_n
        have_target = have_target or counted
        pts.append({
            "corpus": key[0], "n": key[1], "m": f["m"],
            "delta_phases": d["sweeps"], "frontier_sweeps": f["sweeps"],
            "delta_time_s": d["time_s"], "frontier_time_s": f["time_s"],
            "fewer_sweeps": d["sweeps"] < f["sweeps"],
            "faster": d["time_s"] < f["time_s"],
            "counted": counted,
        })
    if not pts:
        return None
    if have_target:
        counted_pts = [p for p in pts if p["counted"]]
        ok = all(p["fewer_sweeps"] and p["faster"] for p in counted_pts)
        rule = (f"delta_stepping takes strictly fewer bucket phases than "
                f"frontier sweeps AND less wall-clock on every road/hub "
                f"point with n >= {min_n}")
    else:
        ok = all(p["fewer_sweeps"] for p in pts)
        rule = (f"delta_stepping takes strictly fewer bucket phases than "
                f"frontier sweeps on every available road/hub point "
                f"(none with n >= {min_n} in this run; wall-clock not "
                f"gated at smoke sizes)")
    return {"rule": rule, "points": pts, "pass": ok}


def run(smoke: bool = False, full: bool = False, repeats: int = 3,
        out: str = DEFAULT_OUT, device="cuda", cost_out=None) -> str:
    """Run the bench on ``device``, write ``out`` (and with ``cost_out`` the
    cost records), then exit non-zero on a bitwise disagreement, a failing
    gate or invalid cost records (after writing)."""
    dev = resolve_device(device)
    with capture_costs(cost_out):
        doc = _measure(smoke, full, repeats, dev)
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"\nwrote {len(doc['results'])} records to {out}")
    bad = [(r["corpus"], r["n"], r["engine"]) for r in doc["results"]
           if not r["agrees_bitwise"]]
    if bad:
        raise SystemExit(f"bitwise disagreement in {bad}")
    from repro_torch.benchmarks.gates import enforce
    enforce(doc)
    return out


def _measure(smoke: bool, full: bool, repeats: int, dev) -> dict:
    caps = engine_caps(smoke, dev)
    dense_cap = 100 if smoke else 2000
    sparse_cap = 1000 if smoke else (40000 if full else 20000)
    results = []
    for n, m in G.PAPER_DENSE:
        if n <= dense_cap:
            results += _bench_point("dense", n, m, DENSE_ENGINES, caps,
                                    repeats, dev)
    for n, m in G.PAPER_SPARSE:
        if n <= sparse_cap:
            results += _bench_point("sparse", n, m, SPARSE_ENGINES, caps,
                                    repeats, dev)
    for corpus in ("road", "hub"):
        for n in (DELTA_NS_SMOKE if smoke else DELTA_NS):
            results += _bench_delta_point(corpus, n, caps, repeats, dev)
    return {
        "schema": 1,
        "meta": {
            "created_unix": int(time.time()),
            **device_meta(dev),
            "smoke": smoke, "full": full, "repeats": repeats,
            "caps": caps,
            "not_ported": NOT_PORTED,
        },
        "results": results,
        "gate": _gate(results),
        "gate_delta": _gate_delta(results),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.run_bench")
    ap.add_argument("--smoke", action="store_true",
                    help="corpora capped at n = 1000")
    ap.add_argument("--full", action="store_true",
                    help="extend the sparse corpus to the paper's n = 40000")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the plain PyTorch path")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--cost-out", default=None, metavar="PATH",
                    help="write one cost record per engine call (JSONL)")
    args = ap.parse_args(argv)
    run(args.smoke, args.full, repeats=args.repeats, out=args.out,
        device=args.device, cost_out=args.cost_out)


if __name__ == "__main__":
    main()
