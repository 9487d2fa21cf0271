"""Runs one cell once: set-up from the seed, the measured window, the check
of what the window produced against the plain reference, and the result.

The window drives the program's own entry point, ``shortest_paths(cg,
root, engine="auto")``.  A window runs for ``seconds`` and then lets the
solve it started finish: a rate is taken over all of that work and all of
that time.
"""
from __future__ import annotations

import dataclasses
import gc
import sys
import time
from typing import Optional

import numpy as np
import torch

from sssp_bench import loader, reference, workload
from sssp_bench.inputs import EdgeList, incoming_csr
from sssp_bench.trace import DeviceTrace

#: the kernels whose launches the program counts (``<kernel>.launches``)
LAUNCH_COUNTERS = (
    ("repro_torch.kernels.frontier_relax.kernel", "frontier_relax"),
    ("repro_torch.kernels.bucket_relax.kernel", "bucket_relax"),
    ("repro_torch.kernels.csr_relax.kernel", "ell_relax"))


def say(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Window:
    """What one window produced, for the metric readers (``ctx``)."""
    kind: str
    setup_s: float
    window_s: float = 0.0
    attempted: int = 0
    failed: int = 0
    # one dict a solve (root, wall_s, engine, converged, launches)
    solves: list = dataclasses.field(default_factory=list)
    peak_window_bytes: Optional[int] = None
    trace: Optional[DeviceTrace] = None
    spans: list = dataclasses.field(default_factory=list)
    cost_records: list = dataclasses.field(default_factory=list)
    launches: dict = dataclasses.field(default_factory=dict)
    # trace runs: root -> (vertices, arcs) the root reaches, by the
    # reference's components and the graph's degrees
    reach: Optional[object] = None
    peak_bytes_per_s: Optional[float] = None


def _launch_counts() -> dict:
    import importlib

    out = {}
    for mod, fn in LAUNCH_COUNTERS:
        out[fn] = int(getattr(importlib.import_module(mod), fn).launches)
    return out


def _bitwise_diff(a: np.ndarray, b: np.ndarray) -> int:
    a = np.ascontiguousarray(a, np.float32)
    b = np.ascontiguousarray(b, np.float32)
    return int(np.count_nonzero(a.view(np.uint32) != b.view(np.uint32)))


def _to(edges: EdgeList, device) -> EdgeList:
    return EdgeList(edges.n, edges.u.to(device), edges.v.to(device),
                    edges.w.to(device), edges.labels)


# -- the window ------------------------------------------------

def solve_window(cg, roots, seconds, device, win: Window) -> list:
    """Back-to-back ``shortest_paths(cg, root, engine="auto")`` from
    ``roots`` in order (cycled) until ``seconds`` have passed; the solve
    under way then finishes.  Returns each solve's distances."""
    from repro_torch.core.api import shortest_paths

    dists = []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    i = 0
    launched = sum(_launch_counts().values())
    while True:
        root = int(roots[i % len(roots)])
        ts = time.perf_counter()
        res = shortest_paths(cg, root, engine="auto", device=device)
        te = time.perf_counter()
        before, launched = launched, sum(_launch_counts().values())
        win.solves.append({"root": root, "wall_s": te - ts,
                           "engine": res.engine,
                           "converged": bool(res.converged),
                           "launches": launched - before})
        dists.append(res.dist)
        i += 1
        if te >= deadline:
            break
    win.window_s = te - t0
    win.attempted = len(win.solves)
    win.failed = sum(not s["converged"] for s in win.solves)
    return dists


# -- the checks -------------------------------------------------------------

def check_solves(edges, roots_solved, dists, mix, seed, judge, win) -> dict:
    """Compares a sample of the window's solves, drawn from the seed with the
    slowest always in it, with the reference, bit for bit."""
    k = int(mix["check_solves"])
    walls = [s["wall_s"] for s in win.solves]
    slowest = int(np.argmax(walls))
    rng = np.random.default_rng([int(seed), 1])
    others = [i for i in range(len(dists)) if i != slowest]
    pick = [slowest] + sorted(rng.choice(others, size=min(k - 1, len(others)),
                                         replace=False).tolist())
    roots = sorted({roots_solved[i] for i in pick})
    t = time.perf_counter()
    ref = dict(zip(roots, reference.distances(edges, roots)))
    say(f"reference: {len(roots)} roots in {time.perf_counter() - t:.3f} s")
    if judge == "control":
        ctl = reference.distances(edges, roots, dtype=torch.bfloat16)
        got = {i: ctl[roots.index(roots_solved[i])] for i in pick}
    else:
        got = {i: dists[i] for i in pick}
    wrong = sum(_bitwise_diff(got[i], ref[roots_solved[i]]) for i in pick)
    return {"wrong_distances": {"value": wrong, "limit": 0},
            "unconverged_solves": {"value": win.failed, "limit": 0},
            "checked_solves": {"value": len(pick), "limit": 1}}


def passed(checks: dict) -> bool:
    """Every compared number within its limit; the ``checked_*`` counts are
    floors (at least ``limit`` answers compared), the rest ceilings."""
    for name, c in checks.items():
        if name.startswith("checked_"):
            if c["value"] < c["limit"]:
                return False
        elif c["value"] > c["limit"]:
            return False
    return True


# -- one run ----------------------------------------------------------------

def _built_kernels() -> set:
    """The kernel libraries in the program's build directory."""
    d = loader.ROOT / "build" / "kernels"
    return {f.name for f in d.glob("*.so")} if d.is_dir() else set()


def run_cell(bench: dict, wl: dict, *, seed: int, seconds: float, trace: bool,
             device: str, t_process: float, config: Optional[dict] = None,
             mix: Optional[dict] = None, judge: str = "program",
             base=loader.HERE) -> dict:
    """One run of cell ``wl``; returns the result line's object.  ``config``
    and ``mix`` default to the files the cell names under ``base``.
    ``judge="control"`` puts the reference in bfloat16 in the program's
    place at the check."""
    from repro_torch.core.api import shortest_paths
    from repro_torch.core.csr import from_arrays

    if config is None:
        config = loader.load_config(wl["config"], base)
    if mix is None:
        mix = loader.load_mix(wl["traffic"], base)
    if mix["kind"] not in workload.KINDS:
        raise ValueError(f"unknown traffic kind {mix['kind']!r}")
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if cuda else "cpu"

    # set-up: the graph from the seed, the program's input, the warm-up
    t = time.perf_counter()
    gen = loader.load_generator(config["generator"], base)
    edges = gen.generate(config["params"], seed, dev)
    indptr, indices, weights = incoming_csr(edges)
    edges = _to(edges, "cpu")        # out of the window's device memory
    deg = np.diff(indptr)            # both orientations: in = out degree
    t1 = time.perf_counter()
    cg = from_arrays(indptr, indices, weights, edges.n)
    t2 = time.perf_counter()
    say(f"graph: n={edges.n} edges={edges.u.numel()} arcs={cg.nnz} "
        f"isolated={int((deg == 0).sum())} max_degree={int(deg.max())}")
    say(f"set-up: imports {t - t_process:.3f} s, graph and CSR from the "
        f"seed {t1 - t:.3f} s, from_arrays {t2 - t1:.3f} s")
    win = Window(kind=mix["kind"], setup_s=0.0)
    roots = workload.solve_roots(mix, config, deg, seed, edges.labels)
    built = _built_kernels()
    for r in roots[:int(mix.get("warmup_solves", 1))]:
        tw = time.perf_counter()
        res = shortest_paths(cg, int(r), engine="auto", device=dev)
        say(f"warm-up solve: root {int(r)} engine {res.engine} sweeps "
            f"{res.sweeps} in {time.perf_counter() - tw:.3f} s (the "
            f"program's host views and, where missing, its kernels' build)")
    built = sorted(_built_kernels() - built)
    say(f"set-up: kernels built in this run: {len(built)} "
        f"({', '.join(built) or 'none: all found in build/kernels'})")
    say(f"set-up: the program's views, staging and warm-up "
        f"{time.perf_counter() - t2:.3f} s")
    if cuda:
        torch.cuda.synchronize(dev)
        peak_setup = torch.cuda.max_memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)

    # the window
    tracer = cost = None
    if trace:
        from repro_torch.obs.profile import CostLog, set_cost_log
        from repro_torch.obs.trace import Tracer, set_tracer

        tracer, cost = Tracer(), CostLog()
        set_tracer(tracer)
        set_cost_log(cost)
        launches0 = _launch_counts()
    win.setup_s = time.perf_counter() - t_process
    dt = DeviceTrace(dev) if trace else None
    if dt is not None:
        dt.__enter__()
    try:
        dists = solve_window(cg, roots, seconds, dev, win)
    finally:
        if dt is not None:
            dt.__exit__(None, None, None)
        if trace:
            from repro_torch.obs.profile import NULL_COST_LOG, set_cost_log
            from repro_torch.obs.trace import NULL_TRACER, set_tracer

            set_tracer(NULL_TRACER)
            set_cost_log(NULL_COST_LOG)
    win.trace = dt
    if trace:
        after = _launch_counts()
        win.launches = {k: after[k] - launches0[k] for k in after}
        win.spans = [(s.name, s.t0, s.t1, s.depth, s.args)
                     for s in tracer.spans]
        win.cost_records = list(cost.records)
    peak_run = None
    if cuda:
        torch.cuda.synchronize(dev)
        win.peak_window_bytes = torch.cuda.max_memory_allocated(dev)
        peak_run = max(peak_setup, win.peak_window_bytes)
    say(f"window: {win.window_s:.3f} s, {win.attempted} attempted, "
        f"{win.failed} failed")
    engines = sorted({s["engine"] for s in win.solves})
    walls = np.array([s["wall_s"] for s in win.solves])
    passes = np.array([s["launches"] for s in win.solves])
    say(f"routed engine(s): {', '.join(engines)}; solve wall s "
        f"min {walls.min():.4f} median {np.median(walls):.4f} max "
        f"{walls.max():.4f}; relax launches a solve min {passes.min()} "
        f"median {np.median(passes):.0f} max {passes.max()}")

    # the program's state goes before the reference runs
    del cg
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    edges = _to(edges, dev)
    roots_solved = [s["root"] for s in win.solves]
    checks = check_solves(edges, roots_solved, dists, mix, seed, judge, win)
    del dists
    if trace:
        from sssp_bench import roofline

        win.peak_bytes_per_s = roofline.peak_bytes_per_s(name)
        lab = reference.components(edges).cpu().numpy()
        comp_v = np.bincount(lab, minlength=edges.n)
        comp_a = np.bincount(lab, weights=deg, minlength=edges.n)
        win.reach = lambda r: (int(comp_v[lab[r]]), int(comp_a[lab[r]]))

    metrics = {}
    for m in loader.cell_metrics(bench, wl, trace):
        val = loader.load_metric(m["name"], base).read(win)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    device_info = {"platform": "gpu" if cuda else "cpu", "kind": name,
                   "count": 1,
                   "memory_peak_bytes": int(peak_run) if cuda else 0}
    result = {"correct": passed(checks), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics,
              "device": device_info}
    if trace:
        device_info["busy_s"] = dt.busy_s()
        device_info["window_s"] = dt.window_s
        result["breakdown"] = {
            "device_ops": dt.top_ops(),
            "idle_gaps": dt.idle_gaps([s[:4] for s in win.spans])}
    result["checks"] = checks
    return result
