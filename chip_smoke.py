#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc`` and then:

1. holds each kernel against its plain PyTorch version, bitwise, at the
   shapes the main path gives it, and times the kernel, the plain version
   and (where one exists) the PyTorch library call computing the same
   function, with CUDA events (medians);
2. drives the main path — ``repro_torch.core.api.shortest_paths`` on the
   device — over every single-device CSR engine on sparse-4M
   (``sparse_csr_graph``), road-4M (``road_like_csr_graph``, a 2000 × 2000
   grid) and hub-1M (``skewed_hub_csr_graph``), plus ``multisource_csr``
   with 8 sources and a ``target=`` query, with the kernels' launch counts
   set to 0 just before and read just after;
3. checks the answers: distances bitwise equal across engines, predecessors
   equal across single-source engines, each kernel engine's counters equal
   to its plain twin's, every kernel launched, distances within the float32
   rounding bound of ``scipy.sparse.csgraph.dijkstra`` (float64), and
   ``serial`` (the paper's Alg. 1) bitwise equal to ``bellman_csr`` on a
   2048-vertex graph.

It prints the card, one JSON line per engine run, one ``{"kernels": ...}``
line, and last ``{"ok": true, "device": ...}``.  Any failed check exits
non-zero before that line; so does a machine without a CUDA GPU.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

#: H100 SXM data sheet: HBM3 bandwidth (bytes/s) and float32 rate outside
#: the tensor cores (operations/s), at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

SPARSE_N = 4_000_000
ROAD_N = 4_000_000
HUB_N = 1_000_000
SERIAL_N = 2048
SOURCES = 8
KERNEL_REPS = 20
PLAIN_REPS = 5

KERNELS = {
    # name: (repository source, the TPU kernel it replaces)
    "ell_relax": ("src/repro_torch/csrc/ell_relax.cu",
                  "src/repro/kernels/csr_relax/kernel.py:48"),
    "frontier_relax": ("src/repro_torch/csrc/frontier_relax.cu",
                       "src/repro/kernels/frontier_relax/kernel.py:46"),
    "bucket_relax": ("src/repro_torch/csrc/bucket_relax.cu",
                     "src/repro/kernels/bucket_relax/kernel.py:68"),
}
SINGLE_ENGINES = ("bellman_csr", "bellman_csr_kernel", "frontier",
                  "frontier_kernel", "delta_stepping", "delta_stepping_kernel")
TWINS = {"bellman_csr_kernel": "bellman_csr", "frontier_kernel": "frontier",
         "delta_stepping_kernel": "delta_stepping"}


class CheckFailed(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise CheckFailed(what)


def time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events, after one
    warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    """Least time for the work on an H100: the larger of bytes over the HBM
    rate and float32 operations over the f32 rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bitwise(a, b) -> bool:
    import torch

    return torch.equal(a.contiguous().view(torch.int32),
                       b.contiguous().view(torch.int32))


def max_abs_err(a, b) -> float:
    """Largest |a - b| where both are finite; inf if the INF patterns
    differ."""
    import torch

    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb):
        return float("inf")
    if not bool(fa.any()):
        return 0.0
    return float((a[fa] - b[fb]).abs().max())


def mixed_dist(n: int, rng, device):
    """A distance vector of finite labels with ~30% INF, from a seed."""
    import numpy as np
    import torch

    d = rng.uniform(0.0, 2000.0, n).astype(np.float32)
    d[rng.random(n) < 0.3] = np.inf
    return torch.tensor(d, device=device)


def kernel_phase(graphs: dict, device, rng) -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import numpy as np
    import torch

    from repro_torch.core.delta_stepping import auto_delta
    from repro_torch.kernels.bucket_relax.kernel import bucket_relax
    from repro_torch.kernels.bucket_relax.ref import bucket_relax_ref
    from repro_torch.kernels.csr_relax.kernel import ell_relax
    from repro_torch.kernels.csr_relax.ref import ell_relax_ref
    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

    out = {}
    sparse = graphs["sparse"]
    n = sparse.n
    dist = mixed_dist(n, rng, device)

    # ell_relax on the sparse graph's incoming ELL.
    idx_np, w_np = sparse.ell()
    idx, w = torch.tensor(idx_np, device=device), torch.tensor(w_np,
                                                               device=device)
    K = idx.shape[1]
    got, ref = ell_relax(dist, idx, w), ell_relax_ref(dist, idx, w)
    check(bitwise(got, ref), "ell_relax differs from ell_relax_ref")
    src = torch.tensor(sparse.indices, device=device).long()
    dst = torch.tensor(sparse.dst_ids(), device=device).long()
    cw = torch.tensor(sparse.weights, device=device)
    lib = dist.scatter_reduce(0, dst, dist[src] + cw, "amin")
    check(bitwise(lib, ref), "scatter_reduce yardstick differs")
    b, by = bound_ms(n * K * 8 + n * 8, 2 * n * K)
    out["ell_relax"] = dict(
        shape=f"sparse-4M n={n} K={K}", bitwise_equal_plain=True,
        max_abs_err=max_abs_err(got, ref),
        ms=time_ms(lambda: ell_relax(dist, idx, w), KERNEL_REPS),
        plain_ms=time_ms(lambda: ell_relax_ref(dist, idx, w), PLAIN_REPS),
        library_ms=time_ms(
            lambda: dist.scatter_reduce(0, dst, dist[src] + cw, "amin"),
            PLAIN_REPS),
        bound_ms=b, bound_by=by)
    del idx, w

    # frontier_relax on a 10% frontier of the same graph, with sentinels.
    ip_np, od_np, ow_np = sparse.out_csr()
    ip = torch.tensor(np.concatenate([ip_np, ip_np[-1:]]).astype(np.int32),
                      device=device)
    od, ow = torch.tensor(od_np, device=device), torch.tensor(ow_np,
                                                              device=device)
    on = torch.tensor(rng.random(n) < 0.1, device=device)
    fids = torch.cat([torch.nonzero(on).flatten(),
                      torch.full((7,), n, device=device)])
    got = frontier_relax(dist, fids, ip, od, ow)
    ref = frontier_relax_ref(dist, fids, ip, od, ow)
    check(bitwise(got, ref), "frontier_relax differs from frontier_relax_ref")
    arc_src = torch.repeat_interleave(
        torch.arange(n, device=device), (ip[1:n + 1] - ip[:n]).long())
    sel = on[arc_src]
    fsrc, fdst, fw = arc_src[sel], od[sel].long(), ow[sel]
    E, F = int(sel.sum()), fids.numel()
    lib = dist.scatter_reduce(0, fdst, dist[fsrc] + fw, "amin")
    check(bitwise(lib, ref), "scatter_reduce yardstick differs")
    b, by = bound_ms(2 * n * 4 + F * 20 + E * 8, 2 * E)
    out["frontier_relax"] = dict(
        shape=f"sparse-4M F={F} E={E}", bitwise_equal_plain=True,
        max_abs_err=max_abs_err(got, ref),
        ms=time_ms(lambda: frontier_relax(dist, fids, ip, od, ow),
                   KERNEL_REPS),
        plain_ms=time_ms(lambda: frontier_relax_ref(dist, fids, ip, od, ow),
                         PLAIN_REPS),
        library_ms=time_ms(
            lambda: dist.scatter_reduce(0, fdst, dist[fsrc] + fw, "amin"),
            PLAIN_REPS),
        bound_ms=b, bound_by=by)
    del ip, od, ow, arc_src, fsrc, fdst, fw

    # bucket_relax on the hub graph's light in-ELL at its auto-Δ.
    hub = graphs["hub"]
    nh = hub.n
    delta = auto_delta(hub)
    lidx_np, lw_np = hub.light_in_ell(delta)
    lidx = torch.tensor(lidx_np, device=device)
    lw = torch.tensor(lw_np, device=device)
    Kl = lidx.shape[1]
    hdist = mixed_dist(nh, rng, device)
    mid = torch.median(hdist[torch.isfinite(hdist)])
    err = 0.0
    for hi in (torch.tensor(0.0, device=device), mid,
               torch.tensor(float("inf"), device=device)):
        (gn, gg), (rn, rg) = (bucket_relax(hdist, lidx, lw, hi),
                              bucket_relax_ref(hdist, lidx, lw, hi))
        check(bitwise(gn, rn) and bool(gg) == bool(rg),
              f"bucket_relax differs from bucket_relax_ref at hi={float(hi)}")
        err = max(err, max_abs_err(gn, rn))
    b, by = bound_ms(nh * Kl * 8 + nh * 8 + 8, 2 * nh * Kl + 2 * nh)
    out["bucket_relax"] = dict(
        shape=f"hub-1M n={nh} K_light={Kl} delta={delta}",
        bitwise_equal_plain=True, max_abs_err=err,
        ms=time_ms(lambda: bucket_relax(hdist, lidx, lw, mid), KERNEL_REPS),
        plain_ms=time_ms(lambda: bucket_relax_ref(hdist, lidx, lw, mid),
                         PLAIN_REPS),
        library_ms=None, bound_ms=b, bound_by=by)
    return out


def oracle(cg, sources):
    from repro_torch.launch.sssp_run import scipy_distances

    return scipy_distances(cg, sources)


def check_oracle(name: str, dist, ref) -> float:
    """Distances against scipy's float64 Dijkstra: the same INF pattern,
    and relative error within the float32 rounding bound; returns the
    largest relative error seen."""
    import numpy as np

    from repro_torch.launch.sssp_run import VERIFY_RTOL

    got = np.atleast_2d(dist).astype(np.float64)
    check(np.array_equal(np.isinf(got), np.isinf(ref)),
          f"{name}: unreachable set differs from scipy")
    fin = np.isfinite(ref) & (ref > 0)
    rel = float(np.max(np.abs(got[fin] - ref[fin]) / ref[fin])) if fin.any() \
        else 0.0
    check(rel <= VERIFY_RTOL, f"{name}: relative error {rel} > {VERIFY_RTOL}")
    return rel


def run_engine(cg, source, engine, device, **kw):
    import torch

    from repro_torch.core.api import shortest_paths

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = shortest_paths(cg, source, engine=engine, device=device, **kw)
    return res, time.perf_counter() - t0


def stage_views(cg, device) -> dict:
    """Build the graph's host views (memoized on it, so the engine walls
    below exclude them) and time their staging on the device: the share of
    each engine wall that is copying, not solving."""
    import torch

    from repro_torch.core.bellman_csr import csr_operands
    from repro_torch.core.delta_stepping import auto_delta, delta_operands
    from repro_torch.core.frontier import frontier_operands

    delta = auto_delta(cg)
    t0 = time.perf_counter()
    cg.ell(), cg.out_csr(), cg.light_in_ell(delta), cg.heavy_out_csr(delta)
    out = {"host_views_s": time.perf_counter() - t0}
    for key, stage in (
            ("stage_csr_ell_s", lambda: csr_operands(cg, device=device,
                                                     with_ell=True)),
            ("stage_frontier_s", lambda: frontier_operands(cg,
                                                           device=device)),
            ("stage_delta_s", lambda: delta_operands(cg, delta,
                                                     device=device))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stage()
        torch.cuda.synchronize()
        out[key] = time.perf_counter() - t0
    return out


def device_busy_s(fn) -> float:
    """Device time of everything ``fn()`` ran on the GPU (kernels and
    copies), summed from a torch.profiler trace."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e6


def profile_phase(graphs: dict, walls: dict, device) -> list:
    """Each kernel engine once more under the profiler: its device busy
    time against its unprofiled wall from the main-path run (the plain
    twins are left out: their thousands of small ops make the trace cost
    minutes)."""
    lines = []
    for name, cg in graphs.items():
        for eng in TWINS:
            busy = device_busy_s(lambda: run_engine(cg, 0, eng, device))
            wall = walls[name, eng]
            lines.append(dict(profile=eng, graph=name, wall_s=wall,
                              device_busy_s=busy,
                              device_idle_share=max(0.0, 1.0 - busy / wall)
                              if busy > 0 else "not measured"))
    return lines


def engine_phase(graphs: dict, device, walls: dict) -> list:
    """The main path: every slice engine through shortest_paths.  Records
    each single-source wall in ``walls``."""
    import numpy as np

    lines = []

    def record(graph, res, wall, **extra):
        lines.append(dict(engine=res.engine, graph=graph, n=graphs[graph].n,
                          nnz=graphs[graph].nnz, wall_s=wall,
                          sweeps=res.sweeps, edges_relaxed=res.edges_relaxed,
                          converged=res.converged, **extra))

    for name, cg in graphs.items():
        lines.append(dict(graph=name, **stage_views(cg, device)))
        res = {}
        for eng in SINGLE_ENGINES:
            res[eng], wall = run_engine(cg, 0, eng, device)
            walls[name, eng] = wall
            record(name, res[eng], wall)
            check(res[eng].converged, f"{name} {eng}: not converged")
        base = res["bellman_csr"]
        for eng, r in res.items():
            check(r.dist.tobytes() == base.dist.tobytes(),
                  f"{name} {eng}: dist differs from bellman_csr")
            check(np.array_equal(r.pred, base.pred),
                  f"{name} {eng}: pred differs from bellman_csr")
        for k, plain in TWINS.items():
            a, b = res[k], res[plain]
            check((a.sweeps, a.edges_relaxed, a.converged)
                  == (b.sweeps, b.edges_relaxed, b.converged),
                  f"{name} {k}: counters differ from {plain}")
        if name != "sparse":
            rel = check_oracle(name, base.dist, oracle(cg, [0]))
            lines.append(dict(oracle="scipy.sparse.csgraph.dijkstra",
                              graph=name, max_rel_err=rel))
            continue

        # sparse-4M: the batched engine and a point-to-point query.
        sources = np.arange(SOURCES) * (cg.n // SOURCES)
        ms, wall = run_engine(cg, sources, "multisource_csr", device)
        check(ms.converged, "multisource_csr: not converged")
        check(ms.dist[0].tobytes() == base.dist.tobytes(),
              "multisource_csr row 0 differs from bellman_csr")
        rel = check_oracle("multisource_csr", ms.dist, oracle(cg, sources))
        record(name, ms, wall, sources=SOURCES, oracle_max_rel_err=rel)
        # a target at the median label, so the early exit cuts the solve
        order = np.argsort(np.where(np.isfinite(base.dist), base.dist,
                                    np.inf), kind="stable")
        target = int(order[int(np.isfinite(base.dist).sum()) // 2])
        tk, wall = run_engine(cg, 0, "frontier_kernel", device, target=target)
        tp, _ = run_engine(cg, 0, "frontier", device, target=target)
        check(tk.dist[target] == base.dist[target] and tk.pred is None,
              "target query: dist[target] differs from the full solve")
        check(tk.dist.tobytes() == tp.dist.tobytes()
              and (tk.sweeps, tk.edges_relaxed, tk.converged)
              == (tp.sweeps, tp.edges_relaxed, tp.converged),
              "target query: frontier_kernel differs from frontier")
        record(name, tk, wall, target=target)
    return lines


def serial_check(device) -> dict:
    """The paper's Alg. 1 on the device against bellman_csr, bitwise."""
    from repro_torch.core.csr import sparse_csr_graph

    cg = sparse_csr_graph(SERIAL_N, seed=1)
    s, wall = run_engine(cg, 0, "serial", device)
    b, _ = run_engine(cg, 0, "bellman_csr", device)
    check(s.dist.tobytes() == b.dist.tobytes(), "serial dist != bellman_csr")
    check((s.pred == b.pred).all(), "serial pred != bellman_csr")
    return dict(engine="serial", graph=f"sparse-{SERIAL_N}", n=cg.n,
                nnz=cg.nnz, wall_s=wall, bitwise_equal_bellman_csr=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from repro_torch.core import csr as C
    from repro_torch.core.delta_stepping import delta_profile
    from repro_torch.kernels import common
    from repro_torch.kernels.bucket_relax.kernel import bucket_relax
    from repro_torch.kernels.csr_relax.kernel import ell_relax
    from repro_torch.kernels.frontier_relax.kernel import frontier_relax

    wrappers = {"ell_relax": ell_relax, "frontier_relax": frontier_relax,
                "bucket_relax": bucket_relax}
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    common.build(KERNELS)
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(KERNELS)}, nvcc {' '.join(common.NVCC_FLAGS)})")

    t0 = time.perf_counter()
    graphs = {"sparse": C.sparse_csr_graph(SPARSE_N),
              "road": C.road_like_csr_graph(ROAD_N),
              "hub": C.skewed_hub_csr_graph(HUB_N)}
    for name, cg in graphs.items():
        prof = delta_profile(cg)
        print(f"graph {name}: n={cg.n} nnz={cg.nnz} auto_delta="
              f"{prof['delta']} K_light={prof['light_max_deg']}")
    print(f"graph generation: {time.perf_counter() - t0:.1f} s")

    try:
        rng = np.random.default_rng(0)
        kern = kernel_phase(graphs, device, rng)
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        walls = {}
        lines = engine_phase(graphs, device, walls)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        for k, cnt in launches.items():
            check(cnt > 0, f"kernel {k} was not launched on the main path")
        lines.append(serial_check(device))
        lines += profile_phase(graphs, walls, device)
    except CheckFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    for line in lines:
        print(json.dumps(line))
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0],
             replaces=KERNELS[k][1], launches=launches[k], **kern[k])
        for k in KERNELS]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
