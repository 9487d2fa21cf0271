#!/usr/bin/env python3
"""Smoke test of the PyTorch / H100 port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/csrc``, measures
the card's float32 add and min issue rates (``tools/min_plus_rate.py``;
the kernels' operation bounds use them) and then:

1. holds each kernel against its plain PyTorch version, bitwise, at the
   shapes the main path gives it, and times the kernel, the plain version
   and (where one exists) the PyTorch library call computing the same
   function, with CUDA events (medians).  The two CSR pull kernels
   (``ell_relax``, ``bucket_relax``) each run at sparse-4M, hub-1M (full
   and light incoming CSR) and road-4M, are also held against the ELL
   plain versions on the padded ELL of the same arcs; the in-place
   ``frontier_relax`` runs on a random sparse-4M frontier and on the real
   frontiers of the road-4M and hub-1M solves halfway, its fallen-label
   mask held too;
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
   2048-vertex graph;
4. the dynamic-graph path on sparse-4M (:func:`dynamic_phase`): a
   ``DynamicGraph`` staged on the card, ``solve_dynamic`` held against the
   ``frontier`` engine, and for mutation batches of 1 and 8 edges 2 + 12
   rounds of churn, each repaired (``repair_sssp``, chained) and re-solved
   in full, bitwise equal every round, the last round also held against
   the snapshot's ``frontier`` solve and scipy; one line a batch size with
   the median walls, work counters and cone;
5. the dense adjacency-matrix path, the paper's own, at the shapes of its
   Tables I and II: paper-sparse-40000 (``sparse_graph(40000)``, a 6.4 GB
   matrix) and dense-2000 (``dense_graph(2000)``).  The three min-plus
   kernels are held against their plain versions and timed at
   paper-sparse-40000; in the main-path window ``serial``, ``bellman``,
   ``bellman_kernel`` and ``bellman_csr`` run on both graphs (distances
   bitwise equal, predecessors equal across the three fixpoint engines,
   ``serial``'s tree valid, sweeps equal, the scipy oracle), ``multisource``
   with 8 sources, the batched fixpoint through the ``relax_matmul``
   kernel, and one frontier-masked sweep; the serial / ``bellman_kernel``
   wall ratio is the paper's headline comparison on this card.

It prints the card, the measured rates, one JSON line per CSR-kernel
shape, per engine run, per dynamic batch size and per graph's (and the
target query's and the dynamic phase's) kernel launches, one
``{"kernels": ...}`` line, and last ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before that line; so does a machine
without a CUDA GPU.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
sys.path.insert(0, str(Path(__file__).resolve().parent / "tools"))

#: H100 SXM data sheet: HBM3 bandwidth (bytes/s) at the full 700 W power
#: limit.
HBM_BYTES_PER_S = 3.35e12
#: the card's float32 issue rates, measured at the start of every run by
#: tools/min_plus_rate.py (its ``rates``): every kernel here does one add
#: and one min (``acc = fminf(acc, d + w)``) an element, so its operations
#: are bounded by those pairs over ``add_min_pairs_per_s``.
RATES: dict = {}

SPARSE_N = 4_000_000
ROAD_N = 4_000_000
HUB_N = 1_000_000
SERIAL_N = 2048
DENSE_SPARSE_N = 40_000      # the paper's Table II, largest graph
DENSE_DENSE_N = 2000         # the paper's Table I, largest graph
SOURCES = 8
KERNEL_REPS = 20
PLAIN_REPS = 5
#: device clock cycles of the spin before each timed call (about 1 ms on an
#: H100 80GB HBM3 at 700 W, whose SM clock peaks at 1.98 GHz), longer than
#: the host takes to queue one wrapper call
SPIN_CYCLES = 2_000_000

KERNELS = {
    # name: (repository source, the TPU kernel it replaces)
    "ell_relax": ("src/repro_torch/csrc/ell_relax.cu",
                  "src/repro/kernels/csr_relax/kernel.py:48"),
    "frontier_relax": ("src/repro_torch/csrc/frontier_relax.cu",
                       "src/repro/kernels/frontier_relax/kernel.py:46"),
    "bucket_relax": ("src/repro_torch/csrc/bucket_relax.cu",
                     "src/repro/kernels/bucket_relax/kernel.py:68"),
    "relax_matvec": ("src/repro_torch/csrc/relax_matvec.cu",
                     "src/repro/kernels/sssp_relax/kernel.py:55"),
    "relax_matmul": ("src/repro_torch/csrc/relax_matmul.cu",
                     "src/repro/kernels/sssp_relax/kernel.py:106"),
    "relax_matvec_frontier": ("src/repro_torch/csrc/relax_matvec_frontier.cu",
                              "src/repro/kernels/sssp_relax/kernel.py:151"),
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


def time_ms(fn, reps: int, reset=None) -> float:
    """Median device time of ``fn()`` in ms, by CUDA events, after one
    warm-up call.  ``reset()``, where given, runs before every call outside
    the events: it restores what an in-place ``fn`` wrote, so every call
    does the first call's work.  A spin of SPIN_CYCLES on the device comes
    before the start event, so the host has queued ``fn``'s launches by the
    time it fires: the events time the device, not the wrapper's host
    work."""
    import torch

    if reset is not None:
        reset()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        torch.cuda._sleep(SPIN_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_ms(nbytes: float, pairs: float) -> tuple[float, str]:
    """Least time for the work on an H100: the larger of bytes over the HBM
    rate and float32 add + min pairs over the card's measured pair rate
    (``RATES``)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = pairs / RATES["add_min_pairs_per_s"] * 1e3
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


def pull_phase(graphs: dict, device, rng) -> tuple[dict, list]:
    """The two CSR pull kernels, ``ell_relax`` and ``bucket_relax``, each
    at the main path's shapes: sparse-4M's incoming CSR, hub-1M's full one
    (16 rows of ~520 arcs) and its light one at its auto-Δ, and road-4M's
    (it carries most launches of both kernels on the main path).  At
    sparse-4M and road-4M the auto-Δ makes every arc light, so the full
    and the light CSR are the same.  Each kernel is held bitwise against
    its plain CSR version and its ELL plain version on the padded ELL of
    the same arcs (the TPU kernel's operand; ``bucket_relax`` at three
    ``hi``, flag included), then timed with its plain version and the
    ``scatter_reduce`` yardstick over the flat arcs.  ``bound_ms``
    counts the CSR's bytes, ``ell_bound_ms`` the padded ELL's.  Returns the
    kernels line's entries (sparse-4M for ``ell_relax``, hub-1M light for
    ``bucket_relax``, as in earlier runs) and one line a kernel and shape."""
    import torch

    from repro_torch.core.delta_stepping import auto_delta
    from repro_torch.kernels.bucket_relax.kernel import bucket_relax
    from repro_torch.kernels.bucket_relax.ref import (bucket_relax_csr_ref,
                                                      bucket_relax_ref)
    from repro_torch.kernels.common import lane_group
    from repro_torch.kernels.csr_relax.kernel import ell_relax
    from repro_torch.kernels.csr_relax.ref import (ell_relax_csr_ref,
                                                   ell_relax_ref, row_ids)

    sparse, road, hub = graphs["sparse"], graphs["road"], graphs["hub"]
    dh = auto_delta(hub)
    shapes = (
        ("sparse-4M in-CSR", sparse,
         (sparse.indptr, sparse.indices, sparse.weights), sparse.ell),
        ("hub-1M in-CSR", hub, (hub.indptr, hub.indices, hub.weights),
         hub.ell),
        (f"hub-1M light in-CSR delta={dh}", hub, hub.light_in_csr(dh),
         lambda: hub.light_in_ell(dh)),
        ("road-4M in-CSR", road, (road.indptr, road.indices, road.weights),
         road.ell),
    )
    main, lines = {}, []
    for shape, cg, (ip_np, src_np, w_np), ell in shapes:
        n, m = cg.n, int(src_np.shape[0])
        dist = mixed_dist(n, rng, device)
        csr = (torch.tensor(ip_np, device=device).int(),
               torch.tensor(src_np, device=device),
               torch.tensor(w_np, device=device))
        idx_np, ew_np = ell()
        K = int(idx_np.shape[1])
        idx, ew = (torch.tensor(idx_np, device=device),
                   torch.tensor(ew_np, device=device))
        plain_new = ell_relax_csr_ref(dist, *csr)
        mid = torch.median(dist[torch.isfinite(dist)])

        got = ell_relax(dist, *csr)
        check(bitwise(got, plain_new),
              f"ell_relax differs from ell_relax_csr_ref at {shape}")
        check(bitwise(got, ell_relax_ref(dist, idx, ew)),
              f"ell_relax differs from ell_relax_ref at {shape}")
        err = {"ell_relax": max_abs_err(got, plain_new), "bucket_relax": 0.0}
        for hi in (torch.tensor(0.0, device=device), mid,
                   torch.tensor(float("inf"), device=device)):
            gn, gg = bucket_relax(dist, *csr, hi)
            for rn, rg in (bucket_relax_csr_ref(dist, *csr, hi),
                           bucket_relax_ref(dist, idx, ew, hi)):
                check(bitwise(gn, rn) and bool(gg) == bool(rg),
                      f"bucket_relax differs from its plain versions at "
                      f"{shape} hi={float(hi)}")
            err["bucket_relax"] = max(err["bucket_relax"],
                                      max_abs_err(gn, plain_new))
        del idx, ew, idx_np, ew_np
        # the yardstick: one scatter-min over the flat arcs (the in-bucket
        # flag is not part of it)
        ip, src, w = csr[0], csr[1].long(), csr[2]
        dst = row_ids(ip, m)
        lib = dist.scatter_reduce(0, dst, dist[src] + w, "amin")
        check(bitwise(lib, plain_new),
              f"scatter_reduce yardstick differs at {shape}")
        lib_ms = time_ms(
            lambda: dist.scatter_reduce(0, dst, dist[src] + w, "amin"),
            PLAIN_REPS)
        runs = {"ell_relax": (lambda: ell_relax(dist, *csr),
                              lambda: ell_relax_csr_ref(dist, *csr), 0),
                "bucket_relax": (lambda: bucket_relax(dist, *csr, mid),
                                 lambda: bucket_relax_csr_ref(dist, *csr,
                                                              mid),
                                 8)}           # hi and the flag
        for name, (fn, plain, extra) in runs.items():
            b, by = bound_ms(m * 8 + (n + 1) * 4 + n * 8 + extra, m + n)
            ell_b, _ = bound_ms(n * K * 8 + n * 8 + extra, n * K + n)
            line = dict(
                shape=f"{shape} n={n} arcs={m} K={K}",
                bitwise_equal_plain=True, bitwise_equal_ell_ref=True,
                max_abs_err=err[name], ms=time_ms(fn, KERNEL_REPS),
                plain_ms=time_ms(plain, PLAIN_REPS), library_ms=lib_ms,
                bound_ms=b, bound_by=by, ell_bound_ms=ell_b,
                group=lane_group(n, m),
                max_degree=int((ip[1:] - ip[:-1]).max()))
            lines.append(dict(pull_kernel=name, **line))
            if (name, shape) in (("ell_relax", "sparse-4M in-CSR"),
                                 ("bucket_relax", shapes[2][0])):
                main[name] = {k: line[k] for k in (
                    "shape", "bitwise_equal_plain", "max_abs_err", "ms",
                    "plain_ms", "library_ms", "bound_ms", "bound_by",
                    "ell_bound_ms")}
        del dist, csr, src, dst, w, lib, plain_new
    return main, lines


def mid_run_frontier(cg, device) -> tuple:
    """The state of the ``frontier_kernel`` solve of ``cg`` from vertex 0
    halfway: a first solve counts its sweeps, a second stops at half of
    them and keeps the labels and the compacted frontier its next sweep
    is given.  Returns (operands, dist, fids, that sweep's index, sweeps)."""
    from repro_torch.core.frontier import frontier_operands, sssp_frontier
    from repro_torch.kernels.frontier_relax.ops import make_frontier_sweep_fn

    ops = frontier_operands(cg, device=device)
    push = make_frontier_sweep_fn()
    total = sssp_frontier(ops, 0, n=cg.n, sweep_fn=push)[2]
    half, seen = total // 2, []

    def sweep(dist, fids, *rest):
        if len(seen) == half:
            seen.append((dist.clone(), fids.clone()))
        else:
            seen.append(None)
        push(dist, fids, *rest)

    sssp_frontier(ops, 0, n=cg.n, sweep_fn=sweep, max_sweeps=half + 1)
    dist, fids = seen[half]
    return ops, dist, fids, half, total


def frontier_shapes(graphs: dict, device, rng) -> list:
    """frontier_relax's inputs at the main path's shapes, as (name,
    frontier operands, dist, fids): a 10% random frontier of sparse-4M
    with seven compaction sentinels (the shape of earlier runs), and the
    real frontiers of the road-4M and hub-1M solves halfway
    (:func:`mid_run_frontier`; road-4M's 4120 sweeps carry most
    launches)."""
    import torch

    from repro_torch.core.frontier import frontier_operands

    sparse = graphs["sparse"]
    n = sparse.n
    on = torch.tensor(rng.random(n) < 0.1, device=device)
    shapes = [("sparse-4M 10% frontier", frontier_operands(sparse,
                                                           device=device),
               mixed_dist(n, rng, device),
               torch.cat([torch.nonzero(on).flatten(),
                          torch.full((7,), n, device=device)]))]
    for name in ("road", "hub"):
        ops, dist, fids, k, total = mid_run_frontier(graphs[name], device)
        shapes.append((f"{name}-{graphs[name].n // 1_000_000}M frontier at "
                       f"sweep {k} of {total}", ops, dist, fids))
    return shapes


def frontier_phase(graphs: dict, device, rng) -> tuple[dict, list]:
    """``frontier_relax`` at the main path's shapes
    (:func:`frontier_shapes`).  Each is held bitwise against the plain
    version, labels and fallen-label mask, and the mask against ``new <
    snapshot``; then timed with its plain
    version and the ``scatter_reduce_`` yardstick over the frontier's arcs,
    each call on the same input: the kernel and the plain version work in
    place, so dist and the mask are restored before every call, outside the
    events, and the yardstick writes into a tensor allocated once, restored
    the same way.  The yardstick computes no fallen-label mask.  The bound
    counts what the call must move: 20 bytes a frontier row (id, label,
    window bounds), 8 an arc, 4 for each distinct target's label read and 5
    for each label that fell (label and flag written).  Returns the kernels
    line's entry (sparse-4M) and one line a shape."""
    import torch

    from repro_torch.kernels.common import lane_group
    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

    main, lines = None, []
    for shape, ops, dist, fids in frontier_shapes(graphs, device, rng):
        n = dist.shape[0]
        args = (fids, ops["out_indptr"], ops["out_dst"], ops["out_w"])
        got, fell = dist.clone(), torch.zeros(n, dtype=torch.bool,
                                              device=device)
        frontier_relax(got, *args, fell)
        ref, ref_fell = dist.clone(), torch.zeros_like(fell)
        frontier_relax_ref(ref, *args, ref_fell)
        check(bitwise(got, ref) and torch.equal(fell, ref_fell),
              f"frontier_relax differs from frontier_relax_ref at {shape}")
        check(torch.equal(fell, got < dist),
              f"frontier_relax's mask is not new < snapshot at {shape}")
        # the frontier's arcs, for the yardstick and the bound
        ip = ops["out_indptr"].long()
        rows = fids[fids < n]
        starts, degs = ip[rows], ip[rows + 1] - ip[rows]
        E = int(degs.sum())
        first = torch.repeat_interleave(starts - (torch.cumsum(degs, 0)
                                                  - degs), degs,
                                        output_size=E)
        pos = first + torch.arange(E, device=device)
        fsrc = torch.repeat_interleave(rows, degs, output_size=E)
        fdst, fw = ops["out_dst"][pos].long(), ops["out_w"][pos]
        lib = dist.clone()
        lib.scatter_reduce_(0, fdst, dist[fsrc] + fw, "amin")
        check(bitwise(lib, ref), f"scatter_reduce_ yardstick differs at "
                                 f"{shape}")
        F, T = fids.numel(), int(torch.unique(fdst).numel())
        W = int(fell.sum())
        b, by = bound_ms(F * 20 + E * 8 + T * 4 + W * 5, E)

        def reset():
            got.copy_(dist)
            fell.zero_()

        def lib_reset():
            lib.copy_(dist)

        line = dict(
            shape=f"{shape} n={n} F={F} E={E} targets={T} fell={W}",
            bitwise_equal_plain=True, max_abs_err=max_abs_err(got, ref),
            ms=time_ms(lambda: frontier_relax(got, *args, fell), KERNEL_REPS,
                       reset),
            plain_ms=time_ms(lambda: frontier_relax_ref(got, *args, fell),
                             PLAIN_REPS, reset),
            library_ms=time_ms(lambda: lib.scatter_reduce_(
                0, fdst, dist[fsrc] + fw, "amin"), PLAIN_REPS, lib_reset),
            bound_ms=b, bound_by=by)
        lines.append(dict(frontier_kernel="frontier_relax",
                          group=lane_group(n, ops["out_dst"].numel()),
                          max_out_degree=int((ip[1:n + 1] - ip[:n]).max()),
                          **line))
        main = main or line
        del got, fell, ref, ref_fell, lib, fsrc, fdst, fw, pos, first
    return main, lines


def kernel_phase(graphs: dict, device, rng) -> tuple[dict, list]:
    """Each CSR-path kernel against its plain version at the main path's
    shapes: the two pull kernels (:func:`pull_phase`) and frontier_relax
    (:func:`frontier_phase`)."""
    out, lines = pull_phase(graphs, device, rng)
    out["frontier_relax"], more = frontier_phase(graphs, device, rng)
    return out, lines + more


def dense_kernel_phase(g, device, rng) -> dict:
    """The three min-plus kernels against their plain versions on
    paper-sparse-40000's matrix.  The kernels skip rows whose label is INF
    (for relax_matmul: INF for every source of the tile), so each bound
    counts the rows the function needs.  No single PyTorch call computes a
    dense min-plus product, so there is no library time."""
    import torch

    from repro_torch.kernels.sssp_relax.kernel import (relax_matmul,
                                                       relax_matvec,
                                                       relax_matvec_frontier)
    from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                    relax_sweep_multi_ref,
                                                    relax_sweep_ref)

    out = {}
    n = g.n
    adj = torch.tensor(g.adj, device=device)
    dist = mixed_dist(n, rng, device)
    shape = f"paper-sparse-{n} n={n}"

    got, ref = relax_matvec(dist, adj), relax_sweep_ref(dist, adj)
    check(bitwise(got, ref), "relax_matvec differs from relax_sweep_ref")
    rows = int(torch.isfinite(dist).sum())
    b, by = bound_ms(rows * n * 4 + 2 * n * 4, rows * n)
    out["relax_matvec"] = dict(
        shape=f"{shape} finite_rows={rows}", bitwise_equal_plain=True,
        max_abs_err=max_abs_err(got, ref),
        ms=time_ms(lambda: relax_matvec(dist, adj), KERNEL_REPS),
        plain_ms=time_ms(lambda: relax_sweep_ref(dist, adj), PLAIN_REPS),
        library_ms=None, bound_ms=b, bound_by=by)

    on = torch.tensor(rng.random(n) < 0.5, device=device)
    got = relax_matvec_frontier(dist, on, adj)
    ref = relax_sweep_frontier_ref(dist, on, adj)
    check(bitwise(got, ref),
          "relax_matvec_frontier differs from relax_sweep_frontier_ref")
    masked = torch.where(on, dist, torch.inf)
    check(bitwise(got, torch.minimum(dist, relax_matvec(masked, adj))),
          "relax_matvec_frontier differs from the masked relax_matvec")
    rows = int((on & torch.isfinite(dist)).sum())
    b, by = bound_ms(rows * n * 4 + 2 * n * 4 + n, rows * n)
    out["relax_matvec_frontier"] = dict(
        shape=f"{shape} frontier={int(on.sum())} rows_read={rows}",
        bitwise_equal_plain=True, max_abs_err=max_abs_err(got, ref),
        ms=time_ms(lambda: relax_matvec_frontier(dist, on, adj), KERNEL_REPS),
        plain_ms=time_ms(lambda: relax_sweep_frontier_ref(dist, on, adj),
                         PLAIN_REPS),
        library_ms=None, bound_ms=b, bound_by=by)

    D = torch.stack([mixed_dist(n, rng, device) for _ in range(SOURCES)])
    got, ref = relax_matmul(D, adj), relax_sweep_multi_ref(D, adj)
    check(bitwise(got, ref), "relax_matmul differs from relax_sweep_multi_ref")
    rows = int(torch.isfinite(D).any(dim=0).sum())
    b, by = bound_ms(rows * n * 4 + 2 * SOURCES * n * 4,
                     SOURCES * rows * n)
    out["relax_matmul"] = dict(
        shape=f"{shape} S={SOURCES} rows_read={rows}",
        bitwise_equal_plain=True, max_abs_err=max_abs_err(got, ref),
        ms=time_ms(lambda: relax_matmul(D, adj), KERNEL_REPS),
        plain_ms=time_ms(lambda: relax_sweep_multi_ref(D, adj), PLAIN_REPS),
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


def timed(fn):
    """``fn()`` and its host-clock wall, the device idle at the start (the
    port's entry points return numpy, so the device work has ended)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    return out, time.perf_counter() - t0


def run_engine(cg, source, engine, device, **kw):
    from repro_torch.core.api import shortest_paths

    return timed(lambda: shortest_paths(cg, source, engine=engine,
                                        device=device, **kw))


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
    cg.dst_ids(), cg.out_csr(), cg.light_in_csr(delta), cg.heavy_out_csr(delta)
    out = {"host_views_s": time.perf_counter() - t0}
    for key, stage in (
            ("stage_csr_kernel_s", lambda: csr_operands(cg, device=device,
                                                        with_in_csr=True)),
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


PROFILE_TOP = 8


def profile_call(fn) -> dict:
    """One call of ``fn()`` under torch.profiler: its host-clock wall and
    the device time of everything it ran on the GPU (kernels and copies),
    both from that call, and the ``PROFILE_TOP`` ops that took the most
    device time, summed by name (ms)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    by_name: dict = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            # template arguments make kernel names long: sum by their head
            name = e.key[:80]
            by_name[name] = (by_name.get(name, 0.0)
                             + e.self_device_time_total / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    return {"wall_s": wall, "busy_s": sum(by_name.values()) / 1e3,
            "top_device_ms": dict(top)}


def idle_share(busy: float, wall: float):
    """1 - busy / wall, unclamped: a negative share says the two readings
    do not compare, and is printed as such."""
    return 1.0 - busy / wall if busy > 0 else "not measured"


def profile_phase(graphs: dict, walls: dict, device) -> list:
    """Each kernel engine once more under the profiler: its device busy
    time against its unprofiled wall from the main-path run (the plain
    twins are left out: their thousands of small ops make the trace cost
    minutes).  ``graphs`` maps a name to (graph, the engines to profile)."""
    lines = []
    for name, (cg, engines) in graphs.items():
        for eng in engines:
            prof = profile_call(lambda: run_engine(cg, 0, eng, device))
            wall = walls[name, eng]
            lines.append(dict(profile=eng, graph=name, wall_s=wall,
                              profiled_wall_s=prof["wall_s"],
                              device_busy_s=prof["busy_s"],
                              device_idle_share=idle_share(prof["busy_s"],
                                                           wall)))
    return lines


def launch_counts(wrappers: dict) -> dict:
    return {k: fn.launches for k, fn in wrappers.items()}


def launches_since(wrappers: dict, before: dict) -> dict:
    """Each kernel's launches since ``before`` (:func:`launch_counts`),
    those launched only."""
    return {k: fn.launches - before[k] for k, fn in wrappers.items()
            if fn.launches > before[k]}


def engine_phase(graphs: dict, device, walls: dict, wrappers: dict) -> list:
    """The main path: every slice engine through shortest_paths.  Records
    each single-source wall in ``walls``, and the kernels' launches on each
    graph (``wrappers`` maps a kernel to its wrapper)."""
    import numpy as np

    lines = []

    def record(graph, res, wall, **extra):
        lines.append(dict(engine=res.engine, graph=graph, n=graphs[graph].n,
                          nnz=graphs[graph].nnz, wall_s=wall,
                          sweeps=res.sweeps, edges_relaxed=res.edges_relaxed,
                          converged=res.converged, **extra))

    for name, cg in graphs.items():
        lines.append(dict(graph=name, **stage_views(cg, device)))
        before = launch_counts(wrappers)
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
        lines.append(dict(graph=name, launches=launches_since(wrappers,
                                                             before)))
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
        before = launch_counts(wrappers)
        tk, wall = run_engine(cg, 0, "frontier_kernel", device, target=target)
        lines.append(dict(graph=name, query="target", launches=launches_since(
            wrappers, before)))
        tp, _ = run_engine(cg, 0, "frontier", device, target=target)
        check(tk.dist[target] == base.dist[target] and tk.pred is None,
              "target query: dist[target] differs from the full solve")
        check(tk.dist.tobytes() == tp.dist.tobytes()
              and (tk.sweeps, tk.edges_relaxed, tk.converged)
              == (tp.sweeps, tp.edges_relaxed, tp.converged),
              "target query: frontier_kernel differs from frontier")
        record(name, tk, wall, target=target)
    return lines


def dynamic_phase(name: str, cg, device, wrappers: dict) -> list:
    """The dynamic-graph path on ``cg``, with the dynamic bench's batch
    sizes, rounds and overlay capacity (repro_torch.benchmarks.
    dynamic_bench): a ``DynamicGraph`` staged on the card;
    ``solve_dynamic`` at version 0 held bitwise against the ``frontier``
    engine (dist, pred and counters); then for each batch size B, on a
    fresh overlay, the bench's rounds of B ``EdgeChurn`` edits, each
    committed and followed by a chained ``repair_sssp`` and a full
    ``solve_dynamic``, dist and pred bitwise equal every round (the bench's
    ``churn_rounds``).  After the last round the snapshot's ``frontier``
    solve and scipy's Dijkstra are held against the repaired row.  One line
    a B: medians over the counted rounds of the two walls (host clock),
    their ``edges_relaxed`` and sweeps (a shortcut round, where the batch
    cannot touch the row, counts 0 of both), the cone median, the bytes
    ``dyn_ops`` holds on the card, and, for the last round's repair and a
    full solve run once more under the profiler, the wall and device time
    of that call and its costliest ops.  No kernel launches on this
    path."""
    import numpy as np

    from repro_torch.benchmarks import dynamic_bench as DB
    from repro_torch.dynamic import DynamicGraph, repair_sssp, solve_dynamic
    from repro_torch.serve.workload import EdgeChurn

    def same(a, b, what):
        check(a.dist.tobytes() == b.dist.tobytes()
              and np.array_equal(a.pred, b.pred), what)

    lines = []
    before = launch_counts(wrappers)
    ref, _ = run_engine(cg, 0, "frontier", device)
    for B in DB.BATCH_SIZES:
        dyn = DynamicGraph(cg, overlay_capacity=DB.OVERLAY_CAPACITY)
        _, stage = timed(lambda: dyn.dyn_ops(device=device))
        prev, wall0 = timed(lambda: solve_dynamic(dyn, 0, device=device))
        same(prev, ref, f"dynamic B={B}: version 0 differs from frontier")
        check((prev.sweeps, prev.edges_relaxed, prev.converged)
              == (ref.sweeps, ref.edges_relaxed, ref.converged),
              f"dynamic B={B}: version 0 counters differ from frontier")
        rounds = []
        for rnd, (last, batch, res, st, full, t_rep, t_full) in enumerate(
                DB.churn_rounds(dyn, EdgeChurn(cg, np.random.default_rng(B)),
                                B, prev, DB.WARMUP + DB.ROUNDS, device)):
            prev = res
            if rnd >= DB.WARMUP:
                work = (0, 0) if st.shortcut else (res.sweeps,
                                                   res.edges_relaxed)
                rounds.append((t_rep, t_full, *work, full.sweeps,
                               full.edges_relaxed, st.cone, st.shortcut))
        snap = dyn.snapshot()
        fr, _ = run_engine(snap, 0, "frontier", device)
        same(prev, fr, f"dynamic B={B}: repaired row differs from the "
                       f"snapshot's frontier solve")
        rel = check_oracle(f"dynamic B={B}", prev.dist, oracle(snap, [0]))
        med = [statistics.median(col) for col in zip(*rounds)]
        # the last round's repair again, and a full solve, under the
        # profiler: device time against the wall of the same call
        prep = profile_call(lambda: repair_sssp(dyn, last, batch,
                                                device=device))
        pfull = profile_call(lambda: solve_dynamic(dyn, 0, device=device))
        lines.append(dict(
            dynamic=name, n=cg.n, nnz_live=dyn.nnz_live, B=B,
            rounds=DB.ROUNDS, warmup=DB.WARMUP, version=dyn.version,
            overlay_used=dyn.overlay_used, compactions=dyn.compactions,
            stage_dyn_ops_s=stage, staged_bytes=dyn.staged_nbytes,
            solve_v0_wall_s=wall0, repair_wall_s=med[0], full_wall_s=med[1],
            repair_sweeps=med[2], repair_edges_relaxed=med[3],
            full_sweeps=med[4], full_edges_relaxed=med[5], cone_median=med[6],
            shortcut_rounds=sum(r[7] for r in rounds),
            repair_profiled_wall_s=prep["wall_s"],
            repair_device_busy_s=prep["busy_s"],
            repair_idle_share=idle_share(prep["busy_s"], prep["wall_s"]),
            repair_top_device_ms=prep["top_device_ms"],
            full_profiled_wall_s=pfull["wall_s"],
            full_device_busy_s=pfull["busy_s"],
            full_idle_share=idle_share(pfull["busy_s"], pfull["wall_s"]),
            full_top_device_ms=pfull["top_device_ms"],
            bitwise_every_round=True, oracle_max_rel_err=rel))
        del dyn, snap
    lines.append(dict(graph=f"dynamic {name}",
                      launches=launches_since(wrappers, before)))
    return lines


def dense_engine_phase(dense: dict, device, walls: dict, rng,
                       wrappers: dict) -> list:
    """The paper's dense path on each graph through shortest_paths: serial,
    bellman, bellman_kernel and bellman_csr from source 0, multisource
    with 8 sources, the batched fixpoint through the relax_matmul kernel
    and one frontier-masked sweep.  Records each single-source wall in
    ``walls``.  The serial / bellman_kernel ratio is given twice: over the
    engine walls (each stages the matrix anew) and over the solves alone
    on a matrix already on the card."""
    import numpy as np
    import torch

    from repro_torch.core.bellman import sssp_bellman
    from repro_torch.core.multisource import sssp_multisource
    from repro_torch.core.serial import dijkstra_serial
    from repro_torch.kernels.sssp_relax.ops import (make_sweep_fn,
                                                    relax_sweep,
                                                    relax_sweep_multi)

    lines = []
    for name, g in dense.items():
        before = launch_counts(wrappers)
        cg = g.to_csr()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adj = torch.tensor(g.adj, device=device)
        torch.cuda.synchronize()
        stage = time.perf_counter() - t0
        lines.append(dict(graph=name, n=g.n, nnz=cg.nnz,
                          adj_bytes=g.adj.nbytes, stage_dense_s=stage))
        res = {}
        for eng in ("serial", "bellman", "bellman_kernel", "bellman_csr"):
            res[eng], wall = run_engine(cg if eng == "bellman_csr" else g,
                                        0, eng, device)
            walls[name, eng] = wall
            lines.append(dict(engine=eng, graph=name, n=g.n, nnz=cg.nnz,
                              wall_s=wall, sweeps=res[eng].sweeps))
        base = res["bellman"]
        for eng, r in res.items():
            check(r.dist.tobytes() == base.dist.tobytes(),
                  f"{name} {eng}: dist differs from bellman")
        for eng in ("bellman_kernel", "bellman_csr"):
            check(np.array_equal(res[eng].pred, base.pred),
                  f"{name} {eng}: pred differs from bellman")
            check(res[eng].sweeps == base.sweeps,
                  f"{name} {eng}: sweeps differ from bellman")
        # serial sets pred in settle order (Alg. 1), so on an exact f32 tie
        # it may pick another u: hold it to a valid tree instead
        d, p = res["serial"].dist, res["serial"].pred
        v = np.nonzero(np.isfinite(d))[0]
        v = v[v != 0]
        u = p[v]
        check(bool((u >= 0).all())
              and bool((d[v] == d[u] + g.adj[u, v]).all()),
              f"{name} serial: pred is not a shortest-path tree")
        rel = check_oracle(name, base.dist, oracle(cg, [0]))
        lines.append(dict(oracle="scipy.sparse.csgraph.dijkstra", graph=name,
                          max_rel_err=rel))
        solve = {}
        for eng, fn in (("serial", lambda: dijkstra_serial(adj, 0)),
                        ("bellman_kernel", lambda: sssp_bellman(
                            adj, 0, sweep_fn=make_sweep_fn()))):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            solve[eng] = time.perf_counter() - t0
        lines.append(dict(
            graph=name, serial_solve_s=solve["serial"],
            bellman_kernel_solve_s=solve["bellman_kernel"],
            serial_over_bellman_kernel_wall=(
                walls[name, "serial"] / walls[name, "bellman_kernel"]),
            serial_over_bellman_kernel_solve=(
                solve["serial"] / solve["bellman_kernel"])))

        sources = np.arange(SOURCES) * (g.n // SOURCES)
        ms, wall = run_engine(g, sources, "multisource", device)
        check(ms.dist[0].tobytes() == base.dist.tobytes(),
              f"{name} multisource row 0 differs from bellman")
        rel = check_oracle(f"{name} multisource", ms.dist,
                           oracle(cg, sources))
        lines.append(dict(engine="multisource", graph=name, wall_s=wall,
                          sweeps=ms.sweeps, sources=SOURCES,
                          oracle_max_rel_err=rel))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        D, sweeps = sssp_multisource(adj, torch.tensor(sources, device=device),
                                     sweep_fn=relax_sweep_multi)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        check(D.cpu().numpy().tobytes() == ms.dist.tobytes()
              and sweeps == ms.sweeps,
              f"{name} sssp_multisource(relax_sweep_multi) differs from "
              f"the multisource engine")
        lines.append(dict(path="sssp_multisource(sweep_fn=relax_sweep_multi)",
                          graph=name, solve_s=wall, sweeps=sweeps,
                          sources=SOURCES))
        # at the fixpoint no subset of rows improves anything
        dist = torch.tensor(base.dist, device=device)
        on = torch.tensor(rng.random(g.n) < 0.5, device=device)
        check(bitwise(relax_sweep(dist, adj, on, frontier_mode=True), dist),
              f"{name} frontier-masked sweep moved the fixpoint")
        lines.append(dict(graph=name, launches=launches_since(wrappers,
                                                             before)))
        del adj, D, dist
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
    from repro_torch.core import graph as G
    from repro_torch.core.delta_stepping import delta_profile
    from repro_torch.kernels import common
    from repro_torch.kernels.bucket_relax.kernel import bucket_relax
    from repro_torch.kernels.csr_relax.kernel import ell_relax
    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.sssp_relax.kernel import (relax_matmul,
                                                       relax_matvec,
                                                       relax_matvec_frontier)

    import min_plus_rate

    wrappers = {"ell_relax": ell_relax, "frontier_relax": frontier_relax,
                "bucket_relax": bucket_relax, "relax_matvec": relax_matvec,
                "relax_matmul": relax_matmul,
                "relax_matvec_frontier": relax_matvec_frontier}
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
    RATES.update(min_plus_rate.rates(device))
    print(json.dumps({"min_plus_rate": RATES}))

    t0 = time.perf_counter()
    graphs = {"sparse": C.sparse_csr_graph(SPARSE_N),
              "road": C.road_like_csr_graph(ROAD_N),
              "hub": C.skewed_hub_csr_graph(HUB_N)}
    for name, cg in graphs.items():
        prof = delta_profile(cg)
        print(f"graph {name}: n={cg.n} nnz={cg.nnz} auto_delta="
              f"{prof['delta']} K_light={prof['light_max_deg']}")
    dense = {f"paper-sparse-{DENSE_SPARSE_N}": G.sparse_graph(DENSE_SPARSE_N),
             f"dense-{DENSE_DENSE_N}": G.dense_graph(DENSE_DENSE_N)}
    for name, g in dense.items():
        print(f"graph {name}: n={g.n} nnz={g.to_csr().nnz} "
              f"adj={g.adj.nbytes} bytes")
    print(f"graph generation: {time.perf_counter() - t0:.1f} s")

    try:
        rng = np.random.default_rng(0)
        kern, pull_lines = kernel_phase(graphs, device, rng)
        big = f"paper-sparse-{DENSE_SPARSE_N}"
        t0 = time.perf_counter()
        kern.update(dense_kernel_phase(dense[big], device, rng))
        dense_s = {"dense_kernel_phase_s": time.perf_counter() - t0}
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        walls = {}
        lines = pull_lines + engine_phase(graphs, device, walls, wrappers)
        t0 = time.perf_counter()
        lines += dynamic_phase("sparse-4M", graphs["sparse"], device,
                               wrappers)
        lines.append({"dynamic_phase_s": time.perf_counter() - t0})
        t0 = time.perf_counter()
        lines += dense_engine_phase(dense, device, walls, rng, wrappers)
        dense_s["dense_engine_phase_s"] = time.perf_counter() - t0
        lines.append(dense_s)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        for k, cnt in launches.items():
            check(cnt > 0, f"kernel {k} was not launched on the main path")
        lines.append(serial_check(device))
        profiled = {name: (cg, tuple(TWINS)) for name, cg in graphs.items()}
        profiled[big] = (dense[big], ("bellman_kernel",))
        lines += profile_phase(profiled, walls, device)
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
