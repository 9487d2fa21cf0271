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
   ``frontier`` engine, and for mutation batches of 8 edges
   (:data:`DYN_BATCH_SIZES`) 2 + 12 rounds of churn, each repaired (``repair_sssp``, chained) and re-solved
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
   wall ratio is the paper's headline comparison on this card.  The 16-bit
   mode (:func:`dense_lowp_kernel_phase`, :func:`dense_lowp_engine_phase`):
   the three kernels in bfloat16 and float16 on paper-sparse-40000's
   matrix (3.2 GB) bitwise against their plain versions and timed, and at
   n = 4099 and 4100 bitwise, in float32 too; then, in its own launch window
   (``dense_16bit``), ``sssp_bellman`` and ``sssp_multisource`` on the
   bfloat16 matrix through the kernels and through the plain sweeps, dist,
   pred, D and sweeps bitwise, one launch a sweep; one ``{"dense_16bit":
   ...}`` line each, the gap to the float32 answers printed, not gated;
6. the sharded engines (:func:`sharded_engines`), in their own launch
   window, on an NCCL group of one rank: on sparse-4M
   ``bellman_csr_sharded`` and ``frontier_sharded`` (and a ``target=``
   query) bitwise equal to ``frontier_kernel``, ``multisource_csr_sharded``
   with 16 sources row by row to per-source solves; ``dijkstra_sharded``
   with each MINLOC collective on dense-2000, ``bellman_sharded`` and the
   sharded ``multisource`` on paper-sparse-40000, against
   ``bellman_kernel``, ``serial`` and ``multisource``; one
   ``{"sharded": ...}`` line a run (wall, sweeps, edges, collectives, the
   single-device wall); ``ell_relax`` and ``frontier_relax`` must launch
   in the window.  Then the kernels' two sharded modes
   (:func:`kernel_mode_phase`: row base and explicit labels) bitwise
   against their plain versions on block 2 of a 4-way partition of
   sparse-4M, timed (explicit labels also on block 2 of hub-1M / 4, whose
   hubs are long rows, and held untimed on a frontier of duplicate ids
   and sentinel runs across the kernel's 32-row tiles), one
   ``{"kernel_mode": ...}`` line each and a ``{"kernel_modes": ...}``
   summary before the kernels line;
7. the serving path (:func:`serve_phase`), with the launch counts set to 0
   just before it and read just after: a ``GraphRegistry`` on the card
   holding sparse-4M, hub-1M and a ``DynamicGraph`` of sparse-4M, each
   with 8 ALT landmarks, one ``MicroBatchScheduler`` (16 sources a batch,
   a 64-row ``DistanceCache``) replaying a Zipf trace and a point-to-point
   trace over the static graphs and a churn trace over the dynamic one in
   open loop on the wall clock, then a lone p2p query a static graph (the
   ``target=`` residue, through ``frontier_relax``) and one 16-source
   tick under the profiler; every exact answer bitwise equal to a fresh
   ``frontier_kernel`` solve of its (graph, version, source), one source
   a graph against scipy, and ``engine="auto"`` launching its routed
   kernel; one ``{"serve": ...}`` line a trace;
8. observability (:func:`obs_phase`): the CSR engines on sparse-4M and the
   Zipf replay again under a ``Tracer`` and a ``CostLog``, their files
   through the port's ``validate`` (the CLI for the replay's), every cost
   record stamped ``"gpu"`` and the card's name, and traced against
   untraced walls (printed, not gated);
9. sharded serving (:func:`sharded_serve_phase`), in its own launch
   window: a serving group of 4 gloo ranks sharing the card (this
   process the leader, three spawned followers; gloo carries their CUDA
   tensors, NCCL refuses two ranks on one GPU), its registry holding
   sparse-4M at full width, staged as one 1M-row block a rank, and hub-1M
   below the shard threshold, served single-device; the serve phase's Zipf
   and point-to-point traces replayed through one scheduler in open loop,
   then 4 lone p2p queries on sparse-4M (``frontier_sharded`` to its
   fixpoint, ``frontier_relax`` on every rank); every exact answer bitwise
   equal to a fresh ``frontier_kernel`` row, one source against scipy; the
   followers' kernel launches read through the group's ``STATS`` command
   and counted under the path ``sharded_serve``; then ``sssp_serve --smoke
   --devices 4 --shard-threshold 128 --shared-card``; one
   ``{"sharded_serve": ...}`` line a trace;
10. the serving drivers (:func:`drivers_phase`), in their own launch
   window: ``repro_torch.launch.sssp_serve`` at ``--smoke`` (checked
   against ``serial``), at its defaults (checked against fresh
   ``frontier_kernel`` rows, each held to scipy) and ``--chaos --smoke``,
   and ``repro_torch.launch.sssp_dynamic --smoke``, all ``--device
   cuda``; one ``{"driver": ...}`` line a run;
11. self-tuning (:func:`tune_phase`), in its own launch window: a
   calibration over the full grid, the fitted model, and the threshold
   policy raced against ``TunedPolicy`` on tune_bench's full legs (answers
   bitwise equal, the model routing, each chosen engine's kernel launched,
   the race's cost log replayed green), then the serving registry's
   sparse-4M and hub-1M routed through the tuned policy; one
   ``{"tune": ...}`` line;
12. the paper's tables and the SSSP examples (:func:`paper_phase`), in
   their own launch window: ``repro_torch.examples`` ``quickstart``,
   ``sssp_pipeline`` (n = 100,000, m = 3n, the sharded engines on an NCCL
   group of one; and n = 2000, Table I's largest, for the engines that
   hold the n × n matrix),
   ``sssp_dynamic_demo`` and ``sssp_serve_demo`` with their own checks,
   then ``repro_torch.benchmarks.run --quick --ranks-device cpu`` (its
   P-rank sweeps cut to P ≤ 2, weak scaling to ``frontier_sharded`` and
   Table III to its (100, 300) leg, :data:`PAPER_CUTS`) and
   ``table2_sparse_csr --quick`` into a temporary directory, every CSV row
   with finite times, ``ell_relax``, ``frontier_relax``, ``bucket_relax``
   and ``relax_matvec`` launched by the pipeline; one ``{"paper": ...}``
   line;
13. the LMs (:func:`lm_phase`), in their own launch window (they launch
   none of the six kernels: no A.13 module of JAX's has a Pallas
   kernel): gemma2-2b at full width in bf16, random parameters drawn on
   the card, served through ``repro_torch.launch.serve.serve`` at the JAX
   driver's defaults (8 requests, batch 4, prompt 32, gen 16), then one
   8192-token prompt past its 4096-token window; the same widths in f32
   with prefill + decode against the forward pass and 512-query chunks
   against none; six archs' smoke configs on the card against the CPU
   (forward, decode and a gradient); qwen2-moe (experts, 4 dead) and
   zamba2 (Mamba2 + the shared block, also over the 8192-token prompt)
   served at full width, and the serve driver on mamba2-130m; mamba2-130m
   trained at full width through the training driver, crashed at step 12
   and restarted, its replayed steps within 1e-6 of the clean run's; one
   ``{"lm": ...}`` line a part;
14. the mesh side of the LMs (:func:`lm_mesh_phase`), in its own launch
   window (no kernel either): gemma3-1b at full width trained on one rank
   (steps 0-3, a checkpoint at step 2), then restored by the training
   driver on a (1, 2) mesh of two gloo ranks sharing the card (DTensor
   state; each rank attends 2 of the 4 heads over the one KV head) and
   trained on, its steps 2-3 within 2e-2 relative of the single rank's;
   gemma3-1b's bf16 gradients on that mesh as close to the f32 gradients
   as one rank's bf16 ones are (within twice, per leaf by norm); one
   qwen2-moe MoE layer at full width, expert-parallel on the (1, 2) mesh
   against the grouped path on one rank (f32: JAX's 2e-3 / 1e-4; bf16:
   two roundings); one ``{"lm_mesh": ...}`` line a part;
15. the dry run and the roofline (:func:`dryrun_phase`), in its own
   launch window (no kernel): five production cells traced on the pod
   mesh (256 fake ranks) by ``python -m repro_torch.launch.dryrun`` under
   the card's torch, each train cell's dot flops and all-to-all bytes
   held to torch 2.13's; the step counter over real CUDA tensors on
   gemma2-2b at full width (prefill 1 × 8192, a batch-4 decode step), its
   counts equal to those over the dry run's fake meta tensors and
   its peak within 10% of the allocator's, each step's roofline bound
   beside its CUDA-event time; the collective latency constant; one
   ``{"dryrun": ...}``, ``{"roofline_card": ...}`` and
   ``{"collective_latency": ...}`` line.

It prints the card, the measured rates, one JSON line per CSR-kernel
shape, per engine run, per dynamic batch size, per serve trace, per obs
pass, per driver run and per graph's (and the target query's and the
dynamic phase's) kernel launches, one ``{"kernels": ...}`` line
(``launches`` summed over the counted windows, ``launches_by_path``
split; each dense kernel's 16-bit rows under ``bfloat16`` and ``float16``
and its ``launches_16bit``), and last ``{"ok": true, "device": ...}``.
Any failed check exits non-zero before that line; so does a machine
without a CUDA GPU.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
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
#: the sharded phase: multisource_csr_sharded's batch on sparse-4M, and the
#: P of the partition whose block 2 holds the two kernel modes
SHARDED_SOURCES = 16
MODE_NPROCS = 4
MODE_BLOCK = 2
KERNEL_REPS = 20
PLAIN_REPS = 5
#: the dynamic phase runs the dynamic bench's larger batch size only (its
#: B = 1 doubled the phase's fixed cost: a 4M-vertex snapshot, its
#: frontier solve and scipy's)
DYN_BATCH_SIZES = (8,)
#: seconds by phase on the host clock, and scipy's oracle solves summed
#: across phases (``scipy_oracle``): printed as one ``{"clock_s": ...}``
#: line, so a run that nears its time limit shows where to cut
CLOCK: dict = {}
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
#: the serving configuration: three graphs on the card, 8 ALT landmarks
#: each, a scheduler of 16 sources a batch over a 64-row cache, and the
#: traces replayed through it
SERVE_LANDMARKS = 8
SERVE_MAX_BATCH = 16
SERVE_CACHE_ROWS = 64
SERVE_OVERLAY = 512
SERVE_QUERIES = 64
SERVE_RATE = 2000.0
CHURN_EVENTS = 32
#: the sharded serving phase: P gloo ranks sharing the card, a shard
#: threshold between its two graphs (sparse-4M shards, hub-1M does not),
#: each trace's length and the lone p2p queries served after the traces
SHARDED_SERVE_P = 4
SHARDED_SERVE_THRESHOLD = 2_000_000
SHARDED_SERVE_QUERIES = 32
SHARDED_SERVE_LONE_P2P = 4
#: the kernel each kernel engine launches
KERNEL_OF = {"bellman_csr_kernel": "ell_relax",
             "frontier_kernel": "frontier_relax",
             "delta_stepping_kernel": "bucket_relax"}


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
    """Same dtype, shape and bits (float32 or 16-bit floats)."""
    import torch

    view = torch.int32 if a.element_size() == 4 else torch.int16
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(view),
                                              b.contiguous().view(view))


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


def dense_inputs(n: int, rng, device, dtype=None) -> tuple:
    """Labels with ~30% INF, a 50% frontier and SOURCES label rows, from
    the seed, in ``dtype`` (float32 if None)."""
    import torch

    dist = mixed_dist(n, rng, device)
    on = torch.tensor(rng.random(n) < 0.5, device=device)
    D = torch.stack([mixed_dist(n, rng, device) for _ in range(SOURCES)])
    if dtype is not None:
        dist, D = dist.to(dtype), D.to(dtype)
    return dist, on, D


def dense_checks(adj, dist, on, D, what: str) -> dict:
    """The three min-plus kernels bitwise against their plain versions
    (relax_matvec_frontier also against the masked relax_matvec); returns
    each kernel's largest error against its plain version."""
    import torch

    from repro_torch.kernels.sssp_relax.kernel import (relax_matmul,
                                                       relax_matvec,
                                                       relax_matvec_frontier)
    from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                    relax_sweep_multi_ref,
                                                    relax_sweep_ref)

    err = {}
    for name, got, ref in (
            ("relax_matvec", relax_matvec(dist, adj),
             relax_sweep_ref(dist, adj)),
            ("relax_matvec_frontier", relax_matvec_frontier(dist, on, adj),
             relax_sweep_frontier_ref(dist, on, adj)),
            ("relax_matmul", relax_matmul(D, adj),
             relax_sweep_multi_ref(D, adj))):
        check(bitwise(got, ref), f"{name} differs from its plain version "
              f"({what})")
        err[name] = max_abs_err(got, ref)
    masked = torch.where(on, dist, torch.inf)
    check(bitwise(relax_matvec_frontier(dist, on, adj),
                  torch.minimum(dist, relax_matvec(masked, adj))),
          f"relax_matvec_frontier differs from the masked relax_matvec "
          f"({what})")
    return err


def dense_kernel_phase(g, device, rng, adj=None) -> dict:
    """The three min-plus kernels against their plain versions on
    paper-sparse-40000's matrix, in float32 or, given ``adj`` in 16 bits,
    in its dtype.  The kernels skip rows whose label is INF (for
    relax_matmul: INF for every source of the tile), so each bound counts
    the rows the function needs, at the element's bytes.  No single
    PyTorch call computes a dense min-plus product, so there is no library
    time."""
    import torch

    from repro_torch.kernels.sssp_relax.kernel import (relax_matmul,
                                                       relax_matvec,
                                                       relax_matvec_frontier)
    from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                    relax_sweep_multi_ref,
                                                    relax_sweep_ref)

    n = g.n
    if adj is None:
        adj = torch.tensor(g.adj, device=device)
    dist, on, D = dense_inputs(n, rng, device, adj.dtype)
    e = adj.element_size()
    shape = f"paper-sparse-{n} n={n}"
    if adj.dtype != torch.float32:
        shape += f" {str(adj.dtype).removeprefix('torch.')}"
    err = dense_checks(adj, dist, on, D, shape)

    def row(name, fn, plain, nbytes, pairs, shape_):
        b, by = bound_ms(nbytes, pairs)
        return dict(shape=shape_, design=DENSE_DESIGN[name],
                    bitwise_equal_plain=True,
                    max_abs_err=err[name], ms=time_ms(fn, KERNEL_REPS),
                    plain_ms=time_ms(plain, PLAIN_REPS), library_ms=None,
                    bound_ms=b, bound_by=by)

    out = {}
    rows = int(torch.isfinite(dist).sum())
    out["relax_matvec"] = row(
        "relax_matvec", lambda: relax_matvec(dist, adj),
        lambda: relax_sweep_ref(dist, adj), rows * n * e + 2 * n * e,
        rows * n, f"{shape} finite_rows={rows}")
    rows = int((on & torch.isfinite(dist)).sum())
    out["relax_matvec_frontier"] = row(
        "relax_matvec_frontier", lambda: relax_matvec_frontier(dist, on, adj),
        lambda: relax_sweep_frontier_ref(dist, on, adj),
        rows * n * e + 2 * n * e + n, rows * n,
        f"{shape} frontier={int(on.sum())} rows_read={rows}")
    rows = int(torch.isfinite(D).any(dim=0).sum())
    out["relax_matmul"] = row(
        "relax_matmul", lambda: relax_matmul(D, adj),
        lambda: relax_sweep_multi_ref(D, adj),
        rows * n * e + 2 * SOURCES * n * e, SOURCES * rows * n,
        f"{shape} S={SOURCES} rows_read={rows}")
    return out


#: how each dense kernel is built (csrc/), in every dtype
DENSE_DESIGN = {
    "relax_matvec": "16-byte column loads (8 16-bit or 4 float32 columns a "
                    "thread; scalar loads unless n % 8 or 4 == 0 and adj "
                    "16-byte aligned), the finite rows of a tile of 256 "
                    "(down to 32 at small n) compacted, 8 rows loaded "
                    "before folding, balanced work list of (column block, "
                    "row tile), one CAS a pair of 16-bit columns",
    "relax_matvec_frontier": "relax_matvec's, the live rows compacted from "
                             "the frontier's finite rows",
    "relax_matmul": "D tile transposed in shared memory, 4 columns a thread "
                    "(16-byte float32 / 8-byte 16-bit loads when n % 4 == "
                    "0), compacted live rows, cp.async ring of 4 (float32), "
                    "balanced work list",
}
#: the 16-bit dense mode: its dtypes (each matrix 3.2 GB at n = 40,000) and
#: the one it runs the fixpoints in
DENSE_LOWP = ("bfloat16", "float16")
DENSE_LOWP_ENGINES = "bfloat16"
#: n held bitwise only, in float32 and 16 bits: 16-bit rows on every other
#: 2-byte boundary (4099) and on 8-byte ones (4100, n % 8 == 4): the
#: matvecs' scalar loads, relax_matmul's 8-byte loads in 16 bits
DENSE_SMALL_NS = (4099, 4100)


def dense_lowp_kernel_phase(g, device, rng) -> tuple[dict, dict, object]:
    """The three min-plus kernels in bfloat16 and float16 on
    paper-sparse-40000's matrix (:func:`dense_kernel_phase`: bitwise and
    timed) and, bitwise only, in float32 and 16 bits on the matrices of
    DENSE_SMALL_NS.  Returns the rows by dtype and kernel, one line of
    what was held, and the matrix in DENSE_LOWP_ENGINES for
    :func:`dense_lowp_engine_phase`."""
    import torch

    from repro_torch.core import graph as G

    full = torch.tensor(g.adj, device=device)
    rows, keep = {}, None
    for name in DENSE_LOWP:
        adj = full.to(getattr(torch, name))
        rows[name] = dense_kernel_phase(g, device, rng, adj=adj)
        if name == DENSE_LOWP_ENGINES:
            keep = adj
        del adj
    del full
    for n in DENSE_SMALL_NS:
        small = torch.tensor(G.sparse_graph(n, seed=1).adj, device=device)
        for name in ("float32", *DENSE_LOWP):
            dtype = getattr(torch, name)
            dist, on, D = dense_inputs(n, rng, device, dtype)
            dense_checks(small.to(dtype), dist, on, D, f"sparse-{n} {name}")
    line = dict(dense_16bit="kernels", dtypes=list(DENSE_LOWP),
                bitwise_equal_plain_at=[g.n, *DENSE_SMALL_NS],
                float32_bitwise_equal_plain_at=list(DENSE_SMALL_NS),
                sources=SOURCES, frontier=0.5)
    return rows, line, keep


def dense_lowp_engine_phase(adj, g, device, rng, ref: dict) -> dict:
    """sssp_bellman and sssp_multisource (SOURCES sources) with the 16-bit
    matrix ``adj`` through the kernel sweeps and through the plain sweeps
    on the card: dist, pred, D and sweeps bitwise equal; one
    frontier-masked kernel sweep at the fixpoint moves nothing.  Returns
    one line with the walls, the sweeps and the largest gap to the float32
    answers ``ref`` (dense_engine_phase's ``refs`` of the graph): what 16
    bits cost in exactness, information and not a check."""
    import numpy as np
    import torch

    from repro_torch.core.bellman import sssp_bellman
    from repro_torch.core.multisource import sssp_multisource
    from repro_torch.kernels.sssp_relax.ops import (make_sweep_fn,
                                                    relax_sweep,
                                                    relax_sweep_multi)

    def solve(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    what = f"paper-sparse-{g.n} {str(adj.dtype).removeprefix('torch.')}"
    (kd, kp, ks), kwall = solve(lambda: sssp_bellman(
        adj, 0, sweep_fn=make_sweep_fn()))
    (pd, pp, ps), pwall = solve(lambda: sssp_bellman(adj, 0))
    check(bitwise(kd, pd) and torch.equal(kp, pp) and ks == ps,
          f"{what}: sssp_bellman through the kernel differs from the plain "
          f"sweep")
    sources = torch.tensor(np.arange(SOURCES) * (g.n // SOURCES),
                           device=device)
    (KD, kms), kmwall = solve(lambda: sssp_multisource(
        adj, sources, sweep_fn=relax_sweep_multi))
    (PD, pms), pmwall = solve(lambda: sssp_multisource(adj, sources))
    check(bitwise(KD, PD) and kms == pms,
          f"{what}: sssp_multisource through the kernel differs from the "
          f"plain sweep")
    on = torch.tensor(rng.random(g.n) < 0.5, device=device)
    check(bitwise(relax_sweep(kd, adj, on, frontier_mode=True), kd),
          f"{what}: the frontier-masked sweep moved the fixpoint")
    f32 = torch.tensor(ref["bellman"].dist, device=device)
    F32 = torch.tensor(ref["multisource"].dist, device=device)
    return dict(dense_16bit="engines", graph=f"paper-sparse-{g.n}",
                dtype=str(adj.dtype).removeprefix("torch."),
                bitwise_equal_plain=True,
                bellman_kernel_s=kwall, bellman_plain_s=pwall, sweeps=ks,
                f32_sweeps=ref["bellman"].sweeps,
                multisource_kernel_s=kmwall, multisource_plain_s=pmwall,
                multisource_sweeps=kms,
                f32_multisource_sweeps=ref["multisource"].sweeps,
                max_abs_gap_to_f32=max_abs_err(kd.float(), f32),
                multisource_max_abs_gap_to_f32=max_abs_err(KD.float(), F32),
                max_rel_gap_to_f32=float(
                    ((kd.float() - f32).abs() / f32.clamp(min=1.0))
                    [torch.isfinite(f32)].max()),
                pred_equal_f32=bool(torch.equal(
                    kp.cpu(), torch.tensor(ref["bellman"].pred))))


#: scipy's Dijkstra for the (graph, sources) pairs known once the graphs
#: are built, in child processes started then (up to ORACLE_SPLIT a pair,
#: each on a share of the sources), so that it runs while the card works
#: (scipy holds the GIL: a thread would stall the host side of every
#: phase); ``oracle`` waits for the result.  Keyed by the graph object,
#: which the entry holds.
ORACLE_JOBS: dict = {}
ORACLE_SPLIT = 4
ORACLE_CHILD = r"""
import sys, types
import numpy as np
from repro_torch.launch.sssp_run import scipy_distances
d = np.load(sys.argv[1])
cg = types.SimpleNamespace(n=int(d["n"]), indptr=d["indptr"],
                           indices=d["indices"], weights=d["weights"])
np.save(sys.argv[2], scipy_distances(
    cg, [int(v) for v in sys.argv[3].split(",")]))
"""


def prefetch_oracle(cg, sources, tmp: str) -> None:
    """Start scipy's distances of ``cg`` from ``sources`` in children."""
    import numpy as np

    i = len(ORACLE_JOBS)
    src = np.asarray(sources)
    inp = f"{tmp}/oracle{i}.npz"
    np.savez(inp, n=cg.n, indptr=cg.indptr, indices=cg.indices,
             weights=cg.weights)
    children = []
    for j, part in enumerate(np.array_split(src, min(ORACLE_SPLIT,
                                                     len(src)))):
        out = f"{tmp}/oracle{i}_{j}.npy"
        with open(out + ".err", "w") as err:
            children.append((subprocess.Popen(
                [sys.executable, "-c", ORACLE_CHILD, inp, out,
                 ",".join(str(int(v)) for v in part)],
                stdout=subprocess.DEVNULL, stderr=err, env=dict(
                    os.environ, PYTHONPATH=str(
                        Path(__file__).resolve().parent / "src"))), out))
    ORACLE_JOBS[id(cg), tuple(int(v) for v in src)] = (cg, children)


def stop_oracles() -> None:
    """End the children no ``oracle`` call waited for."""
    for _, children in ORACLE_JOBS.values():
        for proc, _ in children:
            proc.kill()
            proc.wait()
    ORACLE_JOBS.clear()


def oracle(cg, sources):
    import numpy as np

    from repro_torch.launch.sssp_run import scipy_distances

    t0 = time.perf_counter()
    job = ORACLE_JOBS.pop((id(cg), tuple(int(v) for v in sources)), None)
    if job is None:
        out = scipy_distances(cg, sources)
    else:
        for proc, path in job[1]:
            check(proc.wait() == 0, f"scipy oracle child failed: "
                  f"{Path(path + '.err').read_text()[-2000:]}")
        out = np.concatenate([np.load(path) for _, path in job[1]])
    CLOCK["scipy_oracle"] = (CLOCK.get("scipy_oracle", 0.0)
                             + time.perf_counter() - t0)
    return out


def clocked(name: str, fn):
    """``fn()``, its host-clock seconds added to ``CLOCK[name]``."""
    t0 = time.perf_counter()
    try:
        return fn()
    finally:
        CLOCK[name] = CLOCK.get(name, 0.0) + time.perf_counter() - t0


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


def engine_oracle_sources(name: str, cg):
    """The sources the engine phase checks against scipy on graph
    ``name``: sparse-4M's multisource batch, vertex 0 elsewhere."""
    import numpy as np

    if name == "sparse":
        return np.arange(SOURCES) * (cg.n // SOURCES)
    return [0]


def engine_phase(graphs: dict, device, walls: dict, wrappers: dict,
                 refs: dict) -> list:
    """The main path: every slice engine through shortest_paths.  Records
    each single-source wall in ``walls``, the kernels' launches on each
    graph (``wrappers`` maps a kernel to its wrapper), and in ``refs`` the
    ``frontier_kernel`` result and the target query's vertex on sparse-4M
    (the sharded phase's references)."""
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
            rel = check_oracle(name, base.dist, oracle(
                cg, engine_oracle_sources(name, cg)))
            lines.append(dict(oracle="scipy.sparse.csgraph.dijkstra",
                              graph=name, max_rel_err=rel))
            continue

        # sparse-4M: the batched engine and a point-to-point query.
        sources = engine_oracle_sources(name, cg)
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
        refs["sparse"], refs["target"] = res["frontier_kernel"], target
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
    """The dynamic-graph path on ``cg``, with the dynamic bench's rounds
    and overlay capacity (repro_torch.benchmarks.dynamic_bench) and the
    batch sizes of :data:`DYN_BATCH_SIZES`: a ``DynamicGraph`` staged on
    the card;
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
    for B in DYN_BATCH_SIZES:
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
                       wrappers: dict, refs: dict) -> list:
    """The paper's dense path on each graph through shortest_paths: serial,
    bellman, bellman_kernel and bellman_csr from source 0, multisource
    with 8 sources, the batched fixpoint through the relax_matmul kernel
    and one frontier-masked sweep.  Records each single-source wall (and
    multisource's) in ``walls``, and each engine's result in ``refs[name]``
    (the sharded phase's references).  The serial / bellman_kernel ratio is given twice: over the
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
        walls[name, "multisource"] = wall
        refs[name] = dict(res, multisource=ms)
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


def serve_phase(static: dict, dyn_base, device, wrappers: dict,
                lines: list) -> tuple:
    """The serving path on the card: a ``GraphRegistry(device)`` holding
    the graphs of ``static`` (name -> CsrGraph) and a ``DynamicGraph`` of
    ``dyn_base``, each with its landmarks; one scheduler replaying three
    traces in turn (Zipf and point-to-point over the static graphs, churn
    over the dynamic one) through ``sssp_serve``'s open-loop ``replay``
    (repro_torch.launch.sssp_serve) with its ``Verifier`` after every
    tick, every exact answer held to a fresh ``frontier_kernel`` solve.  At
    these sizes a tick of 16 sources takes long against the traces' 2000
    arrivals a second, so the open loop keeps a backlog and a tick's
    residue is rarely one lone point-to-point query; so a lone p2p query
    a static graph is then served by the idle scheduler (the ``target=``
    residue path, through ``frontier_relax``).  Then one source a graph
    against scipy, and ``engine="auto"`` on each static graph against the
    engine it named, its kernel's launches read.  Appends its lines to
    ``lines`` (one a trace, one for the registry, the residue, the oracle
    and auto) and returns the registry, the Zipf trace and its wall."""
    import numpy as np
    import torch

    from repro_torch.dynamic import DynamicGraph
    from repro_torch.launch.sssp_serve import Verifier, replay
    from repro_torch.serve import (DistanceCache, GraphRegistry,
                                   LatencyRecorder, MicroBatchScheduler,
                                   make_churn_trace, make_trace)

    t0 = time.perf_counter()
    registry = GraphRegistry(device=device)
    for name, cg in static.items():
        registry.register(name, cg, landmarks=SERVE_LANDMARKS)
    dyn_name = f"dyn-{next(iter(static))}"
    dyn = DynamicGraph(dyn_base, overlay_capacity=SERVE_OVERLAY)
    registry.register(dyn_name, dyn, landmarks=SERVE_LANDMARKS)
    lines.append(dict(registry=list(registry.names),
                      register_s=time.perf_counter() - t0,
                      landmarks=SERVE_LANDMARKS,
                      bytes_in_use=registry.bytes_in_use))
    cache = DistanceCache(capacity=SERVE_CACHE_ROWS)
    sched = MicroBatchScheduler(registry, cache, max_batch=SERVE_MAX_BATCH)
    verify = Verifier(registry, reference="frontier_kernel", device=device)
    sizes = [(name, cg.n) for name, cg in static.items()]
    traces = {
        "zipf": make_trace("zipf", sizes, num_queries=SERVE_QUERIES,
                           rate=SERVE_RATE, seed=0),
        # another seed than the Zipf trace's, so another hot set
        "p2p": make_trace("p2p", sizes, num_queries=SERVE_QUERIES,
                          rate=SERVE_RATE, seed=1),
        "churn": make_churn_trace([(dyn_name, dyn.base)],
                                  num_events=CHURN_EVENTS, rate=SERVE_RATE,
                                  mutate_frac=0.15, p2p_frac=0.3, seed=0),
    }
    for trace, events in traces.items():
        before = launch_counts(wrappers)
        hits0, misses0, occ0 = cache.hits, cache.misses, sched.occupancy_sum
        s0 = sched.stats()
        exact0, inexact0 = verify.exact, verify.inexact
        answers, wall, paused = replay(sched, events, verify)
        s1 = sched.stats()
        rec = LatencyRecorder()
        for a in answers:
            if a.via != "mutate":
                rec.observe(a, a.done_at)
        hits, misses = cache.hits - hits0, cache.misses - misses0
        batches = s1["engine_batches"] - s0["engine_batches"]
        delta = {k: s1[k] - s0[k] for k in (
            "ticks", "target_solves", "dedup_saved", "rows_kept",
            "rows_repaired", "rows_invalidated")}
        lines.append(dict(
            serve=trace, events=len(events),
            queries=sum(a.via != "mutate" for a in answers),
            mutations=sum(a.via == "mutate" for a in answers),
            wall_s=wall, verify_s=paused,
            answered_via={k: v - s0["answered_via"][k]
                          for k, v in s1["answered_via"].items()
                          if v > s0["answered_via"][k]},
            cache_hit_rate=hits / (hits + misses) if hits + misses else 0.0,
            engine_batches=batches,
            mean_occupancy=((sched.occupancy_sum - occ0) / batches
                            if batches else 0.0),
            **delta, exact_checked=verify.exact - exact0,
            inexact=verify.inexact - inexact0, latency=rec.summary(),
            bytes_in_use=registry.bytes_in_use,
            dyn_version=registry.get(dyn_name).version,
            launches=launches_since(wrappers, before)))
    # the p2p residue: one lone query a static graph on an idle scheduler,
    # between vertices a landmark reaches (no disconnection proof) whose
    # rows are neither cached nor landmark rows
    before = launch_counts(wrappers)
    targets0 = sched.target_solves
    for name, cg in static.items():
        h = registry.get(name)
        reached = np.isfinite(h.landmarks.D[0])
        reached[h.landmarks.ids] = False
        cached = set(cache.keys_for(name))
        cands = [int(v) for v in np.flatnonzero(reached)[::997]
                 if h.row_key(int(v)) not in cached]
        sched.submit(name, cands[0], cands[len(cands) // 2])
        answers = sched.drain(0.0)
        verify(answers)
        check([a.via for a in answers] == ["target"],
              f"lone p2p on {name} answered via {answers[0].via}")
    lines.append(dict(serve="p2p_residue", queries=len(static),
                      target_solves=sched.target_solves - targets0,
                      launches=launches_since(wrappers, before)))
    # where a batch tick's time goes: one full tick of SERVE_MAX_BATCH new
    # sources on the first graph, under the profiler on a CUDA device
    name, cg = next(iter(static.items()))
    h = registry.get(name)
    taken = set(cache.keys_for(name)) | {h.row_key(int(v))
                                         for v in h.landmarks.ids}
    fresh = [v for v in range(1, cg.n, cg.n // (4 * SERVE_MAX_BATCH))
             if h.row_key(v) not in taken]
    for v in fresh[:SERVE_MAX_BATCH]:
        sched.submit(name, v)
    answers = []
    if torch.device(device).type == "cuda":
        prof = profile_call(lambda: answers.extend(sched.tick()))
        prof["idle_share"] = idle_share(prof["busy_s"], prof["wall_s"])
    else:
        answers, prof = sched.tick(), {}
    verify(answers)
    check(len(answers) == SERVE_MAX_BATCH
          and {a.via for a in answers} == {"batch"},
          f"profiled tick answered {[a.via for a in answers]}")
    lines.append(dict(serve="profiled_tick", graph=name,
                      sources=SERVE_MAX_BATCH, **prof))
    for name, (version, src, cg) in verify.first.items():
        rel = check_oracle(f"serve {name} v{version} source {src}",
                           verify.rows[name, version, src], oracle(cg, [src]))
        lines.append(dict(oracle="scipy.sparse.csgraph.dijkstra",
                          graph=f"{name} v{version}", source=src,
                          max_rel_err=rel))
    for name, cg in static.items():
        before = launch_counts(wrappers)
        auto, wall = run_engine(cg, 0, "auto", device)
        moved = launches_since(wrappers, before)
        counts = launch_counts(wrappers)
        named, _ = run_engine(cg, 0, auto.engine, device)
        for k, fn in wrappers.items():      # a comparison, not serving
            fn.launches = counts[k]
        check(auto.dist.tobytes() == named.dist.tobytes()
              and np.array_equal(auto.pred, named.pred),
              f"auto on {name} differs from {auto.engine}")
        kernel = KERNEL_OF.get(auto.engine)
        lines.append(dict(auto=name, engine=auto.engine, wall_s=wall,
                          launches=moved, bitwise_equal_named=True))
        if torch.device(device).type == "cuda":
            check(moved.get(kernel, 0) > 0,
                  f"auto on {name} routed to {auto.engine}, launched "
                  f"{moved}")
    zipf_wall = next(ln["wall_s"] for ln in lines if ln.get("serve") == "zipf")
    return registry, traces["zipf"], zipf_wall


def obs_phase(cg, registry, zipf, walls: dict, zipf_wall: float, device,
              wrappers: dict, lines: list) -> None:
    """Observability on the card.  The CSR engines on ``cg`` (sparse-4M)
    once more under an installed Tracer and CostLog: their files written
    and validated (no answer chains: no scheduler ran), every record
    stamped with the device (``"gpu"`` and the card's name), traced
    against untraced walls (``walls``: engine -> the main path's) and their
    ratio.  Then the Zipf trace replayed again, traced, by a fresh
    scheduler and cache on the same ``registry``: answers verified as in
    the serve phase, every exact answer's chain reconstructed, its files
    through ``python -m repro_torch.obs.validate``, and its wall against
    ``zipf_wall``, the untraced replay's.  JAX's ``gate_obs`` asks traced
    throughput >= 0.9 x untraced; the ratios are printed, not gated.
    Appends one line a pass to ``lines``."""
    import os
    import tempfile

    from repro_torch.obs import (backend_info, finalize_capture,
                                 install_capture, set_cost_log, set_tracer)
    from repro_torch.obs.capture import cost_path_for
    from repro_torch.launch.sssp_serve import Verifier, replay
    from repro_torch.obs.validate import reconstruct_answer_chains
    from repro_torch.serve import DistanceCache, MicroBatchScheduler

    card = backend_info(device)

    def stamped(cl, what):
        bad = {(r.backend, r.device_kind) for r in cl.records} - {card}
        check(bool(cl.records) and not bad,
              f"obs {what}: records stamped {bad}")

    with tempfile.TemporaryDirectory() as tmp:
        tr, cl = install_capture()
        traced = {}
        try:
            for eng in SINGLE_ENGINES:
                _, traced[eng] = run_engine(cg, 0, eng, device)
        finally:
            set_tracer(None)
            set_cost_log(None)
        path = os.path.join(tmp, "engines.json")
        errs = finalize_capture(tr, cl, path, check_chains=False)
        check(not errs, f"obs engines: invalid capture {errs[:3]}")
        stamped(cl, "engines")
        check([r.engine for r in cl.records] == list(SINGLE_ENGINES),
              f"obs engines: records {[r.engine for r in cl.records]}")
        lines.append(dict(
            obs="engines", graph="sparse-4M", spans=len(tr.spans),
            cost_records=len(cl.records), backend=card[0],
            device_kind=card[1],
            walls={e: dict(untraced_s=walls[e], traced_s=traced[e],
                           throughput_ratio=walls[e] / traced[e])
                   for e in SINGLE_ENGINES}))

        sched = MicroBatchScheduler(registry, DistanceCache(SERVE_CACHE_ROWS),
                                    max_batch=SERVE_MAX_BATCH)
        verify = Verifier(registry, reference="frontier_kernel",
                          device=device)
        tr, cl = install_capture()
        try:
            answers, wall, paused = replay(sched, zipf, verify)
        finally:
            set_tracer(None)
            set_cost_log(None)
        path = os.path.join(tmp, "zipf.json")
        errs = finalize_capture(tr, cl, path)
        check(not errs, f"obs zipf: invalid capture {errs[:3]}")
        check(reconstruct_answer_chains(tr.to_chrome()) == [],
              "obs zipf: an answer chain is incomplete")
        stamped(cl, "zipf")
        cli = subprocess.run(
            [sys.executable, "-m", "repro_torch.obs.validate", path,
             cost_path_for(path)], capture_output=True, text=True,
            env=dict(os.environ, PYTHONPATH=str(
                Path(__file__).resolve().parent / "src")))
        check(cli.returncode == 0,
              f"obs zipf: validate CLI said {cli.stdout} {cli.stderr}")
        lines.append(dict(
            obs="zipf_replay", answers=len(answers), spans=len(tr.spans),
            instants=len(tr.instants), cost_records=len(cl.records),
            backend=card[0], device_kind=card[1],
            engines=sorted({r.engine for r in cl.records}),
            exact_checked=verify.exact, traced_wall_s=wall,
            untraced_wall_s=zipf_wall, throughput_ratio=zipf_wall / wall,
            verify_s=paused, validate_cli=cli.stdout.strip().splitlines()))


#: the serving drivers as a user runs them (argv after the module name):
#: sssp_serve's smoke as JAX's (checked against serial), its defaults (n =
#: 10,000, 2 graphs, 3 scenarios, 400 queries at 500/s; checked against
#: fresh frontier_kernel rows, each held to scipy), the chaos smoke, and
#: sssp_dynamic's smoke (checked against serial)
def sharded_engines(graphs: dict, dense: dict, refs: dict, walls: dict,
                    device, wrappers: dict, lines: list) -> None:
    """Every sharded engine through shortest_paths on an NCCL group of one
    rank on the card (NCCL, never gloo: a failure to open it fails the
    run), each held to its single-device reference from the earlier
    phases: on sparse-4M ``bellman_csr_sharded``, ``frontier_sharded``
    (dist, pred; frontier_sharded's sweeps and edges too) and a
    ``target=`` query against ``frontier_kernel``, and
    ``multisource_csr_sharded`` with 16 sources row by row against
    per-source ``frontier_kernel`` solves; ``dijkstra_sharded`` with each
    MINLOC on dense-2000 against ``bellman_kernel``'s dist and
    ``serial``'s pred; ``bellman_sharded``
    and the sharded ``multisource`` (8 sources) on paper-sparse-40000
    against ``bellman_kernel`` and ``multisource``.  One ``{"sharded":
    ...}`` line an engine run: wall, sweeps, edges, the collectives of the
    solve, and the wall of its single-device twin from the earlier phases
    (``bellman_csr_kernel``, ``frontier_kernel``, ``multisource_csr`` at 16
    sources, ``serial`` for Alg. 2, ``bellman_kernel``, ``multisource``)
    beside it.  The reference
    solves made here take their kernel launches back out of the counts:
    the window counts the sharded engines' launches only."""
    import tempfile

    import numpy as np

    from repro_torch.core._dist import open_group
    from repro_torch.core.api import shortest_paths

    def reference(engine, g, src):
        before = launch_counts(wrappers)
        out = run_engine(g, src, engine, device)
        for k, fn in wrappers.items():
            fn.launches = before[k]
        return out

    sparse = graphs["sparse"]
    t0 = time.perf_counter()
    sparse.partitioned(1)                  # host view, memoized on the graph
    lines.append(dict(graph="sparse", partition_p1_s=time.perf_counter() - t0,
                      partition_p1_bytes=sparse.partitioned(1).nbytes))
    with tempfile.TemporaryDirectory() as store, open_group(
            0, 1, backend="nccl", device=device, store_dir=store) as group:

        def run(graph, g, src, engine, single, **kw):
            c0 = group.collectives
            res, wall = timed(lambda: shortest_paths(
                g, src, engine=engine, device=device, group=group, **kw))
            lines.append(dict(
                sharded=engine, graph=graph, procs=group.size,
                backend=group.backend, wall_s=wall, sweeps=res.sweeps,
                edges_relaxed=res.edges_relaxed, converged=res.converged,
                collectives=group.collectives - c0, single_device=single,
                single_device_wall_s=walls.get((graph, single)), **kw))
            return res

        fk = refs["sparse"]
        for engine, single in (("bellman_csr_sharded", "bellman_csr_kernel"),
                               ("frontier_sharded", "frontier_kernel")):
            r = run("sparse", sparse, 0, engine, single)
            check(r.dist.tobytes() == fk.dist.tobytes()
                  and np.array_equal(r.pred, fk.pred) and r.converged,
                  f"{engine}: dist / pred differ from frontier_kernel")
        check((r.sweeps, r.edges_relaxed) == (fk.sweeps, fk.edges_relaxed),
              "frontier_sharded: sweeps / edges differ from frontier_kernel")
        r = run("sparse", sparse, 0, "frontier_sharded", "frontier_kernel",
                target=refs["target"])
        check(r.dist.tobytes() == fk.dist.tobytes(),
              "frontier_sharded target= query differs from the full solve")
        sources = np.arange(SHARDED_SOURCES) * (sparse.n // SHARDED_SOURCES)
        _, walls["sparse", "multisource_csr"] = reference(
            "multisource_csr", sparse, sources)
        r = run("sparse", sparse, sources, "multisource_csr_sharded",
                "multisource_csr")
        check(r.converged, "multisource_csr_sharded: not converged")
        for i, src in enumerate(sources):
            one, _ = reference("frontier_kernel", sparse, int(src))
            check(r.dist[i].tobytes() == one.dist.tobytes(),
                  f"multisource_csr_sharded row {i} differs from "
                  f"frontier_kernel from {src}")

        # Alg. 2 takes one MINLOC collective a vertex: n = 40,000 of them
        # cost ≈ 50 s on a group of one, so it runs at dense-2000 only
        name = f"dense-{DENSE_DENSE_N}"
        ref = refs[name]
        for minloc in ("allgather", "pmin", "packed"):
            r = run(name, dense[name], 0, "dijkstra_sharded", "serial",
                    minloc=minloc)
            check(r.dist.tobytes() == ref["bellman_kernel"].dist.tobytes()
                  and np.array_equal(r.pred, ref["serial"].pred),
                  f"{name} dijkstra_sharded ({minloc}): dist differs "
                  f"from bellman_kernel or pred from serial")
        name = f"paper-sparse-{DENSE_SPARSE_N}"
        ref = refs[name]
        r = run(name, dense[name], 0, "bellman_sharded", "bellman_kernel")
        b = ref["bellman_kernel"]
        check(r.dist.tobytes() == b.dist.tobytes()
              and np.array_equal(r.pred, b.pred) and r.sweeps == b.sweeps,
              f"{name} bellman_sharded differs from bellman_kernel")
        ms = ref["multisource"]
        r = run(name, dense[name], ms.sources, "multisource", "multisource")
        check(r.dist.tobytes() == ms.dist.tobytes() and r.sweeps == ms.sweeps,
              f"{name} sharded multisource differs from multisource")


def label_frontier(parts, ops, device, rng) -> tuple:
    """The explicit-label push's inputs on the block whose operands are
    ``ops``: a 10% random global frontier over the n_pad ids of ``parts``
    (with every row of the block's out-CSR longer than a warp, the hubs,
    on it), ascending as the exchange lists them, seven sentinel ids n_pad,
    labels from a seed, and a mixed label vector of the block.  Returns
    (fids, flab, blk0, long rows, largest degree)."""
    import torch

    n_pad = parts.n_pad
    ip = ops["out_indptr"].long()
    deg = ip[1:n_pad + 1] - ip[:n_pad]
    on = torch.tensor(rng.random(n_pad) < 0.1, device=device) | (deg > 32)
    fids = torch.cat([torch.nonzero(on).flatten(),
                      torch.full((7,), n_pad, device=device)])
    flab = torch.tensor(rng.uniform(0.0, 2000.0, fids.numel()).astype(
        "float32"), device=device)
    return (fids, flab, mixed_dist(parts.loc_n, rng, device),
            int((deg > 32).sum()), int(deg.max()))


def label_push_check(ops, fids, flab, blk0, what: str):
    """``frontier_relax`` with explicit labels against its plain version,
    bitwise, labels and fallen-label mask, and the mask against ``new <
    snapshot``.  Returns the kernel's labels and the plain version's
    labels and mask."""
    import torch

    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

    push = (fids, ops["out_indptr"], ops["out_dst"], ops["out_w"])
    blk, fell = blk0.clone(), torch.zeros(blk0.numel(), dtype=torch.bool,
                                          device=blk0.device)
    frontier_relax(blk, *push, fell, flabels=flab)
    ref, ref_fell = blk0.clone(), torch.zeros_like(fell)
    frontier_relax_ref(ref, *push, ref_fell, flabels=flab)
    check(bitwise(blk, ref) and torch.equal(fell, ref_fell),
          f"frontier_relax (explicit labels) differs from its plain version "
          f"on {what}")
    check(torch.equal(fell, blk < blk0),
          f"frontier_relax's mask is not new < snapshot (explicit labels, "
          f"{what})")
    return blk, ref, ref_fell


def label_push_line(parts, ops, device, rng, shape: str,
                    launches: int) -> dict:
    """The explicit-label push on :func:`label_frontier`'s frontier of one
    block: held bitwise (:func:`label_push_check`), then timed as the
    other kernels are, beside its plain version and one ``scatter_reduce_``
    over the same arcs (expanded before timing) and the bound of its ideal
    bytes."""
    import torch

    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

    fids, flab, blk0, n_long, max_deg = label_frontier(parts, ops, device,
                                                       rng)
    got, ref, ref_fell = label_push_check(ops, fids, flab, blk0, shape)
    push = (fids, ops["out_indptr"], ops["out_dst"], ops["out_w"])
    ip = ops["out_indptr"].long()
    live = fids < parts.n_pad + 1
    rows, rlab = fids[live], flab[live]
    starts, degs = ip[rows], ip[rows + 1] - ip[rows]
    E = int(degs.sum())
    first = torch.repeat_interleave(starts - (torch.cumsum(degs, 0) - degs),
                                    degs, output_size=E)
    pos = first + torch.arange(E, device=device)
    alab = torch.repeat_interleave(rlab, degs, output_size=E)
    fdst, fw = ops["out_dst"][pos].long(), ops["out_w"][pos]
    lib = blk0.clone()
    lib.scatter_reduce_(0, fdst, alab + fw, "amin")
    check(bitwise(lib, ref), f"scatter_reduce_ yardstick differs (explicit "
                             f"labels, {shape})")
    F, T = fids.numel(), int(torch.unique(fdst).numel())
    W = int(ref_fell.sum())
    b, by = bound_ms(F * 20 + E * 8 + T * 4 + W * 5, E)

    blk, fell = blk0.clone(), torch.zeros_like(ref_fell)

    def reset():
        blk.copy_(blk0)
        fell.zero_()

    def lib_reset():
        lib.copy_(blk0)

    return dict(
        mode="explicit_labels",
        shape=f"{shape} F={F} E={E} targets={T} fell={W} "
              f"rows_over_32_arcs={n_long} max_degree={max_deg}",
        bitwise_equal_plain=True, max_abs_err=max_abs_err(got, ref),
        ms=time_ms(lambda: frontier_relax(blk, *push, fell, flabels=flab),
                   KERNEL_REPS, reset),
        plain_ms=time_ms(lambda: frontier_relax_ref(blk, *push, fell,
                                                    flabels=flab),
                         PLAIN_REPS, reset),
        library_ms=time_ms(lambda: lib.scatter_reduce_(0, fdst, alab + fw,
                                                       "amin"),
                           PLAIN_REPS, lib_reset),
        bound_ms=b, bound_by=by, design=LABEL_PUSH_DESIGN,
        launches=launches)


def label_edge_frontier(parts, device, rng) -> tuple:
    """An exchanged frontier cut against the explicit-label kernel's
    32-row tiles: MODE_NPROCS owner segments of ascending ids, each padded
    with a sentinel run of 31 or 33 (ids n_pad, INF labels, as the
    exchange pads), every fifth id listed twice with a second label, and
    the ids around each multiple of 32 listed twice.  Returns (fids,
    flab)."""
    import numpy as np
    import torch

    n_pad, seg = parts.n_pad, parts.loc_n
    ids, lab = [], []
    for p in range(MODE_NPROCS):
        own = np.sort(rng.choice(np.arange(p * seg, (p + 1) * seg),
                                 min(3000, seg), replace=False))
        own = np.repeat(own, np.where(np.arange(own.size) % 5 == 0, 2, 1))
        ids.append(own)
        lab.append(rng.uniform(0.0, 2000.0, own.size))
        pad = 31 if p % 2 else 33
        ids.append(np.full(pad, n_pad))
        lab.append(np.full(pad, np.inf))
    ids, lab = np.concatenate(ids), np.concatenate(lab)
    edge = np.arange(31, ids.size - 1, 32)
    ids[edge + 1] = ids[edge]
    return (torch.tensor(ids, device=device),
            torch.tensor(lab.astype(np.float32), device=device))


#: how the explicit-label push is built (csrc/frontier_relax.cu)
LABEL_PUSH_DESIGN = ("one launch: persistent warps over tiles of 32 "
                     "frontier rows, each tile's arcs 32 at a time, "
                     "streaming reads")
#: the explicit-label push's time before its redesign (PERF.md section 6,
#: row 2s: block 2 of sparse-4M / 4 on an H100 80GB HBM3 at 700 W)
LABEL_PUSH_EARLIER_MS = 0.0460


def kernel_mode_phase(graphs: dict, device, rng,
                      launches: dict) -> tuple[dict, list]:
    """The two kernel modes of the sharded engines against their plain
    versions, bitwise, on block MODE_BLOCK of a MODE_NPROCS-way partition
    (one process, no collective, so the block offsets are exercised
    though the group on the card has one rank), then timed as the other
    kernels are: on sparse-4M ``ell_relax`` with a row base over the
    block's incoming CSR (padding arcs included) from a mixed label vector
    of n_pad, and ``frontier_relax`` with explicit labels pushing a 10%
    random global frontier into the block (:func:`label_push_line`); the
    latter again on hub-1M, whose hubs are long rows, and held once more
    on sparse-4M against a frontier of duplicate ids and sentinel runs
    across its tile edges (:func:`label_edge_frontier`, not timed).
    Yardstick: one ``scatter_reduce`` over the same arcs.  ``launches``
    are each kernel's launches in the sharded window.  Returns an entry a
    timed mode for the summary and one line each, the duplicate check's
    too."""
    from repro_torch.core.sharded_csr import partition_operands
    from repro_torch.kernels.common import lane_group
    from repro_torch.kernels.csr_relax.kernel import ell_relax
    from repro_torch.kernels.csr_relax.ref import ell_relax_csr_ref, row_ids

    out, lines, part_s, blocks = {}, [], {}, {}
    for name in ("sparse", "hub"):
        t0 = time.perf_counter()
        parts = graphs[name].partitioned(MODE_NPROCS)
        part_s[name] = time.perf_counter() - t0
        blocks[name] = (parts, partition_operands(parts, MODE_BLOCK,
                                                  device=device))
    parts, ops = blocks["sparse"]
    loc_n, n_pad, m = parts.loc_n, parts.n_pad, parts.nnz_max
    base = MODE_BLOCK * loc_n
    shape = (f"block {MODE_BLOCK} of sparse-4M / {MODE_NPROCS}: "
             f"n_pad={n_pad} loc_n={loc_n} nnz_max={m}")

    # ell_relax, row base
    dist = mixed_dist(n_pad, rng, device)
    csr = (ops["in_indptr"], ops["in_src"], ops["in_w"])
    got = ell_relax(dist, *csr, row_base=base)
    plain = ell_relax_csr_ref(dist, *csr, row_base=base)
    check(bitwise(got, plain), "ell_relax (row base) differs from its plain "
                               "version")
    own = dist[base:base + loc_n]
    src, dst = csr[1].long(), row_ids(csr[0], m)
    lib = own.scatter_reduce(0, dst, dist[src] + csr[2], "amin")
    check(bitwise(lib, plain), "scatter_reduce yardstick differs (row base)")
    b, by = bound_ms(m * 8 + (loc_n + 1) * 4 + loc_n * 8, m + loc_n)
    out["ell_relax"] = dict(
        mode="row_base", shape=shape, bitwise_equal_plain=True,
        max_abs_err=max_abs_err(got, plain),
        ms=time_ms(lambda: ell_relax(dist, *csr, row_base=base),
                   KERNEL_REPS),
        plain_ms=time_ms(lambda: ell_relax_csr_ref(dist, *csr, row_base=base),
                         PLAIN_REPS),
        library_ms=time_ms(lambda: own.scatter_reduce(
            0, dst, dist[src] + csr[2], "amin"), PLAIN_REPS),
        bound_ms=b, bound_by=by, group=lane_group(loc_n, m),
        launches=launches["ell_relax"])
    lines.append(dict(kernel_mode="ell_relax", partition_s=part_s["sparse"],
                      **out["ell_relax"]))

    # frontier_relax, explicit labels: sparse-4M as before, then hub-1M
    for key, name, label in (("frontier_relax", "sparse", "sparse-4M"),
                             ("frontier_relax_hub", "hub", "hub-1M")):
        parts, ops = blocks[name]
        out[key] = label_push_line(
            parts, ops, device, rng,
            f"block {MODE_BLOCK} of {label} / {MODE_NPROCS}: "
            f"n_pad={parts.n_pad} loc_n={parts.loc_n} "
            f"nnz_max={parts.nnz_max}",
            launches["frontier_relax"])
        if key == "frontier_relax":
            out[key]["earlier_ms"] = LABEL_PUSH_EARLIER_MS
        lines.append(dict(kernel_mode=key, partition_s=part_s[name],
                          **out[key]))

    # duplicate ids and sentinel runs across the tile edges: bitwise only
    parts, ops = blocks["sparse"]
    fids, flab = label_edge_frontier(parts, device, rng)
    label_push_check(ops, fids, flab, mixed_dist(parts.loc_n, rng, device),
                     "duplicate ids and sentinel runs")
    lines.append(dict(
        kernel_mode="frontier_relax_tile_edges", mode="explicit_labels",
        shape=f"block {MODE_BLOCK} of sparse-4M / {MODE_NPROCS}: "
              f"F={fids.numel()}, every fifth id and each tile edge's id "
              f"twice, sentinel runs of 31 and 33",
        bitwise_equal_plain=True, design=LABEL_PUSH_DESIGN))
    return out, lines


DRIVER_RUNS = (
    ("sssp_serve", ("--smoke",)),
    ("sssp_serve", ("--verify", "--verify-engine", "frontier_kernel")),
    ("sssp_serve", ("--chaos", "--smoke")),
    ("sssp_dynamic", ("--smoke",)),
)


def follower_launches(sg) -> dict:
    """The kernel launches of a serving group's followers (ranks 1..P-1),
    summed by kernel, through its ``STATS`` command."""
    total: dict = {}
    for r in sg.stats()[1:]:
        for k, v in r["launches"].items():
            total[k] = total.get(k, 0) + v
    return total


def sharded_serve_phase(big: dict, small: dict, device, wrappers: dict,
                        lines: list) -> dict:
    """Sharded serving on the card: a serving group of
    :data:`SHARDED_SERVE_P` gloo ranks sharing it (this process the
    leader, the others spawned; gloo carries their CUDA tensors), its
    ``GraphRegistry`` holding ``big`` (name -> CsrGraph, at or above the
    shard threshold: staged as one block a rank) and ``small`` (below it:
    served single-device), one scheduler replaying the serve phase's Zipf
    (seed 0) and point-to-point (seed 1) traces over both in open loop,
    then :data:`SHARDED_SERVE_LONE_P2P` lone p2p queries on ``big`` (the
    sharded ``frontier_sharded`` full solve, through ``frontier_relax`` on
    every rank).  Every exact answer is held bitwise to a fresh
    ``frontier_kernel`` row, one source of ``big`` to scipy.  Then
    ``sssp_serve --smoke`` on the same kind of ranks.  One
    ``{"sharded_serve": ...}`` line a trace; returns the followers' kernel
    launches of the phase (the leader's are in ``wrappers``)."""
    import numpy as np

    from repro_torch.core._dist import open_serving_group
    from repro_torch.launch import sssp_serve
    from repro_torch.launch.sssp_serve import Verifier, replay
    from repro_torch.serve import (DispatchPolicy, DistanceCache,
                                   GraphRegistry, LatencyRecorder,
                                   MicroBatchScheduler, TraceEvent,
                                   make_trace)

    (bname, bcg), = big.items()
    graphs = {**big, **small}
    sizes = [(name, cg.n) for name, cg in graphs.items()]
    traces = {"zipf": make_trace("zipf", sizes,
                                 num_queries=SHARDED_SERVE_QUERIES,
                                 rate=SERVE_RATE, seed=0),
              "p2p": make_trace("p2p", sizes,
                                num_queries=SHARDED_SERVE_QUERIES,
                                rate=SERVE_RATE, seed=1)}
    sg = open_serving_group(SHARDED_SERVE_P, device=device, shared=True)
    where = f"{SHARDED_SERVE_P} gloo ranks sharing {device}"
    try:
        before = follower_launches(sg)
        policy = DispatchPolicy(shard_threshold=SHARDED_SERVE_THRESHOLD,
                                device=device, group=sg)
        registry = GraphRegistry(device=device, group=sg)
        for name, cg in graphs.items():
            registry.register(name, cg)
        check(policy.choose(registry.get(bname), kind="batch").sharded
              and not any(policy.choose(registry.get(n)).sharded
                          for n in small),
              "the threshold does not split the graphs")
        h = registry.get(bname)
        t0 = time.perf_counter()
        h.partition_ops(sg.size)
        stage_s = time.perf_counter() - t0
        per_rank = [r["staged_bytes"] for r in sg.stats()]
        cache = DistanceCache(capacity=SERVE_CACHE_ROWS)
        sched = MicroBatchScheduler(registry, cache,
                                    max_batch=SERVE_MAX_BATCH,
                                    dispatch=policy)
        verify = Verifier(registry, reference="frontier_kernel",
                          device=device)

        def frontier_edges(sources) -> float:
            """``frontier_kernel``'s edges_relaxed a source, its launches
            taken back out (a yardstick, not serving)."""
            counts = launch_counts(wrappers)
            edges = [run_engine(bcg, int(v), "frontier_kernel",
                                device)[0].edges_relaxed for v in sources]
            for k, fn in wrappers.items():
                fn.launches = counts[k]
            return sum(edges) / len(edges)

        def serve(label, events, extra=None):
            s0, coll0 = sched.stats(), sg.group.collectives
            exact0 = verify.exact
            answers, wall, paused = replay(sched, events, verify)
            s1 = sched.stats()
            rec = LatencyRecorder()
            for a in answers:
                rec.observe(a, a.done_at)
            d = {k: s1[k] - s0[k] for k in (
                "sharded_batches", "sharded_p2p", "sharded_sources",
                "sharded_edges", "engine_batches", "target_solves")}
            srcs = sorted({a.query.source for a in answers
                           if a.query.graph == bname})[:4]
            lines.append(dict(
                sharded_serve=label, ranks=where, backend=sg.backend,
                P=sg.size, graph=bname, n=bcg.n, m=bcg.nnz,
                single_device=list(small), queries=len(answers), **d,
                edges_per_source=(d["sharded_edges"] / d["sharded_sources"]
                                  if d["sharded_sources"] else None),
                frontier_edges_per_source=frontier_edges(srcs),
                wall_s=wall, verify_s=paused, latency=rec.summary(),
                answered_via={k: v - s0["answered_via"][k]
                              for k, v in s1["answered_via"].items()
                              if v > s0["answered_via"][k]},
                exact_checked=verify.exact - exact0,
                staged_bytes_per_rank=per_rank,
                stage_s=stage_s, collectives=sg.group.collectives - coll0,
                group_start_s=sg.start_s, **(extra or {})))
            return answers

        for trace, events in traces.items():
            serve(trace, events)
        # lone p2p queries on the sharded graph: an idle scheduler solves
        # each one alone, frontier_sharded to its full fixpoint
        cached = {k[-1] for k in cache.keys_for(bname)}
        cands = [v for v in range(7, bcg.n, bcg.n // 64) if v not in cached]
        for src in cands[:SHARDED_SERVE_LONE_P2P]:
            answers = serve("p2p_residue", [TraceEvent(
                0.0, bname, src, (src * 7919) % bcg.n)])
            check([a.via for a in answers] == ["target"],
                  f"lone sharded p2p answered via {answers[0].via}")
        totals = {k: sched.stats()[k] for k in ("sharded_batches",
                                                "sharded_p2p")}
        check(totals["sharded_batches"] >= 2 and totals["sharded_p2p"] >= 4,
              f"sharded serving ran {totals}")
        version, src, cg = verify.first[bname]
        rel = check_oracle(f"sharded serve {bname} source {src}",
                           verify.rows[bname, version, src],
                           oracle(cg, [src]))
        lines.append(dict(oracle="scipy.sparse.csgraph.dijkstra",
                          graph=f"{bname} (sharded serve)", source=src,
                          max_rel_err=rel))
        after = follower_launches(sg)
        check(sg.broken is None, f"serving group: {sg.broken}")
    finally:
        sg.close()
    followers = {k: after.get(k, 0) - before.get(k, 0) for k in wrappers}
    argv = ["--smoke", "--devices", str(SHARDED_SERVE_P),
            "--shard-threshold", "128", "--shared-card", "--device",
            str(device)]
    report, wall = timed(lambda: sssp_serve.main(argv))
    check(all(r["sharded_sources"] > 0 for r in report.values()),
          "sssp_serve --devices did not shard")
    lines.append(dict(driver=f"sssp_serve {' '.join(argv)}", wall_s=wall,
                      scenarios={scen: {k: r[k] for k in (
                          "queries", "verified_rows", "exact_checked",
                          "sharded_batches", "sharded_p2p",
                          "sharded_sources")} for scen, r in report.items()}))
    return followers


def drivers_phase(device, wrappers: dict, lines: list) -> None:
    """The serving drivers on the card, in process, each with ``--device
    cuda``: every run of :data:`DRIVER_RUNS`; a mismatch exits the run
    (``SystemExit``), which fails the run.  One ``{"driver": ...}`` line a
    run: its wall, per scenario p50 / p99 / queries per second (where the
    run keeps a wall clock), answers by path, rows checked, and the kernel
    launches of the run (the drivers' verifiers take their reference
    solves' launches back out)."""
    import importlib

    for module, argv in DRIVER_RUNS:
        main = importlib.import_module(f"repro_torch.launch.{module}").main
        args = [*argv, "--device", str(device)]
        before = launch_counts(wrappers)
        report, wall = timed(lambda: main(args))
        line = dict(driver=f"{module} {' '.join(argv)}", wall_s=wall,
                    launches=launches_since(wrappers, before))
        if "answers" in report and isinstance(report["answers"], list):
            line |= {k: v for k, v in report.items() if k != "answers"}
            line["answers"] = len(report["answers"])
        elif module == "sssp_serve":
            line["scenarios"] = {
                scen: {k: r[k] for k in (
                    "queries", "p50_ms", "p99_ms", "qps", "answered_via",
                    "verified_rows", "exact_checked", "oracle_max_rel_err")
                    if k in r} for scen, r in report.items()}
        else:
            line |= report
        lines.append(line)


def tune_phase(handles: dict, device, wrappers: dict, lines: list) -> None:
    """Self-tuning on the card: calibrate over the full grid at one device
    (``repro_torch.tune.calibrate``; the file goes to the ignored
    ``build/``), fit the model, and race ``engine="auto"`` under the
    threshold policy and ``TunedPolicy(device=cuda)`` on tune_bench's full
    legs with a CostLog installed.  Hard checks: the two policies' answers
    bitwise equal on every leg, the model routed at least one leg, every
    engine a policy chose launched its kernel in that leg's window, and the
    race's own cost records replay green against the fresh model
    (``replay_records``, same backend).  The bench's ``gate_tune`` verdict
    is printed as a measurement.  Then the registry's large handles
    (``handles``: name -> GraphHandle) routed through the tuned policy: both
    lie outside the calibrated support, so the thresholds decide there.
    Appends one ``{"tune": ...}`` line."""
    import torch

    from repro_torch.benchmarks import tune_bench
    from repro_torch.obs import CostLog, backend_name, set_cost_log
    from repro_torch.tune import (TunedPolicy, calibrate, load_model,
                                  replay_records)

    path = Path(__file__).resolve().parent / "build" / "CALIBRATION_torch.json"
    path.parent.mkdir(exist_ok=True)
    _, cal_wall = timed(lambda: calibrate.run(device=device, out=str(path),
                                              verbose=False))
    model = load_model(str(path))
    backend = backend_name(device)
    check(model.meta.get("backend") == backend,
          f"tune: calibration stamped {model.meta.get('backend')!r}")
    log = CostLog()
    prev = set_cost_log(log)
    rows, routed, legs = [], 0, []
    try:
        for leg in tune_bench.FULL_LEGS:
            before = launch_counts(wrappers)
            (leg_rows, leg_routed), _ = timed(
                lambda: tune_bench.race(model, [leg], device=device,
                                        verbose=False))
            moved = launches_since(wrappers, before)
            row = leg_rows[0]
            for pol in ("base", "tuned"):
                kernel = KERNEL_OF.get(row[pol]["engine"])
                check(torch.device(device).type != "cuda"
                      or (kernel is not None and moved.get(kernel, 0) > 0),
                      f"tune {leg}: {pol} chose {row[pol]['engine']}, "
                      f"launched {moved}")
            check(row["agrees_bitwise"],
                  f"tune {leg}: tuned and threshold answers differ")
            rows += leg_rows
            routed += leg_routed
            legs.append(dict(corpus=row["corpus"], n=row["n"], m=row["m"],
                             base=row["base"], tuned=row["tuned"],
                             ratio=row["ratio"],
                             identical_choice=row["identical_choice"],
                             launches=moved))
    finally:
        set_cost_log(prev)
    check(routed >= 1, "tune: the model routed no leg")
    gate = tune_bench._gate_tune(rows, smoke=False, model_routed=routed)
    rep = replay_records([r.to_dict() for r in log.records], model,
                         expect_backend=backend)
    check(rep["pass"], f"tune: replay of the race's cost log failed "
                       f"{rep['failures']} {rep['skipped']}")
    policy = TunedPolicy(model, nprocs=1, device=device)
    routes = {}
    for name, h in handles.items():
        ch = policy.choose(h, kind="single")
        routes[name] = dict(engine=ch.engine, via=ch.via, n=h.n, m=h.m)
    lines.append({"tune": dict(
        calibration_s=cal_wall, fitted_points=model.coverage()["records"],
        coverage=model.coverage(), legs=legs, model_routed=routed,
        gate_tune_pass=gate["pass"], replay=dict(
            replayed=rep["replayed"], engines=rep["engines"],
            skipped=rep["skipped"]),
        large_graphs=routes)})


#: the pipeline example's two runs: at n = 100,000 (m = 3n) every CSR
#: engine, the sharded ones on an NCCL group of one; the engines that hold
#: the n × n matrix stop at its DENSE_CAP (40 GB and minutes of Alg. 2
#: here), so a second run at n = 2000 (Table I's largest) drives them,
#: relax_matvec with them
PIPELINE_RUNS = ((100_000, 300_000), (2000, 6000))
#: the quick benches' P-rank sweeps, cut here: (module, constant, the
#: slice of it kept).  Every P-rank leg starts sssp_run afresh (≈ 7 s of
#: process start on the card machine's host), and Table III's n = 1000
#: legs hold Alg. 2 on 8 gloo ranks for ≈ 20 s a solve, so the quick run's
#: 30 legs take ≈ 20 min there.  Kept: P = 1 and 2 of Table IV and of weak
#: scaling (each efficiency a real ratio), Table IV for ``bellman_sharded``
#: only (``dijkstra_sharded``'s P = 2 leg, an all-reduce a vertex on gloo,
#: is the slowest; Alg. 2 still runs at dense-2000 in the sharded phase),
#: weak scaling for ``frontier_sharded`` only, and
#: Table III's (100, 300) leg; the tables' full numbers come from
#: ``benchmarks.run`` on its own (PERF.md §5)
PAPER_CUTS = (("table3_density", "PAIRS", slice(2, 3)),
              ("table4_scaling", "PROCS", slice(0, 2)),
              ("table4_scaling", "ENGINES", slice(1, 2)),
              ("weak_scaling", "PROCS", slice(0, 2)),
              ("weak_scaling", "ENGINES", slice(3, 4)))
#: the paper benches' CSVs: (file, its time columns)
PAPER_CSVS = {
    "table2_sparse_csr.csv": ("bellman_s", "bellman_csr_s"),
    "table3_density.csv": ("serial_s", "mpi8_s", "bellman_s"),
    "table4_scaling.csv": ("time_s",),
    "fig23_size_sweep.csv": ("serial_s", "bellman_s"),
    "multisource_amortization.csv": ("total_s", "per_source_s"),
    "weak_scaling.csv": ("time_s",),
}


def paper_phase(device, wrappers: dict, lines: list) -> None:
    """The paper's tables and the SSSP examples from the port, on the card:
    ``quickstart``; ``sssp_pipeline`` for each of :data:`PIPELINE_RUNS`
    (every engine within ``VERIFY_RTOL`` of scipy, and ``ell_relax``,
    ``frontier_relax``, ``bucket_relax`` and ``relax_matvec`` launched by
    the two runs); ``sssp_dynamic_demo`` and ``sssp_serve_demo`` (their
    own bitwise checks against ``serial``); then ``benchmarks.run --quick
    --ranks-device cpu`` (the MPI columns on gloo ranks on the host, the
    rest on the card; the sweeps cut by :data:`PAPER_CUTS`) and
    ``table2_sparse_csr --quick`` into a temporary CSV directory, every
    row of every CSV with finite times.  A failed
    example or bench fails the run.  Appends one ``{"paper": ...}`` line:
    seconds by step, Table III's times at its largest n run, the
    efficiencies of Table IV and weak scaling at P > 1 (P = 1 is their
    base, 100 by construction), the pipelines' launches and walls."""
    import csv
    import importlib
    import math
    import tempfile

    from repro_torch.benchmarks import common
    from repro_torch.benchmarks import run as paper_run
    from repro_torch.benchmarks import table2_sparse_csr
    from repro_torch.examples import (quickstart, sssp_dynamic_demo,
                                      sssp_pipeline, sssp_serve_demo)
    from repro_torch.launch.sssp_run import VERIFY_RTOL

    dev = str(device)
    secs = {}
    _, secs["quickstart"] = timed(lambda: quickstart.main(["--device", dev]))
    before = launch_counts(wrappers)
    pipelines = []
    for n, m in PIPELINE_RUNS:
        summary, wall = timed(lambda: sssp_pipeline.main(
            ["--nodes", str(n), "--edges", str(m), "--device", dev]))
        secs[f"sssp_pipeline_{n}"] = wall
        for engine, r in summary["engines"].items():
            check(r["max_rel_err"] <= VERIFY_RTOL,
                  f"pipeline n={n} {engine}: relative error "
                  f"{r['max_rel_err']} > {VERIFY_RTOL}")
        pipelines.append(dict(
            n=n, m=m, nnz=summary["nnz"], skipped=sorted(summary["skipped"]),
            walls={e: r["time_s"] for e, r in summary["engines"].items()},
            max_rel_err=max(r["max_rel_err"]
                            for r in summary["engines"].values())))
    moved = launches_since(wrappers, before)
    for k in ("ell_relax", "frontier_relax", "bucket_relax", "relax_matvec"):
        check(moved.get(k, 0) > 0, f"{k} was not launched by sssp_pipeline")
    _, secs["sssp_dynamic_demo"] = timed(
        lambda: sssp_dynamic_demo.main(["--device", dev]))
    _, secs["sssp_serve_demo"] = timed(
        lambda: sssp_serve_demo.main(["--device", dev]))
    prev = [(common, "OUT_DIR", common.OUT_DIR)]
    kept = {}
    for mod_name, name, keep in PAPER_CUTS:
        mod = importlib.import_module(f"repro_torch.benchmarks.{mod_name}")
        prev.append((mod, name, getattr(mod, name)))
        setattr(mod, name, getattr(mod, name)[keep])
        kept[f"{mod_name}.{name}"] = list(getattr(mod, name))
    with tempfile.TemporaryDirectory() as out_dir:
        common.OUT_DIR = out_dir
        try:
            rc, secs["run_quick"] = timed(lambda: paper_run.main(
                ["--quick", "--device", dev, "--ranks-device", "cpu"]))
            check(rc == 0, f"benchmarks.run --quick exited {rc}")
            _, secs["table2_quick"] = timed(
                lambda: table2_sparse_csr.run(True, device=dev))
            tables = {}
            for name, cols in PAPER_CSVS.items():
                with open(Path(out_dir) / name) as f:
                    rows = list(csv.DictReader(f))
                check(bool(rows), f"{name}: no rows")
                for row in rows:
                    for c in cols:
                        check(math.isfinite(float(row[c])),
                              f"{name}: {c} = {row[c]!r} in {row}")
                tables[name] = rows
        finally:
            for mod, name, value in prev:
                setattr(mod, name, value)
    t3 = tables["table3_density.csv"]
    top = max(int(r["nodes"]) for r in t3)
    lines.append({"paper": dict(
        seconds=secs, phase_s=sum(secs.values()),
        kept=kept,
        table3_largest_n=[
            {k: float(r[k]) if k.endswith("_s") else int(r[k])
             for k in r} for r in t3 if int(r["nodes"]) == top],
        table3_columns=dict(serial_s=dev, bellman_s=dev,
                            mpi8_s="8 gloo ranks on the host"),
        table4_efficiency_pct={
            f"{r['engine']}@{r['procs']}": float(r["efficiency_pct"])
            for r in tables["table4_scaling.csv"] if int(r["procs"]) > 1},
        weak_efficiency_pct={
            f"{r['engine']}@{r['procs']}": float(r["weak_efficiency_pct"])
            for r in tables["weak_scaling.csv"] if int(r["procs"]) > 1},
        pipelines=pipelines, pipeline_launches=moved)})


#: the LM phase: gemma2-2b (serve_batch's default arch) at full width,
#: served at the JAX driver's defaults; a prompt past its 4096-token window
#: (so attention runs in 512-query chunks); the f32 checks' bound (JAX's
#: decode == forward bound, tests/test_models.py:95) and the smoke configs
#: held CUDA against CPU
LM_ARCH = "gemma2-2b"
LM_SERVE = dict(requests=8, batch=4, prompt_len=32, gen=16)
LM_LONG_PROMPT = 8192
LM_LONG_GEN = 16
LM_F32_TOL = 2e-3
LM_CPU_ARCHS = ("gemma2-2b", "seamless-m4t-medium", "qwen2-moe-a2.7b",
                "kimi-k2-1t-a32b", "mamba2-130m", "zamba2-2.7b")
LM_CPU_TOL = 1e-4
LM_REPS = 10
#: the MoE and Mamba2 LMs at full width (served as gemma2-2b is; zamba2,
#: a long-context arch, also over the 8192-token prompt), and the training
#: run: mamba2-130m at full width through the training driver, the run
#: crashed at step 12 and restarted from its step-10 checkpoint, whose
#: steps 10-19 must replay the clean run's within JAX's restart bound
#: (tests/test_integration.py:108)
LM_MOE_ARCH = "qwen2-moe-a2.7b"
LM_SSM_ARCH = "zamba2-2.7b"
LM_SSM_DRIVER_ARCH = "mamba2-130m"
LM_TRAIN = dict(arch="mamba2-130m", steps=20, batch=8, seq=512,
                ckpt_every=5, fail_at=12)
LM_RESTART_RTOL = 1e-6
LM_TRAIN_REPS = 3


def event_call(fn) -> tuple:
    """``fn()`` and its time in ms by CUDA events, host launch gaps
    included (no spin: a step that waits on the host shows it)."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def host_call(fn) -> tuple:
    """``fn()`` and its time in ms by the host clock (a CPU rank's)."""
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def event_ms(fn, reps: int) -> float:
    """Median of ``event_call(fn)``'s times over ``reps`` calls after one
    warm-up call."""
    fn()
    return statistics.median(event_call(fn)[1] for _ in range(reps))


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return [tree]


def tree_to(tree, device):
    """A parameter tree moved to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, device) for v in tree]
    return tree.to(device)


def lm_teacher_forced(T, params, tokens, cfg, extras, cache_dtype) -> tuple:
    """Prefill the first half of ``tokens`` and decode the rest teacher
    forced: (the prefill's and every step's logits, the forward pass's
    logits at the same positions, its hidden states)."""
    import torch

    x, _, _ = T.forward(params, tokens, cfg, **extras)
    full = T.logits_from_hidden(params, x, cfg)
    half = tokens.shape[1] // 2
    logits, caches, pos = T.prefill(params, tokens[:, :half], cfg,
                                    max_len=tokens.shape[1],
                                    cache_dtype=cache_dtype, **extras)
    steps = [logits]
    dkw = ({"image_embeds": extras["image_embeds"]}
           if "image_embeds" in extras else {})
    for t in range(half, tokens.shape[1]):
        logits, caches, pos = T.decode_step(params, tokens[:, t:t + 1], pos,
                                            caches, cfg, **dkw)
        steps.append(logits)
    return torch.stack(steps, 1), full[:, half - 1:], x


def lm_serve_record(S, T, params, cfg, rng, peak) -> dict:
    """``cfg``'s parameters served through ``repro_torch.launch.serve.
    serve`` at the JAX driver's defaults (:data:`LM_SERVE`): every logit
    finite and every token in range, ``peak()`` read after the loop; then
    a prefill of the first batch and a decode step after it, each timed by
    CUDA events after a warm-up (the host's launch gaps included) and
    profiled once (device busy time, the top ops)."""
    import numpy as np
    import torch

    sv = LM_SERVE
    queue = S.make_queue(cfg, sv["requests"], sv["prompt_len"], rng)
    bad = []

    def on_logits(bi, step, logits):
        if not torch.isfinite(logits).all():
            bad.append((bi, step))

    summary = S.serve(params, cfg, queue, batch=sv["batch"], gen=sv["gen"],
                      max_len=sv["prompt_len"] + sv["gen"],
                      on_logits=on_logits)
    check(not bad, f"{cfg.name}: non-finite logits at (batch, step) "
          f"{bad[:4]}")
    ids = np.array([r.generated for r in queue])
    check(ids.shape == (sv["requests"], sv["gen"])
          and ((ids >= 0) & (ids < cfg.vocab_size)).all(),
          f"{cfg.name}: served tokens out of range or missing: shape "
          f"{ids.shape}")
    device = params["embed"]["tok"].device
    rec = dict(
        params=sum(t.numel() for t in tree_leaves(params)),
        param_count=cfg.param_count(),
        param_bytes=sum(t.numel() * t.element_size()
                        for t in tree_leaves(params)),
        **sv, tokens=summary["tokens"], wall_s=summary["wall_s"],
        tokens_per_s=summary["tokens_per_s"],
        batch_latency_s=summary["batch_latency_s"],
        prefill_s=summary["prefill_s"],
        decode_step_s_median=statistics.median(summary["decode_step_s"]),
        peak_bytes=peak())
    toks = torch.from_numpy(np.stack(
        [r.prompt for r in queue[:sv["batch"]]])).to(device)
    max_len = sv["prompt_len"] + sv["gen"]
    _, caches, pos = T.prefill(params, toks, cfg, max_len=max_len)
    nxt = toks[:, -1:]
    prefill = lambda: T.prefill(params, toks, cfg, max_len=max_len)
    step = lambda: T.decode_step(params, nxt, pos, caches, cfg)
    rec.update(prefill_ms=event_ms(prefill, LM_REPS),
               prefill_profile=profile_call(prefill),
               decode_ms=event_ms(step, LM_REPS),
               decode_profile=profile_call(step),
               first_tokens=ids[:, :4].tolist())
    return rec


def lm_long_record(T, params, cfg, rng) -> tuple:
    """One :data:`LM_LONG_PROMPT`-token prompt (batch 1), its prefill timed
    and profiled, then :data:`LM_LONG_GEN` greedy decode steps, each
    timed, every logit finite.  Returns (the record, the prompt)."""
    import torch

    device = params["embed"]["tok"].device
    S_long = LM_LONG_PROMPT
    long_toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (1, S_long))).to(device)
    max_len = S_long + LM_LONG_GEN
    long_prefill = lambda: T.prefill(params, long_toks, cfg, max_len=max_len)
    prefill_ms = event_ms(long_prefill, 2)
    prefill_profile = profile_call(long_prefill)
    logits, caches, pos = T.prefill(params, long_toks, cfg, max_len=max_len)
    steps_ms = []
    for _ in range(LM_LONG_GEN):
        nxt = torch.argmax(logits, -1)[:, None]
        (logits, caches, pos), ms = event_call(
            lambda: T.decode_step(params, nxt, pos, caches, cfg))
        steps_ms.append(ms)
        check(bool(torch.isfinite(logits).all()),
              f"{cfg.name}: non-finite logits decoding the long prompt")
    return dict(prompt=S_long, gen=LM_LONG_GEN,
                q_chunk=T._auto_q_chunk(S_long), prefill_ms=prefill_ms,
                prefill_profile=prefill_profile,
                decode_ms_median=statistics.median(steps_ms),
                decode_ms_first_last=[steps_ms[0], steps_ms[-1]]), long_toks


class RouteLog:
    """Wraps ``repro_torch.models.moe.route`` while it is installed: the
    highest expert id routed to, and each call's dropped assignments (one
    call a MoE layer)."""

    def __init__(self, moe):
        self.moe, self.route = moe, moe.route
        self.max_id, self.drops, self.calls = -1, [], []

    def __call__(self, router, xt, cfg, C):
        r = self.route(router, xt, cfg, C)
        self.max_id = max(self.max_id, int(r["ids"].max()))
        self.drops.append(int((~r["keep"]).sum()))
        self.calls.append((int(xt.shape[0] * xt.shape[1]), C))
        return r

    def __enter__(self):
        self.moe.route = self
        return self

    def __exit__(self, *exc):
        self.moe.route = self.route


def lm_moe_serve(device, lines: list, rng) -> None:
    """qwen2-moe at full width in bf16 (64 experts, 4 of them dead padding;
    random parameters drawn on the card) served as gemma2-2b is, no
    assignment routed to a dead expert, and the assignments dropped at
    capacity in a prefill of the first batch counted layer by layer."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import moe as M
    from repro_torch.models import transformer as T

    cfg = get_config(LM_MOE_ARCH)
    base = torch.cuda.memory_allocated(device)
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    peak = lambda: torch.cuda.max_memory_allocated(device) - base
    with RouteLog(M) as log:
        rec = lm_serve_record(S, T, params, cfg, rng, peak)
        log.drops, log.calls = [], []
        toks = torch.from_numpy(rng.integers(
            0, cfg.vocab_size, (LM_SERVE["batch"], LM_SERVE["prompt_len"])
        )).to(device)
        T.prefill(params, toks, cfg, max_len=LM_SERVE["prompt_len"] + 1)
    check(log.max_id < cfg.num_experts,
          f"{cfg.name}: expert {log.max_id} routed to, but experts "
          f"{cfg.num_experts}..{M._padded_experts(cfg) - 1} are dead")
    lines.append({"lm": dict(
        part="moe_serve", arch=cfg.name, dtype=cfg.param_dtype,
        experts=cfg.num_experts, padded_experts=M._padded_experts(cfg),
        top_k=cfg.moe_top_k, init_s=init_s, max_expert_id=log.max_id,
        prefill_tokens=log.calls[0][0], capacity=log.calls[0][1],
        prefill_dropped_by_layer=log.drops,
        prefill_dropped=sum(log.drops),
        prefill_assignments=len(log.drops) * log.calls[0][0] * cfg.moe_top_k,
        **rec)})
    del params
    torch.cuda.empty_cache()


def lm_ssm_serve(device, lines: list, rng) -> None:
    """zamba2 at full width in bf16 served as gemma2-2b is, then over one
    :data:`LM_LONG_PROMPT`-token prompt (32 SSD chunks of 256 a Mamba2
    layer, the shared attention block in 512-query chunks); then the serve
    driver's entry point, ``repro_torch.launch.serve.main`` with ``--arch
    mamba2-130m --device cuda``, in process, at its defaults and full
    width."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T

    cfg = get_config(LM_SSM_ARCH)
    base = torch.cuda.memory_allocated(device)
    peak = lambda: torch.cuda.max_memory_allocated(device) - base
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    rec = lm_serve_record(S, T, params, cfg, rng, peak)
    torch.cuda.reset_peak_memory_stats(device)
    long, _ = lm_long_record(T, params, cfg, rng)
    long["peak_bytes"] = peak()
    del params
    torch.cuda.empty_cache()
    argv = ["--arch", LM_SSM_DRIVER_ARCH, "--device", str(device)]
    drv, drv_s = timed(lambda: S.main(argv))
    torch.cuda.empty_cache()
    check(drv["tokens"] == LM_SERVE["requests"] * LM_SERVE["gen"],
          f"serve {' '.join(argv)}: {drv['tokens']} tokens")
    lines.append({"lm": dict(
        part="ssm_serve", arch=cfg.name, dtype=cfg.param_dtype,
        ssm_chunk=cfg.ssm_chunk, init_s=init_s, **rec,
        long_prompt=long, driver=dict(
            arch=LM_SSM_DRIVER_ARCH, argv=f"{' '.join(argv)} (defaults)",
            wall_s=drv_s, tokens=drv["tokens"],
            tokens_per_s=drv["tokens_per_s"]))})


def _train_start(argv, ckpt_dir, **env) -> subprocess.Popen:
    """The training driver with ``argv`` into ``ckpt_dir``, started (with
    ``env`` added to its environment)."""
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *argv,
         "--ckpt-dir", ckpt_dir], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, REPRO_EMIT_LOSSES="1", **env,
                 PYTHONPATH=str(Path(__file__).resolve().parent / "src")))


def _train_end(proc: subprocess.Popen, t0: float):
    """Waits for a run from :func:`_train_start` (killed after 600 s):
    (the completed process, its losses or None, each logged step's ms,
    the seconds since ``t0``)."""
    try:
        out, err = proc.communicate(timeout=600)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    wall = time.perf_counter() - t0
    r = subprocess.CompletedProcess(proc.args, proc.returncode, out, err)
    losses = [json.loads(ln[len("LOSSES "):]) for ln in out.splitlines()
              if ln.startswith("LOSSES ")]
    step_ms = [float(m.group(1)) for m in re.finditer(
        r"^\[train\] step \d+ loss \S+ \((\d+) ms\)$", out, re.M)]
    return r, (losses[0] if losses else None), step_ms, wall


def lm_train(device, lines: list) -> None:
    """mamba2-130m at full width (bf16, remat ``full``) through the
    training driver, ``python -m repro_torch.launch.train --device cuda``:
    :data:`LM_TRAIN`'s steps with a checkpoint every 5 steps, the loss
    falling; beside it on the card a run crashed at step 12
    (``--simulate-failure-at``), which must exit non-zero, then that
    run's rerun, which must restore step 10
    and replay the clean run's steps 10-19 within :data:`LM_RESTART_RTOL`.
    Then, in process, the same state's step timed by CUDA events, its peak
    memory, and one step profiled."""
    import tempfile

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    tr = LM_TRAIN
    argv = ["--arch", tr["arch"], "--device", str(device), "--steps",
            str(tr["steps"]), "--batch", str(tr["batch"]), "--seq",
            str(tr["seq"]), "--ckpt-every", str(tr["ckpt_every"]),
            "--log-every", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        # the clean run and the run to be crashed side by side on the card;
        # the crashed run's restart starts when it has ended
        t0 = time.perf_counter()
        procs = [_train_start(argv, os.path.join(tmp, "a")),
                 _train_start(argv + ["--simulate-failure-at",
                                      str(tr["fail_at"])],
                              os.path.join(tmp, "b"))]
        try:
            crash, _, _, crash_s = _train_end(procs[1], t0)
            check(crash.returncode != 0
                  and "simulated node failure" in crash.stderr,
                  f"train: the crashed run exited {crash.returncode}")
            t1 = time.perf_counter()
            procs.append(_train_start(argv, os.path.join(tmp, "b")))
            clean, losses, step_ms, clean_s = _train_end(procs[0], t0)
            again, resumed, _, again_s = _train_end(procs[2], t1)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        check(clean.returncode == 0 and losses is not None,
              f"train: clean run failed: {clean.stderr[-2000:]}")
        check(again.returncode == 0 and resumed is not None,
              f"train: the restart failed: {again.stderr[-2000:]}")
    restored = re.search(r"restored step (\d+)", again.stdout)
    check(restored is not None and int(restored.group(1)) == 10,
          f"train: the restart did not restore step 10: {again.stdout[:300]}")
    check(np.isfinite(losses).all() and losses[-1] < losses[0],
          f"train: the loss did not fall: {losses}")
    clean_tail = np.array(losses[10:])
    rel = np.abs(np.array(resumed) - clean_tail) / np.abs(clean_tail)
    check(len(resumed) == len(clean_tail)
          and float(rel.max()) <= LM_RESTART_RTOL,
          f"train: steps 10-19 replayed off by {rel.max()} relative "
          f"(> {LM_RESTART_RTOL}): {resumed} vs {clean_tail.tolist()}")

    # in process: the step's time, peak memory and one profile
    cfg = get_config(tr["arch"])
    opt = OptConfig(lr=3e-4, warmup_steps=min(20, tr["steps"] // 5 + 1),
                    total_steps=tr["steps"])
    base = torch.cuda.memory_allocated(device)
    state = init_train_state(cfg, opt, torch.Generator(device).manual_seed(0),
                             device)
    pipe = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=tr["seq"],
        global_batch=tr["batch"], d_model=cfg.d_model))
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in pipe.batch_at(0).items()}
    step = make_train_step(cfg, opt)
    state, _ = step(state, batch)                       # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    times = []
    for _ in range(LM_TRAIN_REPS):
        (state, m), ms = event_call(lambda: step(state, batch))
        times.append(ms)
    peak_bytes = torch.cuda.max_memory_allocated(device) - base
    prof = profile_call(lambda: step(state, batch))
    step_med = statistics.median(times)
    lines.append({"lm": dict(
        part="train", **tr, dtype=cfg.param_dtype, remat=cfg.remat,
        loss_chunk=cfg.loss_chunk,
        params=sum(t.numel() for t in tree_leaves(state.params)),
        driver_wall_s=clean_s, crash_wall_s=crash_s, restart_wall_s=again_s,
        driver_beside="the crashed run, then its restart, on the same card",
        losses=losses, resumed_losses=resumed,
        restored_step=int(restored.group(1)),
        replay_max_rel_err=float(rel.max()),
        replay_bitwise=bool((np.array(resumed) == clean_tail).all()),
        driver_step_ms_median=(statistics.median(step_ms[1:])
                               if len(step_ms) > 1 else None),
        step_ms=step_med, step_ms_all=times,
        tokens_per_s=tr["batch"] * tr["seq"] / (step_med / 1e3),
        peak_bytes=peak_bytes, step_profile=prof,
        step_idle=idle_share(prof["busy_s"], prof["wall_s"]))})
    del state
    torch.cuda.empty_cache()


def lm_phase(device, lines: list, cfg=None) -> None:
    """The LMs on the card (no kernel of the port is on this path:
    attention is JAX's einsum + softcap + mask + softmax, the MoE, SSD and
    optimizer plain torch ops, none a Pallas kernel in JAX).

    1. ``cfg`` (gemma2-2b at full width, bf16, random parameters drawn on
       the card) served through ``repro_torch.launch.serve.serve`` at the
       JAX driver's defaults, every logit finite and every token in range;
       prefill and decode step timed by CUDA events after a warm-up (the
       host's launch gaps included), and once each under the profiler
       (device busy time, the top ops);
    2. one prompt of ``LM_LONG_PROMPT`` tokens (past the sliding window:
       512-query chunks), timed and profiled, then ``LM_LONG_GEN`` decode
       steps, timed, its peak memory;
    3. the same widths in f32 (f32 cache, no TF32): prefill + decode
       against the forward pass, and 512-query chunks against none over
       the last 16 positions of the long prompt, each within
       ``LM_F32_TOL``;
    4. the smoke configs of ``LM_CPU_ARCHS`` on CUDA against the CPU, f32:
       forward, logits, prefill and decode within ``LM_CPU_TOL``, and one
       ``train_loss`` gradient, each leaf's max error relative to its
       largest entry;
    5. qwen2-moe at full width (:func:`lm_moe_serve`);
    6. zamba2 at full width, its 8192-token prompt, and the serve driver
       on mamba2-130m (:func:`lm_ssm_serve`);
    7. mamba2-130m trained at full width through the training driver,
       crashed and restarted (:func:`lm_train`).
    """
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch import serve as S
    from repro_torch.models import transformer as T
    from repro_torch.train.step import value_and_grad

    check(torch.get_float32_matmul_precision() == "highest"
          and not torch.backends.cuda.matmul.allow_tf32,
          "f32 matmuls would run in TF32")
    cfg = cfg or get_config(LM_ARCH)
    base = torch.cuda.memory_allocated(device)
    peak = lambda: torch.cuda.max_memory_allocated(device) - base
    rng = np.random.default_rng(0)

    # 1. serve at full width, bf16
    t0 = time.perf_counter()
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats(device)
    lines.append({"lm": dict(
        part="serve", arch=cfg.name, dtype=cfg.param_dtype, init_s=init_s,
        **lm_serve_record(S, T, params, cfg, rng, peak))})

    # 2. a long prompt, past the window
    torch.cuda.reset_peak_memory_stats(device)
    long, long_toks = lm_long_record(T, params, cfg, rng)
    lines.append({"lm": dict(
        part="long_prompt", arch=cfg.name, dtype=cfg.param_dtype,
        window=cfg.sliding_window, **long, peak_bytes=peak())})
    del params
    torch.cuda.empty_cache()

    # 3. the same widths in f32
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    params = T.init_params(cfg32, torch.Generator(device).manual_seed(0),
                           device)
    torch.cuda.reset_peak_memory_stats(device)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                         (2, 32))).to(device)
    got, want, _ = lm_teacher_forced(T, params, toks, cfg32, {},
                                     torch.float32)
    dec_err = float((got - want).abs().max())
    check(dec_err < LM_F32_TOL,
          f"f32 prefill + decode vs forward: {dec_err} >= {LM_F32_TOL}")
    out = {}
    for qc in (0, 512):
        x, _, _ = T.forward(params, long_toks, cfg32, q_chunk=qc)
        out[qc] = T.logits_from_hidden(params, x[:, -16:], cfg32)
        del x
    chunk_err = float((out[0] - out[512]).abs().max())
    check(chunk_err < LM_F32_TOL,
          f"f32 q_chunk 512 vs 0: {chunk_err} >= {LM_F32_TOL}")
    lines.append({"lm": dict(
        part="f32_consistency", arch=cfg.name, dtype="float32",
        param_bytes=sum(t.numel() * t.element_size()
                        for t in tree_leaves(params)),
        decode_vs_forward_max_abs_err=dec_err,
        q_chunk_512_vs_0_max_abs_err=chunk_err, prompt=LM_LONG_PROMPT,
        tol=LM_F32_TOL, peak_bytes=peak())})
    del params, out
    torch.cuda.empty_cache()

    # 4. smoke configs, CUDA against CPU
    errs = {}
    for arch in LM_CPU_ARCHS:
        small = make_smoke(get_config(arch))
        host = T.init_params(small, torch.Generator().manual_seed(0), "cpu")
        card = tree_to(host, device)
        toks = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 16)))
        extras = S.make_extras(small, 2, 16, rng, "cpu")
        res = {}
        for dev, p in (("cpu", host), (device, card)):
            ex = {k: v.to(dev) for k, v in extras.items()}
            res[str(dev)] = lm_teacher_forced(T, p, toks.to(dev), small, ex,
                                              torch.float32)
        errs[arch] = {name: float((a.cpu() - b).abs().max())
                      for name, a, b in zip(("decode", "logits", "hidden"),
                                            res[str(device)], res["cpu"])}
        labels = torch.from_numpy(rng.integers(0, small.vocab_size, (2, 16)))
        grads = [value_and_grad(p, dict(tokens=toks.to(dev),
                                         labels=labels.to(dev),
                                         **{k: v.to(dev) for k, v in
                                            extras.items()}), small)[2]
                 for dev, p in (("cpu", host), (device, card))]
        errs[arch]["grad_rel"] = max(
            float((a - b.cpu()).abs().max()) / (float(a.abs().max()) + 1e-7)
            for a, b in zip(tree_leaves(grads[0]), tree_leaves(grads[1])))
        worst = max(errs[arch].values())
        check(worst <= LM_CPU_TOL,
              f"{arch} smoke, CUDA vs CPU: {errs[arch]} > {LM_CPU_TOL}")
    lines.append({"lm": dict(part="cuda_vs_cpu", archs=list(LM_CPU_ARCHS),
                             max_abs_err=errs, tol=LM_CPU_TOL)})

    # 5.-7. the MoE and Mamba2 LMs at full width, then training
    for part in (lm_moe_serve, lm_ssm_serve):
        t0 = time.perf_counter()
        part(device, lines, rng)
        lines.append({f"{part.__name__}_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    lm_train(device, lines)
    lines.append({"lm_train_s": time.perf_counter() - t0})


#: the mesh phase: gemma3-1b at full width trained on one rank (steps
#: 0-3, a checkpoint at step 2; batch 2 x seq 256: at seq 512 the phase
#: took 185 s of its 120 s, PERF.md §6), then restored from step 2 by the
#: training driver on a (data, model) = (1, 2) mesh of gloo ranks sharing
#: the card (each rank attends 2 of the 4 heads over the one KV head)
#: and trained on (steps 2-3), its losses within LM_MESH_RTOL relative of
#: the single rank's; gemma3-1b's bf16 gradients on that mesh held to the
#: f32 gradients of the same parameters (LM_MESH_GRAD); and one qwen2-moe
#: MoE layer at full width, the
#: expert-parallel path on the (1, 2) mesh against the grouped path on
#: one rank, in f32 within JAX's bounds (tests/test_integration.py:200)
#: and in bf16 within LM_MESH_BF16_ULPS roundings of the output
LM_MESH_ARCH = "gemma3-1b"
LM_MESH_TRAIN = dict(steps=4, batch=2, seq=256, ckpt_at=2, data=1, model=2)
LM_MESH_RTOL = 2e-2
LM_MESH_MOE = dict(arch="qwen2-moe-a2.7b", batch=4, seq=512, data=1,
                   model=2)
LM_MESH_EP_TOL = 2e-3
LM_MESH_AUX_TOL = 1e-4
#: the expert-parallel combine rounds twice more than the grouped one (the
#: rank's partial sum, then the all-reduce), each by at most 2 ** -8 of
#: the value: in bf16 the outputs may differ by that many roundings at the
#: output's largest magnitude
LM_MESH_BF16_ULPS = 2
LM_MESH_REPS = 5
#: the gradient check: gemma3-1b at full width, bf16, one batch.  In bf16
#: the mesh cannot match one rank (its partial sums round apart, and the
#: difference grows through the layers), so both are held to the f32
#: gradient of the same bf16-valued parameters: each leaf's error by
#: Frobenius norm relative to the f32 leaf's, the mesh's worst leaf within
#: ``factor`` times one rank's worst.  A gradient scaled by 2 reads about
#: 1 there, one missing a rank's partial sum 0.7-1.1, a sound mesh about
#: one rank's own reading (tests/test_torch_mesh_model.py)
LM_MESH_GRAD = dict(batch=2, seq=256, factor=2.0)
#: where the models' path on a mesh needed more than DTensor's own rules
#: (PERF.md §3)
LM_MESH_OPS = {
    "aten.mm.dtype / aten.bmm.dtype": "sharding strategy registered, "
    "mm's / bmm's (sharding/rules.py register_strategies)",
    "aten.gather (the gold logit of lm_loss)": "a masked sum over the "
    "vocab on a DTensor (models/transformer.py lm_loss)",
    "MoE routing (sort, argsort, scatter, gather)": "on each rank's block "
    "(to_local with named gradient placements; models/moe.py)",
}


def _grad_errors(grads, ref) -> list:
    """Each leaf's ||g - r|| / ||r|| (in f32, on the leaves' device)."""
    return [float((g.float() - r.float()).norm()
                  / r.float().norm().clamp_min(1e-30))
            for g, r in zip(grads, ref)]


def _mesh_grad_part(group, mesh, spec: dict) -> dict:
    """The gradient check on this rank (see :data:`LM_MESH_GRAD`): the
    parameters and batch drawn from the same seeds on every rank, the
    gradients on the mesh, then on rank 0 alone (the others waiting) one
    rank's bf16 gradients and the f32 ones of the same values."""
    import dataclasses

    import torch
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.tree import leaves, tree_map
    from repro_torch.sharding import rules
    from repro_torch.train.step import value_and_grad

    dev = group.device
    call = event_call if dev.type == "cuda" else host_call
    cfg = spec.get("grad_cfg") or get_config(LM_MESH_ARCH)
    g = spec["grad"]
    params = T.init_params(cfg, torch.Generator(dev).manual_seed(0), dev)
    tok = torch.randint(0, cfg.vocab_size, (g["batch"], g["seq"]),
                        generator=torch.Generator(dev).manual_seed(1),
                        device=dev)
    batch = {"tokens": tok, "labels": tok.roll(-1, 1)}
    rep = [Replicate()] * mesh.ndim
    dt = lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
    with rules.set_mesh(mesh):
        (loss_m, _, gm), mesh_ms = call(lambda: value_and_grad(
            tree_map(dt, params), {k: dt(v) for k, v in batch.items()},
            cfg))
    gm = [t.full_tensor() for t in leaves(gm)]
    loss_m = float(loss_m.full_tensor())
    if group.rank:
        dist.barrier()
        return {}
    shape = rules.AbstractMesh((spec["data"], spec["model"]),
                               ("data", "model"))
    with rules.set_mesh(shape):
        (loss_1, _, g1), one_ms = call(
            lambda: value_and_grad(params, batch, cfg))
        g1 = leaves(g1)
        c32 = dataclasses.replace(cfg, param_dtype="float32")
        loss_f, _, gf = value_and_grad(
            tree_map(lambda t: t.float(), params), batch, c32)
        gf = leaves(gf)
    dist.barrier()
    e_one, e_mesh = _grad_errors(g1, gf), _grad_errors(gm, gf)
    worst = max(range(len(gf)), key=lambda i: e_mesh[i])
    return dict(
        arch=LM_MESH_ARCH, **g, dtype=cfg.param_dtype, leaves=len(gf),
        loss_mesh=loss_m, loss_one_rank=float(loss_1),
        loss_f32=float(loss_f), one_rank_vs_f32_worst_leaf=max(e_one),
        mesh_vs_f32_worst_leaf=max(e_mesh),
        mesh_vs_one_rank_worst_leaf=max(_grad_errors(gm, g1)),
        mesh_worst_leaf_index=worst, one_rank_at_that_leaf=e_one[worst],
        finite=all(bool(torch.isfinite(t.float()).all()) for t in gm),
        mesh_ms=mesh_ms, one_rank_ms=one_ms)


def _mesh_rank(group, spec: dict) -> dict:
    """One rank of the mesh checks: the gradient check
    (:func:`_mesh_grad_part`), then the MoE layer's parameters and ``x``
    drawn from the same seeds on every rank; the expert-parallel path on
    the mesh against the grouped path on this rank alone, in f32 and in
    bf16, each timed by CUDA events."""
    import dataclasses

    import torch
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models.moe import init_moe, moe_ep, moe_gspmd
    from repro_torch.models.tree import tree_map
    from repro_torch.sharding import rules

    import torch.distributed as dist

    dev = group.device
    call = event_call if dev.type == "cuda" else host_call
    mesh = make_host_mesh(spec["data"], spec["model"],
                          device_type=dev.type)
    out = {"grad": _mesh_grad_part(group, mesh, spec)}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    base = spec.get("cfg") or get_config(spec["arch"])
    for dt in ("float32", "bfloat16"):
        cfg = dataclasses.replace(base, param_dtype=dt)
        p = init_moe(cfg, torch.Generator(dev).manual_seed(0), dev)
        x = torch.randn((spec["batch"], spec["seq"], cfg.d_model),
                        generator=torch.Generator(dev).manual_seed(1),
                        device=dev).to(getattr(torch, dt))
        rep = [Replicate()] * mesh.ndim
        dp = tree_map(lambda t: DTensor.from_local(t, mesh, rep,
                                                   run_check=False), p)
        dx = DTensor.from_local(x, mesh, rep, run_check=False)
        with torch.no_grad():
            with rules.set_mesh(mesh):
                ep = lambda: moe_ep(dp, dx, cfg, mesh)
                (o_e, a_e), _ = call(ep)
                with CommDebugMode() as comm:
                    ep()
                e_ms = [call(ep)[1] for _ in range(LM_MESH_REPS)]
            o_e, a_e = o_e.full_tensor(), a_e.full_tensor()
            # the grouped path on rank 0 alone, the other ranks waiting
            if group.rank:
                dist.barrier()
                continue
            (o_g, a_g), _ = call(lambda: moe_gspmd(p, x, cfg))
            g_ms = [call(lambda: moe_gspmd(p, x, cfg))[1]
                    for _ in range(LM_MESH_REPS)]
            dist.barrier()
            err = (o_e.float() - o_g.float()).abs()
            out[dt] = dict(
                max_abs_err=float(err.max()),
                max_err_over_out_max=float(err.max()
                                           / o_g.float().abs().max()),
                out_max=float(o_g.float().abs().max()),
                aux_ep=float(a_e), aux_grouped=float(a_g),
                aux_abs_err=abs(float(a_e) - float(a_g)),
                ep_ms=statistics.median(e_ms),
                grouped_one_rank_ms=statistics.median(g_ms),
                ep_collectives={str(k).rsplit(".", 1)[-1]: int(v) for k, v
                                in comm.get_comm_counts().items()},
                finite=bool(torch.isfinite(o_e.float()).all()))
    out["peak_bytes"] = (torch.cuda.max_memory_allocated(dev)
                         if dev.type == "cuda" else None)
    return out


def lm_mesh_phase(device, lines: list, card: str) -> None:
    """The mesh side of the LMs on the card (no kernel of the port is on
    this path).

    1. :data:`LM_MESH_ARCH` at full width (bf16, random parameters from
       seed 0) on one rank in this process, steps 0-3 as the training
       driver runs them (its seed, data, AdamW and checkpoint format), a
       checkpoint of step 2; then ``python -m repro_torch.launch.train
       --data-axis 1 --model-axis 2 --shared-card`` (two gloo ranks on
       the card, DTensor state) restores step 2 and trains steps 2-3, its
       losses within :data:`LM_MESH_RTOL` relative of the single rank's;
       its ``STEPSTATS`` line (``REPRO_STEP_STATS``) gives each step's
       time by CUDA events, the last step's collectives by kind and each
       rank's peak memory.
    2. On a second (1, 2) mesh of gloo ranks (:func:`_mesh_rank`):
       :data:`LM_MESH_ARCH`'s bf16 gradients at full width held to the f32
       ones (:data:`LM_MESH_GRAD`), and one :data:`LM_MESH_MOE` MoE layer
       at full width, expert-parallel against the grouped path.
    """
    import tempfile

    import numpy as np
    import torch

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs import get_config
    from repro_torch.core._dist import spawn
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.state import init_train_state, state_to_jax
    from repro_torch.train.step import make_train_step

    tr = LM_MESH_TRAIN
    argv = ["--arch", LM_MESH_ARCH, "--device", str(device), "--steps",
            str(tr["steps"]), "--batch", str(tr["batch"]), "--seq",
            str(tr["seq"]), "--log-every", "1"]
    shared = ["--shared-card"] if device.type == "cuda" else []
    with tempfile.TemporaryDirectory() as mesh_dir:
        # the single rank in process, as the driver runs it (its seed,
        # data, optimizer and checkpoint), the checkpoint at ckpt_at only
        t0 = time.perf_counter()
        cfg = get_config(LM_MESH_ARCH)
        opt = OptConfig(lr=3e-4, warmup_steps=min(20, tr["steps"] // 5 + 1),
                        total_steps=tr["steps"])
        state = init_train_state(cfg, opt,
                                 torch.Generator(device).manual_seed(0),
                                 device)
        pipe = SyntheticPipeline(DataConfig(
            vocab_size=cfg.vocab_size, seq_len=tr["seq"],
            global_batch=tr["batch"], seed=0, d_model=cfg.d_model))
        step = make_train_step(cfg, opt)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        losses, single_ms = [], []
        for i in range(tr["steps"]):
            if i == tr["ckpt_at"]:
                save_checkpoint(mesh_dir, state_to_jax(state, cfg), i,
                                {"step": i})
            batch = {k: torch.from_numpy(v).to(device)
                     for k, v in pipe.batch_at(i).items()}
            (state, m), ms = event_call(lambda: step(state, batch))
            losses.append(float(m["loss"]))
            single_ms.append(ms)
        single_peak = (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None)
        del state, m, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
        single_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        mesh, resumed, mesh_ms, mesh_s = _train_end(_train_start(
            argv + ["--ckpt-every", str(10 ** 6), "--data-axis",
                    str(tr["data"]), "--model-axis", str(tr["model"]),
                    *shared], mesh_dir, REPRO_STEP_STATS="1"), t1)
    check(mesh.returncode == 0 and resumed is not None,
          f"lm_mesh: the mesh run failed: {mesh.stderr[-3000:]}")
    restored = re.search(r"restored step (\d+)", mesh.stdout)
    check(restored is not None and int(restored.group(1)) == tr["ckpt_at"],
          f"lm_mesh: the mesh run did not restore step {tr['ckpt_at']}: "
          f"{mesh.stdout[:300]}")
    stats = [json.loads(ln[len("STEPSTATS "):])
             for ln in mesh.stdout.splitlines()
             if ln.startswith("STEPSTATS ")]
    want = np.array(losses[tr["ckpt_at"]:])
    rel = np.abs(np.array(resumed) - want) / np.abs(want)
    check(len(resumed) == len(want) and np.isfinite(resumed).all()
          and float(rel.max()) <= LM_MESH_RTOL,
          f"lm_mesh: mesh steps {tr['ckpt_at']}-{tr['steps'] - 1} off by "
          f"{rel.max()} relative (> {LM_MESH_RTOL}): {resumed} vs "
          f"{want.tolist()}")
    lines.append({"lm_mesh": dict(
        part="train_restore", arch=LM_MESH_ARCH, **tr, dtype="bfloat16",
        mesh_shape=[tr["data"], tr["model"]], ranks_share_card=True,
        backend="gloo", single_losses=losses, mesh_losses=resumed,
        restored_step=int(restored.group(1)), max_rel_err=float(rel.max()),
        rtol=LM_MESH_RTOL, single_wall_s=single_s, mesh_wall_s=mesh_s,
        single_step_ms=single_ms, single_peak_bytes=single_peak,
        mesh_step_ms_host=mesh_ms,
        mesh_step_stats=stats[0] if stats else None,
        ops_needing_more_than_dtensor=LM_MESH_OPS, card=card)})

    moe = LM_MESH_MOE
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        got = spawn(_mesh_rank, moe["data"] * moe["model"], backend="gloo",
                    store_dir=tmp, args=(dict(moe, grad=LM_MESH_GRAD),),
                    timeout=600,
                    shared_device=(str(device) if device.type == "cuda"
                                   else None))[0]
    gr = got["grad"]
    check(gr["finite"] and gr["mesh_vs_f32_worst_leaf"]
          <= LM_MESH_GRAD["factor"] * gr["one_rank_vs_f32_worst_leaf"],
          f"lm_mesh: bf16 gradients on the mesh further from f32 than "
          f"{LM_MESH_GRAD['factor']} x one rank's: {gr}")
    lines.append({"lm_mesh": dict(
        part="grad", **gr, mesh_shape=[moe["data"], moe["model"]],
        card=card)})
    f32, bf = got["float32"], got["bfloat16"]
    check(f32["finite"] and f32["max_abs_err"] <= LM_MESH_EP_TOL
          and f32["aux_abs_err"] <= LM_MESH_AUX_TOL,
          f"lm_mesh: moe_ep f32 vs grouped: {f32}")
    check(bf["finite"]
          and bf["max_err_over_out_max"] <= LM_MESH_BF16_ULPS * 2.0 ** -8
          and bf["aux_abs_err"] <= LM_MESH_AUX_TOL,
          f"lm_mesh: moe_ep bf16 vs grouped: {bf}")
    lines.append({"lm_mesh": dict(
        part="moe_ep", **{k: v for k, v in moe.items()
                          if k not in ("cfg", "grad_cfg")},
        experts_padded=64, top_k=4, shared=4,
        f32=f32, bf16=bf, tol=dict(f32_out=LM_MESH_EP_TOL,
                                   aux=LM_MESH_AUX_TOL,
                                   bf16_err_over_out_max=LM_MESH_BF16_ULPS
                                   * 2.0 ** -8),
        peak_bytes_rank0=got["peak_bytes"],
        wall_s=time.perf_counter() - t0, card=card)})


#: the dry-run phase: production cells traced by ``python -m
#: repro_torch.launch.dryrun`` in child processes on the card's torch (fake
#: tensors: nothing runs on the card); gemma3-1b's decode one of the quick
#: ones, and the two train cells that failed on torch 2.11 before the
#: lookup became ``F.embedding`` (qwen1.5-0.5b with its QKV bias and
#: 151,936-row tied table, mamba2-130m)
DRYRUN_CELLS = (("gemma3-1b", "decode_32k"), ("sssp", "bellman_512k"),
                ("qwen1.5-0.5b", "train_4k"), ("mamba2-130m", "train_4k"),
                ("gemma3-1b", "train_4k"))
#: each train_4k cell's dot flops and all-to-all bytes a step on the pod
#: under torch 2.13.0+cpu, from ``PYTHONPATH=src python -m
#: repro_torch.launch.dryrun --all --mesh both --op-log --jobs 5`` on this
#: tree (its records' ``weighted``): the card's torch must trace the same
#: dot flops and all-to-all bytes within DRYRUN_A2A_RTOL, the routes that
#: ``sharding.rules`` pins (rowwise, relayout, reduce_partial)
DRYRUN_TORCH213 = {
    "qwen1.5-0.5b": (36485747179520.0, 1778384896.0),
    "mamba2-130m": (58809913442304.0, 201326592.0),
    "gemma3-1b": (184797410361344.0, 3699376128.0),
}
DRYRUN_A2A_RTOL = 0.01
#: seconds the dry-run children may take
DRYRUN_TIMEOUT = 120
#: the counter on real tensors at world 1: gemma2-2b at full width in bf16,
#: the 1 x 8192 prefill and a batch-4 decode step over 8192-slot caches
ROOFLINE_ARCH = "gemma2-2b"
ROOFLINE_PREFILL = (1, 8192)
ROOFLINE_DECODE = (4, 8192)
#: the counter's predicted peak (its output + temporaries) against the
#: measured rise of max_memory_allocated(), relative
ROOFLINE_MEM_RTOL = 0.10
ROOFLINE_REPS = 3


def _counts(ws) -> dict:
    d = ws.to_dict()
    return {k: d[k] for k in ("dot_flops", "vector_flops", "traffic_bytes",
                              "collective_bytes")}


def dryrun_phase(device, lines: list, card: str) -> None:
    """The dry run and the roofline (``repro_torch.launch.dryrun``,
    ``repro_torch.launch.cost_analysis``), in its own launch window (no
    kernel: the counter runs the models' plain ops):

    a. :data:`DRYRUN_CELLS` on the pod mesh (256 fake ranks) through the
       dry run's CLI with ``--op-log``, one child process a cell: each
       must exit 0, and no LM cell may all-gather its embedding table
       (its record's ``table_gathers``, read from the same collectives
       as its op log; a cell with any fails); a train_4k cell's dot
       flops must equal, and its all-to-all bytes come within
       :data:`DRYRUN_A2A_RTOL` of, torch 2.13's (:data:`DRYRUN_TORCH213`);
       one ``{"dryrun": ...}`` line with each cell's GB a device,
       collective bytes by kind, and a train cell's dot flops and
       all-to-all bytes beside 2.13's.
       The children trace on the host's cores while (b) and (c) use the
       card;
    b. the counter over real CUDA tensors at world 1 on
       :data:`ROOFLINE_ARCH` (:func:`roofline_card`);
    c. the latency constant: the median of a one-float all-reduce on a
       world-1 NCCL group, one ``{"collective_latency": ...}`` line.
    """
    import torch

    from repro_torch.launch import cost_analysis as CA

    src = str(Path(__file__).resolve().parent / "src")
    # one thread each, at the lowest priority: the host-bound decode step
    # and the latency measured beside them keep their cores
    env = dict(os.environ, PYTHONPATH=src, OMP_NUM_THREADS="1")
    kw = dict(env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
              text=True, preexec_fn=lambda: os.nice(19))
    out_dir = tempfile.mkdtemp(prefix="dryrun-")
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
         "--shape", sh, "--mesh", "pod", "--out", out_dir, "--op-log"],
        **kw)
        for a, sh in DRYRUN_CELLS]
    try:
        lines.append({"roofline_card": roofline_card(device, card)})
        with tempfile.TemporaryDirectory(prefix="latency-") as tmp:
            lat = CA.measure_collective_latency(device, store_dir=tmp)
        lines.append({"collective_latency": dict(
            lat, what="one-float all_reduce, world-1 NCCL group, each "
                      "call synchronized", card=card)})
        res = [p.communicate(timeout=DRYRUN_TIMEOUT) for p in procs]
        wall = time.perf_counter() - t0
        for p, (_, err) in zip(procs, res):
            check(p.returncode == 0,
                  f"dryrun child {p.args[-7:]} exited {p.returncode}: "
                  f"{err[-3000:]}")
        recs = []
        for a, sh in DRYRUN_CELLS:
            with open(os.path.join(out_dir, f"{a}__{sh}__pod.json")) as f:
                recs.append(json.load(f))
            check(not recs[-1]["table_gathers"], f"dryrun {a} {sh} "
                  f"all-gathers its embedding table: "
                  f"{recs[-1]['table_gathers']}")
            if sh == "train_4k":
                w = recs[-1]["weighted"]
                dots, a2a = DRYRUN_TORCH213[a]
                got = w["collective_bytes"]["all-to-all"]
                check(w["dot_flops"] == dots, f"dryrun {a} {sh}: dot flops "
                      f"{w['dot_flops']} against torch 2.13's {dots}")
                check(abs(got - a2a) <= DRYRUN_A2A_RTOL * max(got, a2a),
                      f"dryrun {a} {sh}: all-to-all bytes {got} against "
                      f"torch 2.13's {a2a}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(out_dir, ignore_errors=True)
    cells = []
    for rec in recs:
        rf = rec["roofline"]
        cells.append(dict(
            arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
            chips=rec["chips"], dominant=rf["dominant"],
            bound_time_s=rf["bound_time_s"], mfu_fraction=rec["mfu_fraction"],
            gb_per_device=rec["memory_analysis"]["live_bytes_per_device"]
            / 1e9, collective_gb={
                k: v / 1e9 for k, v in
                rec["weighted"]["collective_bytes"].items()},
            table_gathers=rec["table_gathers"], trace_s=rec["trace_s"],
            traced=rec["traced"]))
        if rec["shape"] == "train_4k":
            dots, a2a = DRYRUN_TORCH213[rec["arch"]]
            cells[-1].update(
                dot_flops=rec["weighted"]["dot_flops"], dot_flops_213=dots,
                all_to_all_bytes=rec["weighted"]["collective_bytes"][
                    "all-to-all"], all_to_all_bytes_213=a2a)
    lines.append({"dryrun": dict(cells=cells, children_wall_s=wall,
                                 torch=torch.__version__, card=card)})


def roofline_card(device, card: str) -> dict:
    """The counter over real CUDA tensors at world 1 on
    :data:`ROOFLINE_ARCH` at full width (the prefill and the decode step,
    each after a warm-up call): its counts equal to those over fake meta
    tensors of the same arguments (the dry run's), exactly; its predicted
    peak (output + temporaries) within :data:`ROOFLINE_MEM_RTOL` of the
    measured rise of ``max_memory_allocated()``; the roofline's bound and
    dominant term beside the step's CUDA-event ms (median of
    :data:`ROOFLINE_REPS`)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.launch import cost_analysis as CA
    from repro_torch.models import transformer as T
    from repro_torch.models.tree import tree_map

    cfg = get_config(ROOFLINE_ARCH)
    params = T.init_params(cfg, torch.Generator(device).manual_seed(0),
                           device)
    gen = torch.Generator(device).manual_seed(1)
    B, S = ROOFLINE_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=device)
    Bd, Sd = ROOFLINE_DECODE
    caches = T.init_cache(cfg, Bd, Sd, torch.bfloat16, device)
    tok = torch.randint(0, cfg.vocab_size, (Bd, 1), generator=gen,
                        device=device)
    pos = torch.full((Bd,), Sd // 2, dtype=torch.int32, device=device)
    steps = {
        "prefill": (lambda p, t: T.prefill(p, t, cfg, max_len=S),
                    (params, toks), [B, S]),
        "decode": (lambda p, t, q, c: T.decode_step(p, t, q, c, cfg),
                   (params, tok, pos, caches), [Bd, Sd])}
    out = {}
    for name, (fn, args, shape) in steps.items():
        fn(*args)                                       # warm-up
        torch.cuda.synchronize(device)
        ms = statistics.median(event_call(lambda: fn(*args))[1]
                               for _ in range(ROOFLINE_REPS))
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        ws, mem, res = CA.count_step(fn, *args)
        torch.cuda.synchronize(device)
        rise = torch.cuda.max_memory_allocated(device) - base
        del res
        with FakeTensorMode():
            fws, fmem, _ = CA.count_step(fn, *tree_map(
                lambda t: torch.empty_strided(t.shape, t.stride(),
                                              dtype=t.dtype, device="meta"),
                args))
        real, fake = _counts(ws), _counts(fws)
        check(real == fake, f"roofline_card {name}: counts over real CUDA "
                            f"tensors {real} != over fake meta ones {fake}")
        pred = mem["live_bytes_per_device"] - mem["argument_size_in_bytes"]
        rel = abs(pred - rise) / max(rise, 1)
        check(rel <= ROOFLINE_MEM_RTOL,
              f"roofline_card {name}: predicted peak {pred} B vs measured "
              f"rise {rise} B ({rel:.3f} > {ROOFLINE_MEM_RTOL})")
        tokens = shape[0] * (shape[1] if name == "prefill" else 1)
        rf = CA.roofline(ws, chips=1,
                         model_flops=CA.analytic_decode_flops(cfg, tokens))
        out[name] = dict(
            shape=shape, **real, fake_meta_equal=True,
            predicted_peak_rise_bytes=pred, measured_peak_rise_bytes=rise,
            mem_rel_err=rel, fake_live_bytes=fmem["live_bytes_per_device"],
            bound_time_s=rf.bound_time_s, dominant=rf.dominant,
            terms_s=dict(compute=rf.compute_s, simt=rf.simt_s,
                         memory=rf.memory_s),
            event_ms=ms, roofline_share=rf.bound_time_s * 1e3 / ms,
            mfu_fraction=CA.mfu_fraction(rf, 1))
    del params, caches
    torch.cuda.empty_cache()
    return dict(arch=ROOFLINE_ARCH, dtype=cfg.param_dtype, steps=out,
                constants=dict(peak_flops=CA.PEAK_FLOPS,
                               simt_ops=CA.SIMT_OPS, hbm_bw=CA.HBM_BW),
                prediction="data-sheet peaks, H100 SXM at 700 W", card=card)


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
    T0 = time.perf_counter()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 1
    from repro_torch.core import csr as C
    from repro_torch.core import graph as G
    from repro_torch.core.delta_stepping import delta_profile
    from repro_torch.kernels import common
    from repro_torch.kernels import wrappers as kernel_wrappers

    import min_plus_rate

    wrappers = kernel_wrappers()
    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(f"torch: {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    clocked("build", lambda: common.build(KERNELS))
    print(f"kernel build: {time.perf_counter() - t0:.3f} s "
          f"({', '.join(KERNELS)}, nvcc {' '.join(common.NVCC_FLAGS)})")
    RATES.update(clocked("rates", lambda: min_plus_rate.rates(device)))
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
    CLOCK["graphs"] = time.perf_counter() - t0
    # the engine phase's scipy references, computed beside the card's work
    oracle_dir = tempfile.mkdtemp(prefix="chip_smoke_oracle")
    for name, cg in graphs.items():
        prefetch_oracle(cg, engine_oracle_sources(name, cg), oracle_dir)

    lines: list = []
    try:
        rng = np.random.default_rng(0)
        kern, pull_lines = clocked("kernel", lambda: kernel_phase(
            graphs, device, rng))
        big = f"paper-sparse-{DENSE_SPARSE_N}"
        t0 = time.perf_counter()
        kern.update(dense_kernel_phase(dense[big], device, rng))
        dense_s = {"dense_kernel_phase_s": time.perf_counter() - t0}
        # the 16-bit mode: kernels held and timed here, the fixpoints in
        # their own window below
        t0 = time.perf_counter()
        kern16, line16, adj16 = dense_lowp_kernel_phase(dense[big], device,
                                                        rng)
        lines.append(line16)
        CLOCK["dense_16bit"] = time.perf_counter() - t0
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        walls, refs = {}, {}
        lines += pull_lines + clocked("engine", lambda: engine_phase(
            graphs, device, walls, wrappers, refs))
        t0 = time.perf_counter()
        lines += dynamic_phase("sparse-4M", graphs["sparse"], device,
                               wrappers)
        lines.append({"dynamic_phase_s": time.perf_counter() - t0})
        CLOCK["dynamic"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lines += dense_engine_phase(dense, device, walls, rng, wrappers,
                                    refs)
        dense_s["dense_engine_phase_s"] = time.perf_counter() - t0
        CLOCK["dense"] = sum(dense_s.values())
        lines.append(dense_s)
        torch.cuda.synchronize()
        launches = {k: fn.launches for k, fn in wrappers.items()}
        for k, cnt in launches.items():
            check(cnt > 0, f"kernel {k} was not launched on the main path")
        # the dense fixpoints on the 16-bit matrix: their own window, in
        # which every launch is a 16-bit one
        t0 = time.perf_counter()
        for fn in wrappers.values():
            fn.launches = 0
        line16 = dense_lowp_engine_phase(adj16, dense[big], device, rng,
                                         refs[big])
        torch.cuda.synchronize()
        dense16 = {k: fn.launches for k, fn in wrappers.items()}
        check(dense16["relax_matvec"] == line16["sweeps"]
              and dense16["relax_matmul"] == line16["multisource_sweeps"]
              and dense16["relax_matvec_frontier"] == 1
              and sum(dense16.values()) == line16["sweeps"]
              + line16["multisource_sweeps"] + 1,
              f"the 16-bit fixpoints launched {dense16}, not one kernel "
              f"launch a sweep")
        lines.append(dict(line16, launches=dense16))
        del adj16
        CLOCK["dense_16bit"] += time.perf_counter() - t0
        lines.append(clocked("serial", lambda: serial_check(device)))
        # road-4M's ≈ 4000-sweep solves leave traces whose processing took
        # ≈ 1 min of the run: its idle shares stand in PERF.md §5
        profiled = {name: (cg, tuple(TWINS)) for name, cg in graphs.items()
                    if name != "road"}
        profiled[big] = (dense[big], ("bellman_kernel",))
        lines += clocked("profile", lambda: profile_phase(
            profiled, walls, device))
        # the sharded engines on an NCCL group of one: their own window
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        sharded_engines(graphs, dense, refs, walls, device, wrappers,
                        lines)
        torch.cuda.synchronize()
        sharded = {k: fn.launches for k, fn in wrappers.items()}
        for k in ("ell_relax", "frontier_relax"):
            check(sharded[k] > 0,
                  f"{k} was not launched by the sharded engines")
        modes, mode_lines = kernel_mode_phase(graphs, device, rng, sharded)
        lines += mode_lines
        lines.append({"sharded_phase_s": time.perf_counter() - t0})
        CLOCK["sharded"] = time.perf_counter() - t0
        del dense, refs
        # the serving path: its own launch window
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        registry, zipf, zipf_wall = serve_phase(
            {"sparse-4M": graphs["sparse"], "hub-1M": graphs["hub"]},
            graphs["sparse"], device, wrappers, lines)
        torch.cuda.synchronize()
        served = {k: fn.launches for k, fn in wrappers.items()}
        check(served["frontier_relax"] > 0,
              "frontier_relax was not launched on the serving path")
        lines.append({"serve_phase_s": time.perf_counter() - t0})
        CLOCK["serve"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        obs_phase(graphs["sparse"], registry, zipf,
                  {e: walls["sparse", e] for e in SINGLE_ENGINES}, zipf_wall,
                  device, wrappers, lines)
        lines.append({"obs_phase_s": time.perf_counter() - t0})
        CLOCK["obs"] = time.perf_counter() - t0
        # sharded serving on ranks sharing the card: its own window, the
        # followers' launches read through the group's STATS
        t0 = time.perf_counter()
        torch.cuda.synchronize()
        for fn in wrappers.values():
            fn.launches = 0
        followers = sharded_serve_phase(
            {"sparse-4M": graphs["sparse"]}, {"hub-1M": graphs["hub"]},
            device, wrappers, lines)
        torch.cuda.synchronize()
        sharded_serve = {k: fn.launches + followers[k]
                         for k, fn in wrappers.items()}
        check(sharded_serve["frontier_relax"] > 0
              and followers["frontier_relax"] > 0,
              "frontier_relax was not launched on the sharded serving "
              "ranks")
        lines.append({"sharded_serve_phase_s": time.perf_counter() - t0,
                      "followers_launches": followers})
        CLOCK["sharded_serve"] = time.perf_counter() - t0
        # the serving drivers, then self-tuning: a launch window each
        windows = {}
        for path, run in (
                ("drivers", lambda: drivers_phase(device, wrappers, lines)),
                ("tune", lambda: tune_phase(
                    {name: registry.get(name)
                     for name in ("sparse-4M", "hub-1M")},
                    device, wrappers, lines)),
                ("paper", lambda: paper_phase(device, wrappers, lines)),
                ("lm", lambda: lm_phase(device, lines)),
                ("lm_mesh", lambda: lm_mesh_phase(device, lines, card)),
                ("dryrun", lambda: dryrun_phase(device, lines, card))):
            t0 = time.perf_counter()
            torch.cuda.synchronize()
            for fn in wrappers.values():
                fn.launches = 0
            run()
            torch.cuda.synchronize()
            windows[path] = {k: fn.launches for k, fn in wrappers.items()}
            lines.append({f"{path}_phase_s": time.perf_counter() - t0})
            CLOCK[path] = time.perf_counter() - t0
        check(windows["drivers"]["frontier_relax"] > 0,
              "frontier_relax was not launched by the serving drivers")
        for k in ("ell_relax", "frontier_relax", "bucket_relax"):
            check(windows["tune"][k] > 0,
                  f"{k} was not launched on the self-tuning path")
    except (CheckFailed, SystemExit) as e:
        for line in lines:              # what ran before the failure
            print(json.dumps(line))
        print(json.dumps({"clock_s": CLOCK}))
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        stop_oracles()
        shutil.rmtree(oracle_dir, ignore_errors=True)

    for line in lines:
        print(json.dumps(line))
    # each dense kernel's 16-bit rows under its dtype's name
    kern16_by_kernel = {k: {name: rows[k] for name, rows in kern16.items()}
                        for k in kern16[DENSE_LOWP_ENGINES]}
    CLOCK["total"] = time.perf_counter() - T0
    print(json.dumps({"clock_s": CLOCK}))
    print(json.dumps({"kernel_modes": modes}))
    print(json.dumps({"kernels": [
        dict(name=k, route="cuda", source=KERNELS[k][0],
             replaces=KERNELS[k][1],
             launches=(launches[k] + dense16[k] + sharded[k] + served[k]
                       + sharded_serve[k]
                       + sum(w[k] for w in windows.values())),
             launches_by_path={"csr_dynamic_dense": launches[k],
                               "dense_16bit": dense16[k],
                               "sharded": sharded[k],
                               "serve": served[k],
                               "sharded_serve": sharded_serve[k],
                               **{path: w[k] for path, w in windows.items()}},
             **kern[k],
             **({"launches_16bit": {DENSE_LOWP_ENGINES: dense16[k]},
                 **kern16_by_kernel[k]} if k in kern16_by_kernel else {}))
        for k in KERNELS]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
