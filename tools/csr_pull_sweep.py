#!/usr/bin/env python3
"""Launch-shape experiment for the three CSR kernels that share
``src/repro_torch/csrc/csr_pull.cuh`` (``ell_relax.cu``, ``bucket_relax.cu``
and ``frontier_relax.cu``) on one GPU.

    python3 tools/csr_pull_sweep.py

At chip_smoke.py's shapes (the pulls: sparse-4M, hub-1M full and light,
road-4M; the push: a 10% sparse-4M frontier and the real road-4M and
hub-1M frontiers halfway through their solves) it times each kernel at
every lane-group width G its C entry takes, and, at the width the wrappers
pick (``kernels.common.lane_group``), once more from a build with the
whole-warp path for long rows switched off
(``-DCSR_PULL_LONG_ROW=0xffffffffu``).  Each variant is first held bitwise
against the plain version (``bucket_relax`` at a median ``hi``, flag
included; ``frontier_relax`` labels and fallen-label mask, restored before
every timed call).  The port's wrappers take no launch-shape option, so
this script calls the C entries directly.

Prints the card and one JSON line per kernel and shape; exits non-zero on a
mismatch or without a CUDA GPU.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (also puts src/ on the path)

GROUPS = (1, 2, 4, 8, 16, 32)


def variant_launcher(name: str, argtypes, define: str):
    """The C entry of kernel ``name`` from a build with ``-D<define>``
    (``CSR_PULL_LONG_ROW=0xffffffffu``: every row stays with its lane
    group)."""
    from repro_torch.kernels import common

    lib = common.build_variant(common.CSRC / f"{name}.cu",
                               define.replace("=", "-"), [define])
    return common.c_entry(lib, name, argtypes)


NO_LONG_ROW = "CSR_PULL_LONG_ROW=0xffffffffu"


def call(name: str, fn, group: int, dist, csr, hi):
    """One launch of a pull kernel's C entry at lane-group width ``group``:
    ``(out,)`` for ell_relax, ``(out, go)`` for bucket_relax."""
    import torch

    from repro_torch.kernels import common

    out = torch.empty_like(dist)
    ptrs = [t.data_ptr() for t in (dist, *csr)]
    n, stream = dist.shape[0], common.stream(dist)
    if name == "ell_relax":
        rc, res = fn(*ptrs, out.data_ptr(), n, 0, group, stream), (out,)
    else:
        flag = torch.zeros((), dtype=torch.int32, device=dist.device)
        rc = fn(*ptrs, hi.data_ptr(), out.data_ptr(), flag.data_ptr(), n,
                group, stream)
        res = (out, flag)
    common.raise_on_error(rc, name)
    return res


def push_once(fn, group: int, fids, ops, scratch, out, fell):
    """One call of the frontier push's C entry at lane-group width
    ``group``, in place on ``out`` and ``fell``."""
    from repro_torch.kernels import common

    n = out.shape[0]
    rc = fn(out.data_ptr(), fids.data_ptr(), None, scratch.data_ptr(),
            fids.numel(), n, ops["out_indptr"].data_ptr(),
            ops["out_dst"].data_ptr(), ops["out_w"].data_ptr(),
            fell.data_ptr(), group, common.stream(out))
    common.raise_on_error(rc, "frontier_relax")


def push_sweep(graphs: dict, device, rng) -> None:
    """frontier_relax at every G and without the long-row path, at
    chip_smoke's three push shapes."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.frontier_relax import kernel as KF
    from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

    fn = common.launcher("frontier_relax", KF._ARGS)
    fn_no_long = variant_launcher("frontier_relax", KF._ARGS, NO_LONG_ROW)
    shapes = S.frontier_shapes(graphs, device, rng)
    for shape, ops, dist, fids in shapes:
        n, m = dist.shape[0], ops["out_dst"].numel()
        want, want_fell = dist.clone(), torch.zeros(n, dtype=torch.bool,
                                                    device=device)
        frontier_relax_ref(want, fids, ops["out_indptr"], ops["out_dst"],
                           ops["out_w"], want_fell)
        out, fell = dist.clone(), torch.zeros_like(want_fell)
        scratch = torch.empty(3 * fids.numel(), dtype=torch.int32,
                              device=device)

        def reset():
            out.copy_(dist)
            fell.zero_()

        picked = common.lane_group(n, m)
        variants = {g: (fn, g) for g in GROUPS}
        variants["no_long_row"] = (fn_no_long, picked)
        ms = {}
        for key, (f, g) in variants.items():
            reset()
            push_once(f, g, fids, ops, scratch, out, fell)
            S.check(S.bitwise(out, want) and torch.equal(fell, want_fell),
                    f"frontier_relax differs from its plain version at "
                    f"{shape} ({key}, G={g})")
            ms[key] = S.time_ms(
                lambda: push_once(f, g, fids, ops, scratch, out, fell),
                S.KERNEL_REPS, reset)
        ip = ops["out_indptr"]
        print(json.dumps(dict(
            kernel="frontier_relax", shape=shape, n=n, arcs=m,
            frontier=fids.numel(),
            max_degree=int((ip[1:n + 1] - ip[:n]).max()), group=picked,
            ms=ms[picked], ms_by_group={g: ms[g] for g in GROUPS},
            ms_without_long_row_path=ms["no_long_row"],
            bitwise_equal_plain=True)), flush=True)
        del ops, dist, fids, want, want_fell, out, fell, scratch


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("csr_pull_sweep: no CUDA GPU available", file=sys.stderr)
        return 1
    from repro_torch.core import csr as C
    from repro_torch.core.delta_stepping import auto_delta
    from repro_torch.kernels import common
    from repro_torch.kernels.bucket_relax import kernel as KB
    from repro_torch.kernels.bucket_relax.ref import bucket_relax_csr_ref
    from repro_torch.kernels.csr_relax import kernel as KE
    from repro_torch.kernels.csr_relax.ref import ell_relax_csr_ref

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    kernels = {
        "ell_relax": (common.launcher("ell_relax", KE._ARGS),
                      variant_launcher("ell_relax", KE._ARGS, NO_LONG_ROW),
                      lambda d, csr, hi: (ell_relax_csr_ref(d, *csr),)),
        "bucket_relax": (common.launcher("bucket_relax", KB._ARGS),
                         variant_launcher("bucket_relax", KB._ARGS,
                                          NO_LONG_ROW),
                         lambda d, csr, hi: bucket_relax_csr_ref(d, *csr,
                                                                 hi)),
    }
    sparse = C.sparse_csr_graph(S.SPARSE_N)
    road = C.road_like_csr_graph(S.ROAD_N)
    hub = C.skewed_hub_csr_graph(S.HUB_N)
    dh = auto_delta(hub)
    shapes = (
        ("sparse-4M in-CSR", (sparse.indptr, sparse.indices, sparse.weights)),
        ("hub-1M in-CSR", (hub.indptr, hub.indices, hub.weights)),
        (f"hub-1M light in-CSR delta={dh}", hub.light_in_csr(dh)),
        ("road-4M in-CSR", (road.indptr, road.indices, road.weights)),
    )
    rng = np.random.default_rng(0)
    for shape, (ip_np, src_np, w_np) in shapes:
        n, m = ip_np.shape[0] - 1, int(src_np.shape[0])
        dist = S.mixed_dist(n, rng, device)
        csr = (torch.tensor(ip_np, device=device).int(),
               torch.tensor(src_np, device=device),
               torch.tensor(w_np, device=device))
        hi = torch.median(dist[torch.isfinite(dist)])
        picked = common.lane_group(n, m)
        for name, (fn, fn_no_long, plain) in kernels.items():
            want = plain(dist, csr, hi)
            variants = {g: (fn, g) for g in GROUPS}
            variants["no_long_row"] = (fn_no_long, picked)
            ms = {}
            for key, (f, g) in variants.items():
                got = call(name, f, g, dist, csr, hi)
                S.check(S.bitwise(got[0], want[0])
                        and all(bool(a) == bool(b)
                                for a, b in zip(got[1:], want[1:])),
                        f"{name} differs from its plain version at {shape} "
                        f"({key}, G={g})")
                ms[key] = S.time_ms(lambda: call(name, f, g, dist, csr, hi),
                                    S.KERNEL_REPS)
            print(json.dumps(dict(
                kernel=name, shape=shape, n=n, arcs=m,
                max_degree=int(np.diff(ip_np).max()), group=picked,
                ms=ms[picked],
                ms_by_group={g: ms[g] for g in GROUPS},
                ms_without_long_row_path=ms["no_long_row"],
                bitwise_equal_plain=True)), flush=True)
        del dist, csr
    push_sweep({"sparse": sparse, "road": road, "hub": hub}, device, rng)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.CheckFailed as e:
        print(f"csr_pull_sweep: check failed: {e}", file=sys.stderr)
        sys.exit(1)
