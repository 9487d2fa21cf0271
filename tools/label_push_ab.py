#!/usr/bin/env python3
"""Parent against change for the frontier push kernel
(``src/repro_torch/csrc/frontier_relax.cu``) on one GPU, in one process.

    python3 tools/label_push_ab.py --parent-csrc DIR

``DIR`` holds another tree's ``frontier_relax.cu`` and the headers it
includes (for example ``src/repro_torch/csrc`` of a ``git archive`` of the
parent commit).  Both sources are built with the port's nvcc flags and
their C entries, which take the same arguments, are called directly on the
same inputs: the explicit-label push (``flabels=``) on block 2 of
sparse-4M / 4 and of hub-1M / 4 (chip_smoke.py's ``label_frontier``), and
the push on dist's own labels at chip_smoke.py's three frontier shapes
(``frontier_shapes``).  Each version is first held bitwise against the
plain version, labels and fallen-label mask; then each shape is timed
parent, change, change, parent (CUDA-event medians of chip_smoke's
``KERNEL_REPS`` calls, the labels restored before every call).

Prints the card and one JSON line per shape; exits non-zero on a mismatch
or without a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (also puts src/ on the path)


def build_parent(csrc: Path):
    """The C entry of ``csrc/frontier_relax.cu``, built beside the port's
    kernels under another name."""
    from repro_torch.kernels import common
    from repro_torch.kernels.frontier_relax import kernel as KF

    lib = common.build_variant(csrc / "frontier_relax.cu", "parent")
    return common.c_entry(lib, "frontier_relax", KF._ARGS)


def push(fn, dist, fids, flab, ops, scratch, fell, bound, group) -> None:
    """One call of a frontier_relax C entry, as the wrapper makes it."""
    from repro_torch.kernels import common

    rc = fn(dist.data_ptr(), fids.data_ptr(),
            None if flab is None else flab.data_ptr(), scratch.data_ptr(),
            fids.numel(), bound, ops["out_indptr"].data_ptr(),
            ops["out_dst"].data_ptr(), ops["out_w"].data_ptr(),
            fell.data_ptr(), group, common.stream(dist))
    common.raise_on_error(rc, "frontier_relax")


def compare(fns: dict, shape: str, ops, dist0, fids, flab, bound) -> dict:
    """Both versions on one input: bitwise against the plain version, then
    timed parent, change, change, parent."""
    import torch

    from repro_torch.kernels import common
    from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

    n, m = dist0.numel(), ops["out_dst"].numel()
    want, want_fell = dist0.clone(), torch.zeros(n, dtype=torch.bool,
                                                 device=dist0.device)
    frontier_relax_ref(want, fids, ops["out_indptr"], ops["out_dst"],
                       ops["out_w"], want_fell, flabels=flab)
    out, fell = dist0.clone(), torch.zeros_like(want_fell)
    # the parent reads 3F int32 of scratch in both modes
    scratch = torch.empty(3 * fids.numel(), dtype=torch.int32,
                          device=dist0.device)
    group = common.lane_group(bound, m)

    def reset():
        out.copy_(dist0)
        fell.zero_()

    def call(key):
        push(fns[key], out, fids, flab, ops, scratch, fell, bound, group)

    for key in fns:
        reset()
        call(key)
        S.check(S.bitwise(out, want) and torch.equal(fell, want_fell),
                f"frontier_relax ({key}) differs from its plain version at "
                f"{shape}")
    ms = {key: [] for key in fns}
    for key in ("parent", "change", "change", "parent"):
        ms[key].append(S.time_ms(lambda: call(key), S.KERNEL_REPS, reset))
    return dict(kernel="frontier_relax",
                mode="dist_labels" if flab is None else "explicit_labels",
                shape=shape, frontier=fids.numel(), group=group,
                parent_ms=ms["parent"], change_ms=ms["change"],
                bitwise_equal_plain=True)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, required=True)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("label_push_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    from repro_torch.core import csr as C
    from repro_torch.core.sharded_csr import partition_operands
    from repro_torch.kernels import common
    from repro_torch.kernels.frontier_relax import kernel as KF

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    fns = {"parent": build_parent(args.parent_csrc),
           "change": common.launcher("frontier_relax", KF._ARGS)}
    graphs = {"sparse": C.sparse_csr_graph(S.SPARSE_N),
              "road": C.road_like_csr_graph(S.ROAD_N),
              "hub": C.skewed_hub_csr_graph(S.HUB_N)}
    rng = np.random.default_rng(0)
    for name, label in (("sparse", "sparse-4M"), ("hub", "hub-1M")):
        parts = graphs[name].partitioned(S.MODE_NPROCS)
        ops = partition_operands(parts, S.MODE_BLOCK, device=device)
        fids, flab, blk0, _, _ = S.label_frontier(parts, ops, device, rng)
        print(json.dumps(compare(
            fns, f"block {S.MODE_BLOCK} of {label} / {S.MODE_NPROCS}", ops,
            blk0, fids, flab, parts.n_pad + 1)), flush=True)
        del ops, fids, flab, blk0
    for shape, ops, dist, fids in S.frontier_shapes(graphs, device, rng):
        print(json.dumps(compare(fns, shape, ops, dist, fids, None,
                                 dist.numel())), flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
