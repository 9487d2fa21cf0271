#!/usr/bin/env python3
"""Where the explicit-label frontier push spends its time, on one GPU.

    python3 tools/label_push_parts.py

At chip_smoke.py's two explicit-label shapes (``label_frontier`` on block
2 of sparse-4M / 4 and of hub-1M / 4) it times the port's kernel
(``frontier_relax(..., flabels=)``) beside ``tools/label_push_parts.cu``:
the same walk cut after each stage (the launch alone; the rows' reads and
scan; + the arcs' ``dst`` and ``w``; + the targets' labels; the whole
push; the targets with the atomicMin alone, and with the flag alone; the
whole push with the flag set from the atomic's old value, and with its
reads marked as streaming data), and the whole push over the arcs interleaved as one int2 array,
a layout the port's operands do not have.  The whole pushes are first
held bitwise against the plain version, labels and fallen-label mask.
Times are CUDA-event medians of chip_smoke's ``KERNEL_REPS`` calls, the
labels restored before every call, each part timed twice in turn.

Prints the card and one JSON line per shape; exits non-zero on a mismatch
or without a CUDA GPU.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (also puts src/ on the path)

SOURCE = Path(__file__).resolve().with_suffix(".cu")
STAGES = ("launch", "rows", "arcs", "targets", "full", "atomics_only",
          "flags_only", "full_flag_from_old", "full_streaming_loads")


def build():
    """The C entry of ``label_push_parts.cu``."""
    from repro_torch.kernels import common

    P, I = ctypes.c_void_p, ctypes.c_int64
    return common.c_entry(
        common.build_variant(SOURCE, "tool"), "label_push_parts",
        [ctypes.c_int, ctypes.c_int, P, P, P, I, I, P, P, P, P, P, P, P])


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("label_push_parts: no CUDA GPU available", file=sys.stderr)
        return 1
    from repro_torch.core import csr as C
    from repro_torch.core.sharded_csr import partition_operands
    from repro_torch.kernels import common
    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    fn = build()
    rng = np.random.default_rng(0)
    sink = torch.zeros(1, dtype=torch.int32, device=device)
    for name, label in (("sparse", "sparse-4M"), ("hub", "hub-1M")):
        g = (C.sparse_csr_graph(S.SPARSE_N) if name == "sparse"
             else C.skewed_hub_csr_graph(S.HUB_N))
        parts = g.partitioned(S.MODE_NPROCS)
        ops = partition_operands(parts, S.MODE_BLOCK, device=device)
        fids, flab, blk0, _, _ = S.label_frontier(parts, ops, device, rng)
        push = (fids, ops["out_indptr"], ops["out_dst"], ops["out_w"])
        arcs = torch.stack([ops["out_dst"], ops["out_w"].view(torch.int32)],
                           dim=1).contiguous()
        want, want_fell = blk0.clone(), torch.zeros(
            blk0.numel(), dtype=torch.bool, device=device)
        frontier_relax_ref(want, *push, want_fell, flabels=flab)
        blk, fell = blk0.clone(), torch.zeros_like(want_fell)

        def reset():
            blk.copy_(blk0)
            fell.zero_()

        def part(stage, aos=0):
            rc = fn(stage, aos, blk.data_ptr(), fids.data_ptr(),
                    flab.data_ptr(), fids.numel(), parts.n_pad + 1,
                    ops["out_indptr"].data_ptr(), ops["out_dst"].data_ptr(),
                    ops["out_w"].data_ptr(), arcs.data_ptr(),
                    fell.data_ptr(), sink.data_ptr(), common.stream(blk))
            common.raise_on_error(rc, "label_push_parts")

        calls = {"kernel": lambda: frontier_relax(blk, *push, fell,
                                                  flabels=flab),
                 **{s: (lambda i=i: part(i)) for i, s in enumerate(STAGES)},
                 "full_interleaved_arcs": lambda: part(4, 1)}
        for key in ("kernel", "full", "full_flag_from_old",
                    "full_streaming_loads", "full_interleaved_arcs"):
            reset()
            calls[key]()
            S.check(S.bitwise(blk, want) and torch.equal(fell, want_fell),
                    f"{key} differs from the plain version on {label}")
        ms = {key: [] for key in calls}
        for order in (list(calls), list(calls)[::-1]):
            for key in order:
                ms[key].append(S.time_ms(calls[key], S.KERNEL_REPS, reset))
        ip = ops["out_indptr"].long()
        live = fids < parts.n_pad + 1
        E = int((ip[fids[live] + 1] - ip[fids[live]]).sum())
        print(json.dumps(dict(
            shape=f"block {S.MODE_BLOCK} of {label} / {S.MODE_NPROCS}",
            frontier=fids.numel(), arcs=E, ms=ms, sink=int(sink.item()))),
            flush=True)
        del ops, fids, flab, blk0, arcs, want, want_fell, blk, fell
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
