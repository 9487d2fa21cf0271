#!/usr/bin/env python3
"""Parent against change for the dense min-plus matvecs
(``src/repro_torch/csrc/relax_matvec.cu`` and ``relax_matvec_frontier.cu``)
on one GPU, in one process.

    python3 tools/dense_matvec_ab.py --parent-csrc DIR
        [--graphs paper-sparse-40000,paper-sparse-40001,...]

``DIR`` holds another tree's two sources and the headers they include (for
example ``src/repro_torch/csrc`` of a ``git archive`` of the parent
commit).  Both trees are built with the port's nvcc flags under other
names, and their C entries, which take the same arguments, are called
directly on the same inputs: by default paper-sparse-40000's matrix
(``sparse_graph(40000)``, every row 16-byte aligned: the 16-byte loads),
paper-sparse-40001's and 40004's (the scalar loads, but for float32 at
40004) and dense-2000's (``dense_graph(2000)``, which stays in the 50 MB
L2 and whose 256-row tiles would be fewer than the blocks the card
holds); ``--graphs`` takes ``paper-sparse-N`` and ``dense-N``; in
float32, bfloat16 and float16, with chip_smoke.py's
``dense_inputs`` (labels with ~30% INF, a 50% frontier).
Each version is first held bitwise against the plain version
(``relax_sweep_ref``, ``relax_sweep_frontier_ref``); then each kernel and
dtype is timed parent, change, change, parent (CUDA-event medians of
chip_smoke's ``KERNEL_REPS`` calls, each call cloning dist into its output
as the wrapper does).  ``bound_ms`` is the
bytes the function needs (the live rows, dist, frontier and out) over the
card's 3.35 TB/s.

Prints the card and one JSON line per graph, kernel and dtype; exits
non-zero on a mismatch or without a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as S  # noqa: E402  (also puts src/ on the path)

KERNELS = ("relax_matvec", "relax_matvec_frontier")
DTYPES = ("float32", "bfloat16", "float16")
_P, _I64 = ctypes.c_void_p, ctypes.c_int64
ARGS = {"relax_matvec": (_P, _P, _P, _I64, _P),
        "relax_matvec_frontier": (_P, _P, _P, _P, _I64, _P)}
SUFFIX = {"float32": "", "bfloat16": "_bf16", "float16": "_f16"}


def build(csrc: Path, tag: str) -> dict:
    """Both kernels of ``csrc`` built beside the port's kernels under names
    ending in ``tag``: ``{(kernel, dtype): the C entry}``."""
    from repro_torch.kernels import common

    entries = {}
    for name in KERNELS:
        lib = common.build_variant(csrc / f"{name}.cu", tag)
        for dtype in DTYPES:
            entries[name, dtype] = common.c_entry(
                lib, f"{name}{SUFFIX[dtype]}", ARGS[name])
    return entries


def sweep(fn, name: str, dist, on, adj):
    """One call of a matvec C entry, as the wrapper makes it."""
    from repro_torch.kernels import common

    out = dist.clone()
    ptrs = ((dist, adj, out) if name == "relax_matvec"
            else (dist, on, adj, out))
    common.raise_on_error(
        fn(*(t.data_ptr() for t in ptrs), dist.numel(), common.stream(dist)),
        name)
    return out


def compare(versions: dict, graph: str, name: str, dtype: str, dist, on,
            adj) -> dict:
    """Both versions on one input: bitwise against the plain version, then
    timed parent, change, change, parent."""
    import torch

    from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                    relax_sweep_ref)

    n, e = dist.numel(), adj.element_size()
    if name == "relax_matvec":
        want = relax_sweep_ref(dist, adj)
        rows = int(torch.isfinite(dist).sum())
        nbytes = rows * n * e + 2 * n * e
    else:
        want = relax_sweep_frontier_ref(dist, on, adj)
        rows = int((on & torch.isfinite(dist)).sum())
        nbytes = rows * n * e + 2 * n * e + n
    for key, fns in versions.items():
        S.check(S.bitwise(sweep(fns[name, dtype], name, dist, on, adj), want),
                f"{name} {dtype} ({key}) differs from its plain version")
    ms = {key: [] for key in versions}
    for key in ("parent", "change", "change", "parent"):
        fn = versions[key][name, dtype]
        ms[key].append(S.time_ms(lambda: sweep(fn, name, dist, on, adj),
                                 S.KERNEL_REPS))
    return dict(kernel=name, dtype=dtype,
                shape=f"{graph} rows_read={rows}",
                parent_ms=ms["parent"], change_ms=ms["change"],
                bound_ms=nbytes / S.HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                bitwise_equal_plain=True)


def main() -> int:
    import numpy as np
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent-csrc", type=Path, required=True)
    n = S.DENSE_SPARSE_N
    ap.add_argument("--graphs",
                    default=f"paper-sparse-{n},paper-sparse-{n + 1},"
                            f"paper-sparse-{n + 4},dense-{S.DENSE_DENSE_N}")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_matvec_ab: no CUDA GPU available", file=sys.stderr)
        return 1
    from repro_torch.core import graph as G
    from repro_torch.kernels import common

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    versions = {"parent": build(args.parent_csrc, "parent"),
                "change": build(common.CSRC, "change")}
    rng = np.random.default_rng(0)
    for graph in args.graphs.split(","):
        kind, n = graph.rsplit("-", 1)
        g = {"paper-sparse": G.sparse_graph, "dense": G.dense_graph}[kind](
            int(n))
        full = torch.tensor(g.adj, device=device)
        for dtype in DTYPES:
            adj = full.to(getattr(torch, dtype))
            dist, on, _ = S.dense_inputs(g.n, rng, device, adj.dtype)
            for name in KERNELS:
                print(json.dumps(compare(versions, graph, name, dtype, dist,
                                         on, adj)), flush=True)
            del adj
        del full
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.CheckFailed as e:
        print(f"dense_matvec_ab: check failed: {e}", file=sys.stderr)
        sys.exit(1)
