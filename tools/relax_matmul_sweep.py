#!/usr/bin/env python3
"""Load-pipeline experiment for ``src/repro_torch/csrc/relax_matmul.cu`` on
one GPU.

    python3 tools/relax_matmul_sweep.py

At chip_smoke.py's relax_matmul shape (paper-sparse-40000, S = 8 sources
of mixed labels) it builds the kernel with each depth of its cp.async ring
(``-DRELAX_MATMUL_STAGES=k``; 0 loads 4 rows into registers at a time
instead), holds each build bitwise against the plain version and times it.
Prints the card and one JSON line per depth; exits non-zero on a mismatch
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
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as S  # noqa: E402  (also puts src/ on the path)
from csr_pull_sweep import variant_launcher  # noqa: E402

STAGES = (0, 2, 4, 8)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("relax_matmul_sweep: no CUDA GPU available", file=sys.stderr)
        return 1
    from repro_torch.core import graph as G
    from repro_torch.kernels import common
    from repro_torch.kernels.sssp_relax.ref import relax_sweep_multi_ref

    device = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    g = G.sparse_graph(S.DENSE_SPARSE_N)
    n = g.n
    adj = torch.tensor(g.adj, device=device)
    rng = np.random.default_rng(0)
    D = torch.stack([S.mixed_dist(n, rng, device) for _ in range(S.SOURCES)])
    want = relax_sweep_multi_ref(D, adj)
    P, I64 = ctypes.c_void_p, ctypes.c_int64
    args = (P, P, P, I64, I64, P)
    for k in STAGES:
        fn = variant_launcher("relax_matmul", args, f"RELAX_MATMUL_STAGES={k}")

        def run():
            out = D.clone()
            common.raise_on_error(
                fn(D.data_ptr(), adj.data_ptr(), out.data_ptr(), S.SOURCES,
                   n, common.stream(D)), "relax_matmul")
            return out

        S.check(S.bitwise(run(), want),
                f"relax_matmul (stages={k}) differs from its plain version")
        print(json.dumps(dict(kernel="relax_matmul", stages=k,
                              shape=f"paper-sparse-{n} S={S.SOURCES}",
                              ms=S.time_ms(run, S.KERNEL_REPS),
                              bitwise_equal_plain=True)), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.CheckFailed as e:
        print(f"relax_matmul_sweep: check failed: {e}", file=sys.stderr)
        sys.exit(1)
