"""Benchmark orchestrator: one module per paper table / figure — the port
of the JAX package's ``benchmarks/run.py``.

    PYTHONPATH=src python -m repro_torch.benchmarks.run [--quick] \\
        [--only table3,...] [--device cuda|cpu] [--ranks-device cuda|cpu]

Writes CSVs under experiments/bench_torch/ and prints a summary; exits 1
if any bench failed.  ``--device`` is where the single-device columns run,
``--ranks-device`` where the P-rank (MPI-analogue) columns run: ``cpu``
puts them on gloo ranks on the host, as the paper's MPI ran.  The JAX
package's ``roofline`` reads the LM substrate's dry-run records and comes
with ROADMAP A.13: asking for it raises.
"""
from __future__ import annotations

import argparse
import sys
import time
import traceback

from repro_torch.benchmarks import (fig23_size_sweep, table3_density,
                                    table4_scaling, weak_scaling)

BENCHES = {
    "table3": lambda a: table3_density.run(a.quick, device=a.device,
                                           ranks_device=a.ranks_device),
    "table4": lambda a: table4_scaling.run(a.quick,
                                           ranks_device=a.ranks_device),
    "fig23": lambda a: fig23_size_sweep.run(a.quick, device=a.device),
    # the experiment the paper couldn't run
    "weak": lambda a: weak_scaling.run(a.quick, ranks_device=a.ranks_device),
}
#: the JAX package's benches that wait for another slice of the port
NOT_PORTED = {"roofline": "A.13 (the LM training substrate and its dry-run "
                          "records)"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--only", default=None,
                    help="comma-separated subset of " + ",".join(BENCHES))
    ap.add_argument("--device", default="cuda",
                    help="torch device of the single-device columns")
    ap.add_argument("--ranks-device", default="cuda",
                    help="device of the P-rank columns: 'cuda' (NCCL, one "
                         "GPU a rank) or 'cpu' (gloo ranks on the host)")
    args = ap.parse_args(argv)
    names = (args.only.split(",") if args.only else list(BENCHES))
    for name in names:
        if name in NOT_PORTED:
            raise NotImplementedError(
                f"bench {name!r} is not ported yet: it comes with ROADMAP "
                f"{NOT_PORTED[name]}")
    failures = 0
    for name in names:
        print(f"\n=== {name} ===", flush=True)
        t0 = time.time()
        try:
            BENCHES[name](args)
            print(f"=== {name} done in {time.time() - t0:.1f}s ===",
                  flush=True)
        except Exception as e:      # the boundary: report, go on, exit 1
            failures += 1
            print(f"=== {name} FAILED: {e} ===")
            traceback.print_exc()
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
