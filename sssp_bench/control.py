"""Reads the control of a cell on the card: the cell's set-up and a short
window at its own load and size, then the check with the reference in
bfloat16 put in the program's place.  The control has to come out not
correct; its readings set the upper end of each limit::

    python3 sssp_bench/control.py --workload graph500-s23.solve \
        --seeds 11,12,13 --seconds 5

Prints one JSON line a seed: the seed and the numbers compared.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]

    import torch

    from sssp_bench import cell, loader

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    bench = loader.load_benchmark(ROOT)
    wl = loader.workload(bench, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = cell.run_cell(bench, wl, seed=seed, seconds=args.seconds,
                            trace=False, device="cuda",
                            t_process=time.perf_counter(), judge="control")
        print(json.dumps({"workload": wl["name"], "seed": seed,
                          "correct": res["correct"],
                          "checks": res["checks"]}), flush=True)
        del res
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
