"""Runs one cell of ``BENCHMARK.json`` once on one CUDA device and prints
its result as the last line of standard output::

    python3 sssp_bench/run.py --workload graph500-s23.solve --seed 7 \
        --seconds 51 --trace 0

``--trace 1`` reports the cell's per-layer metrics from a profiled window
instead of its end-to-end metrics.  The numbers compared with the plain
reference are printed, each beside its limit, as the last lines of standard
error and under ``checks`` in the result.  Without a CUDA device, or with
fewer than the cell asks for, it prints no result and exits 3; if a module
of JAX or of the JAX package ``repro`` was loaded, it exits 4.
"""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: top-level module names that may not be loaded by the end of a run
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(names=None) -> list:
    """The module names among ``names`` (default: the loaded modules) whose
    top-level name (before the first dot), compared whole, is one of
    ``FORBIDDEN``."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))

    import torch

    from sssp_bench import cell, loader

    bench = loader.load_benchmark(ROOT)
    wl = loader.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark measures the card only",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < int(wl["chips"]):
        print(f"{wl['name']} needs {wl['chips']} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 3
    try:
        import repro_torch
    except ImportError as e:
        print(f"the program (src/repro_torch) is missing: {e}",
              file=sys.stderr)
        return 1
    if ROOT / "src" not in Path(repro_torch.__file__).resolve().parents:
        print(f"repro_torch loaded from {repro_torch.__file__}, not from "
              f"this checkout", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    result = cell.run_cell(bench, wl, seed=args.seed, seconds=args.seconds,
                           trace=bool(args.trace), device="cuda",
                           t_process=T_PROCESS)
    bad = forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {', '.join(bad)}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
