#!/usr/bin/env python3
"""The card's issue rate for the float32 instructions of a min-plus
product, measured (``tools/min_plus_rate.cu``).

    python3 tools/min_plus_rate.py

Prints one JSON line: float32 adds (FADD) a second, mins (FMNMX) a second,
and ``acc = fminf(acc, d + w)`` pairs a second, each over the whole card,
the median of CUDA-event timings of a kernel that keeps every SM issuing.
``chip_smoke.py`` calls :func:`rates` and bounds each relaxation kernel's
operations by its pairs over the pair rate: the published 67 TFLOP/s
float32 peak counts a fused multiply-add as two operations and says
nothing of FMNMX.  Exits non-zero without a CUDA GPU.
"""
from __future__ import annotations

import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
SOURCE = Path(__file__).resolve().with_suffix(".cu")
CHAINS = 16                  # independent chains a thread (the .cu's kChains)
THREADS = 256
BLOCKS_PER_SM = 8
ITERS = 16384
REPS = 5
MODES = {"fadd_per_s": 0, "fmnmx_per_s": 1, "add_min_pairs_per_s": 2}


def _launcher():
    """Build the probe and return its C entry."""
    from repro_torch.kernels import common

    return common.c_entry(
        common.build_variant(SOURCE, "tool"), "min_plus_probe",
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
         ctypes.c_int, ctypes.c_void_p])


def rates(device) -> dict:
    """Instructions a second over the whole card for each mode of the
    probe: every thread issues CHAINS of them an iteration."""
    import torch

    from repro_torch.kernels import common

    fn = _launcher()
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = sms * BLOCKS_PER_SM
    out = torch.empty(blocks * THREADS, dtype=torch.float32, device=device)
    stream = common.stream(out)
    count = blocks * THREADS * ITERS * CHAINS
    res = {}
    for key, mode in MODES.items():
        def launch():
            common.raise_on_error(
                fn(out.data_ptr(), mode, ITERS, blocks, THREADS, stream),
                "min_plus_probe")
        launch()
        torch.cuda.synchronize()
        times = []
        for _ in range(REPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        res[key] = count / statistics.median(times)
    res["sms"] = sms
    return res


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("min_plus_rate: no CUDA GPU available", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}")
    print(json.dumps(rates(torch.device("cuda", 0))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
