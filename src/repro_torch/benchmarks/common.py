"""Shared benchmark helpers: the timing envelope and the device stamp."""
from __future__ import annotations

import platform
import subprocess
import time
from pathlib import Path
from typing import Callable

import torch

REPO = Path(__file__).resolve().parents[3]


def time_engine(fn: Callable, *, repeats: int = 3, device=None) -> float:
    """Best-of-N host-clock wall time of ``fn()``.  On a CUDA ``device`` the
    device is synchronized before the clock starts and before it stops, so
    work ``fn`` leaves queued is timed too (the port's engines return numpy
    and end on the host anyway)."""
    cuda = device is not None and torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    best = float("inf")
    for _ in range(repeats):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        best = min(best, time.perf_counter() - t0)
    return best


def device_meta(device) -> dict:
    """What a bench record was measured on: torch and its CUDA, the device,
    and for a GPU its name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them (the
    name from torch where nvidia-smi cannot be run)."""
    dev = torch.device(device)
    meta = {"torch": torch.__version__, "torch_cuda": torch.version.cuda,
            "device": str(dev), "platform": platform.platform()}
    if dev.type != "cuda":
        return meta | {"device_name": platform.processor() or "cpu",
                       "power_limit": None}
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    meta["device_name"] = torch.cuda.get_device_name(index)
    meta["power_limit"] = None
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return meta
    name, _, limit = out.strip().partition(", ")
    meta |= {"nvidia_smi": out.strip(), "device_name": name or
             meta["device_name"], "power_limit": limit or None}
    return meta
