"""Shared benchmark helpers: the timing envelope, the device stamp, the
cost-record capture of ``--cost-out``, and for the paper's tables the CSV
writer and the P-rank runner (the MPI ``-np`` analogue)."""
from __future__ import annotations

import contextlib
import csv
import json
import os
import platform
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import torch

from repro_torch.core._dist import BACKEND_OF, check_gpus

REPO = Path(__file__).resolve().parents[3]
SRC = REPO / "src"
#: where the paper's table and figure benches write their CSVs (ignored by
#: git; the JAX package writes experiments/bench/)
OUT_DIR = str(REPO / "experiments" / "bench_torch")


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


@contextlib.contextmanager
def capture_costs(path: Optional[str]):
    """With a ``path``, install a process-wide ``CostLog`` for the body
    (the facade's shim and the dynamic bench emit into it) and, when the
    body ends normally, write its records there as JSONL after checking
    them with obs/validate (invalid records exit non-zero).  Yields the log,
    or None without a path."""
    if not path:
        yield None
        return
    from repro_torch.obs import CostLog, set_cost_log
    from repro_torch.obs.validate import validate_cost_records

    log = CostLog()
    prev = set_cost_log(log)
    try:
        yield log
    finally:
        set_cost_log(prev)
    errs = validate_cost_records([r.to_dict() for r in log.records])
    if errs or not log.records:
        raise SystemExit(f"cost records invalid: {errs[:5] or 'none'}")
    log.write_jsonl(path)
    print(f"wrote {len(log.records)} cost records to {path}")


def write_csv(name: str, header: list[str], rows: list[list],
              meta: Optional[dict] = None) -> str:
    """Write ``rows`` under ``header`` to ``OUT_DIR/name`` and return the
    path.  With ``meta`` (what the columns ran on), also write it beside
    the CSV as ``<stem>.meta.json``; the CSV itself stays the JAX
    package's format."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, name)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(rows)
    if meta is not None:
        with open(os.path.splitext(path)[0] + ".meta.json", "w") as f:
            json.dump(meta, f, indent=1)
    return path


def ranks_label(procs, ranks_device) -> str:
    """How a P-rank column ran, e.g. ``8 gloo ranks on cpu``."""
    kind = torch.device(ranks_device).type
    return f"{procs} {BACKEND_OF[kind]} ranks on {kind}"


def run_with_procs(args: list[str], procs: int, device,
                   timeout: int = 900) -> str:
    """Run ``python -m repro_torch.launch.sssp_run --procs P --device D``
    with ``args`` in a subprocess and return its stdout (the P-rank
    analogue of the JAX package's forced-device runs): gloo ranks on the
    host for ``device`` "cpu", NCCL with one GPU a rank for "cuda".  P
    ranks on CUDA with fewer than P GPUs raise before anything starts; a
    run that exits non-zero raises with its stdout and stderr."""
    if torch.device(device).type == "cuda":
        check_gpus(procs)
    env = dict(os.environ)
    env["PYTHONPATH"] = str(SRC) + os.pathsep + env.get("PYTHONPATH", "")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.sssp_run", *args,
         "--procs", str(procs), "--device", str(device)],
        capture_output=True, text=True, env=env, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"sssp_run {' '.join(args)} --procs {procs} "
                           f"--device {device} failed:\n{r.stdout}\n"
                           f"{r.stderr}")
    return r.stdout
