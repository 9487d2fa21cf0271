"""Tracked benchmark: measured-model dispatch vs hard-coded thresholds
(port of benchmarks/tune_bench.py, with JAX's ``gate_tune``).

Races the two policies that can sit behind the one dispatch seam — the
default size-threshold :class:`~repro_torch.serve.dispatch.DispatchPolicy`
and the calibration-fitted :class:`~repro_torch.tune.select.TunedPolicy`,
both for the bench's device — on the same ``engine="auto"`` entry point,
per (corpus, n) leg at one device and, with ``--devices P``, again at P
ranks.  Each leg times both policies best-of-N under ``policy_override``
and records the engine + statics each one chose.  The P legs run SPMD on
P spawned ranks (core/_dist.spawn: gloo ranks on the CPU, NCCL ranks one
GPU each), both policies built on the ranks' group, so ``engine="auto"``
routes a graph at or above the shard threshold to the sharded engines;
rank 0 records.

Gate (``gate_tune``): on the full corpora (n >= 10000) the model-selected
engine+statics must NEVER be slower than the hard-coded choice by more
than 5% where the two select differently, and must be STRICTLY faster on
at least one such leg — i.e. the measured model pays for itself.
Correctness rides along: the bench bitwise-compares the tuned and
threshold answers on every leg (plus a serial cross-check on the small
legs where serial is affordable).

``--smoke`` shrinks the corpora below every calibrated crossover, where
both policies legitimately tie; the smoke gate therefore checks only
parity (bitwise-equal answers) and engagement (the model actually routed
at least one leg).

The calibration must come from the bench's backend (a ``TunedPolicy``
refuses another): ``CALIBRATION_torch.json`` for the card, written by
``python -m repro_torch.tune.calibrate`` (with ``--devices P`` for the
sharded records the P legs can use).

    PYTHONPATH=src python -m repro_torch.benchmarks.tune_bench [--smoke]
        [--device cuda|cpu] [--devices P]
        [--calibration CALIBRATION_torch.json]
        [--out BENCH_torch_tune.json] [--cost-out tune_costs.jsonl]
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.benchmarks.common import REPO, device_meta, time_engine

DEFAULT_OUT = str(REPO / "BENCH_torch_tune.json")
DEFAULT_CALIBRATION = str(REPO / "CALIBRATION_torch.json")

# (corpus, n) legs; sparse m = 3n matches the calibration grid's shape
FULL_LEGS = (
    ("sparse", 10000), ("sparse", 20000),
    ("road", 10000), ("road", 20000),
    ("hub", 10000), ("hub", 20000),
)
SMOKE_LEGS = (
    ("sparse", 512), ("sparse", 1024),
    ("road", 1024),
    ("hub", 1024),
)
GATE_MIN_N = 10000       # legs below this are reported, not gated
SLOWDOWN_TOL = 1.05      # tuned/base wall ratio ceiling on gated legs
SERIAL_VERIFY_MAX_N = 2000


def make_graph(corpus: str, n: int):
    """Same generators + seeds as repro_torch.tune.calibrate — the tuned
    policy is asked about workloads shaped like its calibration."""
    from repro_torch.core import csr as C

    if corpus == "sparse":
        return C.random_csr_graph(n, 3 * n, seed=n + 3 * n)
    if corpus == "road":
        return C.road_like_csr_graph(n, seed=n)
    if corpus == "hub":
        return C.skewed_hub_csr_graph(n, seed=n)
    raise ValueError(f"unknown corpus {corpus!r}")


def _choice_row(choice) -> Dict[str, Any]:
    return {
        "engine": choice.engine,
        "nprocs": choice.nprocs,
        "via": choice.via,
        "delta": None if choice.delta is None else float(choice.delta),
        "batch_cap": choice.batch_cap,
    }


def _effective_delta(cg, choice) -> Optional[float]:
    """The Δ a single-source solve of this choice actually runs with:
    an explicit static verbatim, else the graph's auto width for the
    Δ engines, else None (engine consumes no Δ)."""
    if "delta" not in choice.engine:
        return None
    if choice.delta is not None:
        return float(choice.delta)
    from repro_torch.core.delta_stepping import auto_delta

    return float(auto_delta(cg))


def _race_leg(cg, corpus: str, n: int, procs: int, model, *,
              repeats: int, device, group=None) -> Dict[str, Any]:
    """Time engine='auto' under each policy on one leg; returns the row.
    With ``group`` (of ``procs`` ranks) every rank runs it alike."""
    from repro_torch.core.api import shortest_paths
    from repro_torch.obs import get_cost_log
    from repro_torch.serve.dispatch import DispatchPolicy, policy_override
    from repro_torch.tune.select import TunedPolicy

    base_pol = DispatchPolicy(nprocs=procs, device=device, group=group)
    tuned_pol = TunedPolicy(model, nprocs=procs, device=device, group=group)
    walls: Dict[str, float] = {}
    dists: Dict[str, np.ndarray] = {}
    choices: Dict[str, Dict[str, Any]] = {}
    eff_delta: Dict[str, Optional[float]] = {}
    raw_choices: Dict[str, Any] = {}

    log = get_cost_log()
    for name, pol in (("base", base_pol), ("tuned", tuned_pol)):
        with policy_override(pol):
            raw_choices[name] = pol.choose(cg, kind="single")
            choices[name] = _choice_row(raw_choices[name])
            eff_delta[name] = _effective_delta(cg, raw_choices[name])
            res_box = {}

            def solve():
                res_box["res"] = shortest_paths(cg, 0, engine="auto",
                                                device=device, group=group)

            # warm outside time_engine (on the card the first call of a
            # kernel builds it) and drop the cost records it emitted — the
            # replay gate should see steady-state walls only, same
            # envelope the calibration measured.
            mark = len(log.records) if log.enabled else 0
            solve()
            if log.enabled:
                del log.records[mark:]
            walls[name] = time_engine(solve, repeats=repeats, device=device)
            dists[name] = np.asarray(res_box["res"].dist)
    agrees = bool(np.array_equal(dists["tuned"], dists["base"]))
    agrees_serial = None
    if n <= SERIAL_VERIFY_MAX_N:
        ser = shortest_paths(cg, 0, engine="serial", device=device)
        agrees_serial = bool(
            np.array_equal(dists["tuned"], np.asarray(ser.dist)))
    ratio = walls["tuned"] / walls["base"]
    # identical selections run the same solve — any measured ratio is
    # timer jitter, not a selection consequence
    identical = (
        raw_choices["base"].engine == raw_choices["tuned"].engine
        and raw_choices["base"].nprocs == raw_choices["tuned"].nprocs
        and eff_delta["base"] == eff_delta["tuned"]
        and raw_choices["base"].chunk == raw_choices["tuned"].chunk)
    return {
        "corpus": corpus, "n": int(cg.n), "m": int(cg.nnz),
        "nprocs": procs,
        "base": dict(choices["base"], wall_s=round(walls["base"], 6)),
        "tuned": dict(choices["tuned"], wall_s=round(walls["tuned"], 6)),
        "ratio": round(ratio, 4),
        "identical_choice": identical,
        "agrees_bitwise": agrees,
        "agrees_serial": agrees_serial,
        "gated": bool(n >= GATE_MIN_N),
    }


def _gate_tune(rows: List[Dict[str, Any]], *, smoke: bool,
               model_routed: int) -> Dict[str, Any]:
    parity = all(r["agrees_bitwise"] for r in rows) and all(
        r["agrees_serial"] in (None, True) for r in rows)
    points = [
        {"corpus": r["corpus"], "n": r["n"], "nprocs": r["nprocs"],
         "base_engine": r["base"]["engine"],
         "tuned_engine": r["tuned"]["engine"],
         "tuned_via": r["tuned"]["via"], "ratio": r["ratio"],
         "identical_choice": r["identical_choice"], "gated": r["gated"]}
        for r in rows
    ]
    if smoke:
        # sub-crossover corpora: both policies legitimately tie, so the
        # 5%-win economics are unmeasurable here — gate parity and model
        # engagement only (the full gate runs on the tracked corpora).
        ok = parity and model_routed >= 1
        rule = ("smoke: all policy answers bitwise-equal and the model "
                "routed >= 1 leg (perf economics gated on full corpora "
                "only)")
    else:
        gated = [r for r in rows if r["gated"]]
        differing = [r for r in gated if not r["identical_choice"]]
        within = all(r["ratio"] <= SLOWDOWN_TOL for r in differing)
        strict = any(r["ratio"] < 1.0 for r in differing)
        ok = parity and bool(differing) and within and strict
        rule = (f"on n>={GATE_MIN_N} legs where the policies select "
                f"differently, the model's engine+statics are never "
                f"slower than the hard-coded choice by more than "
                f"{(SLOWDOWN_TOL - 1) * 100:.0f}% AND strictly faster "
                f"on >=1; identical selections are ties (same solve, "
                f"ratio is timer jitter); answers bitwise-equal on "
                f"every leg")
    return {"rule": rule, "points": points, "pass": bool(ok)}


def _race_rank(group, model, legs, repeats: int, cost_log: bool) -> tuple:
    """One rank of the P legs (every rank runs it, SPMD).  Rank 0 returns
    its rows and, with ``cost_log``, its cost records."""
    from repro_torch.obs import CostLog, set_cost_log

    log = CostLog() if cost_log else None
    prev = set_cost_log(log) if log is not None else None
    try:
        rows = [_race_leg(make_graph(corpus, n), corpus, n, group.size,
                          model, repeats=repeats, device=group.device,
                          group=group) for corpus, n in legs]
    finally:
        if log is not None:
            set_cost_log(prev)
    if group.rank != 0:
        return [], []
    return rows, (log.records if log is not None else [])


def race(model, legs, *, repeats: int = 3, device="cuda",
         verbose: bool = True, devices: int = 1) -> tuple:
    """Race the two policies on every (corpus, n) leg at one device and,
    with ``devices`` > 1, at that many spawned ranks; returns (rows, legs
    the model routed), each leg's P = 1 row first."""
    from repro_torch.obs import get_cost_log

    per_leg: List[List[Dict[str, Any]]] = []
    for corpus, n in legs:
        cg = make_graph(corpus, n)
        per_leg.append([_race_leg(cg, corpus, n, 1, model, repeats=repeats,
                                  device=device)])
    if devices > 1:
        import tempfile

        from repro_torch.core._dist import BACKEND_OF, spawn

        log = get_cost_log()
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn(_race_rank, devices,
                          backend=BACKEND_OF[torch.device(device).type],
                          store_dir=tmp,
                          args=(model, legs, repeats, log.enabled))
        rows_p, records = ranks[0]
        if log.enabled:
            log.records.extend(records)
        for leg, row in zip(per_leg, rows_p):
            leg.append(row)
    rows = [row for leg in per_leg for row in leg]
    routed = sum(int(row["tuned"]["via"] == "model") for row in rows)
    if verbose:
        for row in rows:
            print(f"  {row['corpus']:6s} n={row['n']:6d} P={row['nprocs']} "
                  f"base={row['base']['engine']:24s}"
                  f"{row['base']['wall_s'] * 1e3:9.2f}ms  "
                  f"tuned={row['tuned']['engine']:24s}"
                  f"{row['tuned']['wall_s'] * 1e3:9.2f}ms "
                  f"({row['tuned']['via']})  x{row['ratio']}", flush=True)
    return rows, routed


def run(smoke: bool = False, repeats: int = 3, devices: int = 1,
        calibration: str = DEFAULT_CALIBRATION, out: str = DEFAULT_OUT,
        cost_out: Optional[str] = None, device="cuda") -> str:
    from repro_torch.core.api import resolve_device
    from repro_torch.obs import CostLog, backend_info, set_cost_log
    from repro_torch.tune.model import load_model

    dev = resolve_device(device)
    if devices > 1 and dev.type == "cuda":
        from repro_torch.core._dist import check_gpus

        check_gpus(devices)         # before any work: one GPU a rank
    if not os.path.exists(calibration):
        raise SystemExit(
            f"calibration file {calibration!r} not found — run "
            f"`PYTHONPATH=src python -m repro_torch.tune.calibrate"
            f"{' --smoke' if smoke else ''} --device {dev.type}` first")
    model = load_model(calibration)
    legs = SMOKE_LEGS if smoke else FULL_LEGS

    cost_log = CostLog() if cost_out else None
    prev = set_cost_log(cost_log) if cost_log is not None else None
    t0 = time.time()
    try:
        rows, routed = race(model, legs, repeats=repeats, device=dev,
                            devices=devices)
    finally:
        if cost_log is not None:
            set_cost_log(prev)
    gate = _gate_tune(rows, smoke=smoke, model_routed=routed)
    backend, device_kind = backend_info(dev)
    doc = {
        "schema": 1,
        "meta": {
            "created_unix": int(time.time()),
            "backend": backend,
            "device_kind": device_kind,
            **device_meta(dev),
            "smoke": smoke, "repeats": repeats, "devices": devices,
            # the file's path within the repository where it lies there
            "calibration": (os.path.relpath(calibration, REPO)
                            if os.path.abspath(calibration).startswith(
                                str(REPO) + os.sep) else calibration),
            "calibration_backend": str(model.meta.get("backend", "")),
            "model_coverage": model.coverage(),
            "model_routed_legs": routed,
            "bench_seconds": round(time.time() - t0, 1),
        },
        "results": rows,
        "gate_tune": gate,
    }
    with open(out, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    print(f"\nwrote {len(rows)} race legs to {out}")
    if cost_log is not None:
        from repro_torch.obs.validate import validate_cost_records
        errs = validate_cost_records(
            [r.to_dict() for r in cost_log.records])
        if errs:
            raise SystemExit(f"cost records invalid: {errs[:5]}")
        cost_log.write_jsonl(cost_out)
        print(f"wrote {len(cost_log.records)} cost records to {cost_out}")
    from repro_torch.benchmarks.gates import enforce
    enforce(doc)
    return out


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.tune_bench")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized corpora below the calibrated "
                         "crossovers (parity + engagement gate only)")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--devices", type=int, default=1,
                    help="shard arity of the extra legs, raced on that "
                         "many spawned ranks (1 = none)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' races the plain engines")
    ap.add_argument("--calibration", default=DEFAULT_CALIBRATION,
                    help="calibration file of the bench's backend to fit "
                         "the model from")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--cost-out", default=None, metavar="PATH",
                    help="write the race's cost records as JSONL (feeds "
                         "the repro_torch.tune.replay gate)")
    args = ap.parse_args(argv)
    return run(args.smoke, repeats=args.repeats, devices=args.devices,
               calibration=args.calibration, out=args.out,
               cost_out=args.cost_out, device=args.device)


if __name__ == "__main__":
    main()
