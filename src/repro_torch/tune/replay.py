"""Trace-replay perf regression gate: recorded cost log vs fitted model
(port of repro/tune/replay.py: the same verdicts and exit codes).

Correctness regressions are caught by replaying traces bitwise
(launch/sssp_serve.py); this is the perf analogue.  Given a recorded
serve/churn/bench cost log (obs/profile.py JSONL or an in-memory list)
and a calibration file (tune/calibrate.py), re-run every record through the fitted cost
model and fail when measured wall time drifts above prediction beyond a
tolerance — a hot path that silently got slower fails CI the same way a
wrong answer would.

Drift is judged per (engine, nprocs) group on the MEDIAN of per-record
``measured / predicted`` ratios: medians absorb the one-off outliers a
shared CI box produces, and the grouping stops one noisy engine from
hiding another's regression.  The gate is ONE-SIDED by default —
measured faster than predicted is never a failure (serve p2p solves
early-exit and legitimately beat the full-solve calibration; a future
optimization should not fail the gate).  Records outside the model's
calibrated support, from unfitted engines (e.g. dynamic ``repair``), or
non-converged are skipped and reported as uncovered, never silently.

Backends must match: a cost log measured on a different backend than the
calibration is refused (that is what the v2 ``backend`` field exists
for) unless ``--allow-backend-mismatch``.

    PYTHONPATH=src python -m repro_torch.tune.replay COSTS.jsonl \
        --calibration CALIBRATION_torch.json [--tol 3.0] [--min-records 3]

Exit 0 = within tolerance, 1 = drift (or nothing replayable), 2 = usage.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from typing import Any, Dict, List, Optional

from repro_torch.tune.model import CostModel, load_model

__all__ = ["replay_records", "read_cost_jsonl", "main"]

DEFAULT_TOL = 3.0      # median measured/predicted above this fails
DEFAULT_MIN_RECORDS = 3


def read_cost_jsonl(path: str) -> List[Dict[str, Any]]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    k = len(s) // 2
    return s[k] if len(s) % 2 else 0.5 * (s[k - 1] + s[k])


def replay_records(records: List[Dict[str, Any]], model: CostModel, *,
                   tol: float = DEFAULT_TOL,
                   min_records: int = DEFAULT_MIN_RECORDS,
                   two_sided: bool = False,
                   expect_backend: Optional[str] = None) -> Dict[str, Any]:
    """Replay ``records`` against ``model``; returns the gate report.

    ``report["pass"]`` is False iff some (engine, nprocs) group with at
    least ``min_records`` replayable records drifts beyond ``tol``
    (measured/predicted median > tol; with ``two_sided`` also < 1/tol),
    or a backend mismatch is detected, or nothing was replayable at all.
    """
    groups: Dict[str, List[float]] = {}
    skipped: Dict[str, int] = {}
    backend_mismatch = 0
    for r in records:
        be = r.get("backend") or ""
        if expect_backend and be and be != expect_backend:
            backend_mismatch += 1
            continue
        engine = str(r.get("engine", ""))
        nprocs = int(r.get("nprocs") or 1)
        key = f"{engine}@P{nprocs}"
        if not r.get("converged", True):
            skipped["not_converged"] = skipped.get("not_converged", 0) + 1
            continue
        wall = float(r.get("wall_ms") or 0.0)
        if wall <= 0:
            skipped["zero_wall"] = skipped.get("zero_wall", 0) + 1
            continue
        if model.fit_for(engine, nprocs) is None:
            skipped[f"unfitted:{key}"] = skipped.get(f"unfitted:{key}",
                                                     0) + 1
            continue
        if not model.in_support(engine, n=int(r["n"]),
                                m=int(r.get("m") or 0) or None,
                                nprocs=nprocs):
            skipped[f"out_of_support:{key}"] = skipped.get(
                f"out_of_support:{key}", 0) + 1
            continue
        pred = model.predict(engine, n=int(r["n"]),
                             m=int(r.get("m") or 0) or None,
                             batch=int(r.get("batch") or 1),
                             nprocs=nprocs)
        if pred is None or not math.isfinite(pred) or pred <= 0:
            skipped[f"unpredictable:{key}"] = skipped.get(
                f"unpredictable:{key}", 0) + 1
            continue
        groups.setdefault(key, []).append(wall / pred)

    per_engine = {}
    failures = []
    for key in sorted(groups):
        ratios = groups[key]
        med = _median(ratios)
        counted = len(ratios) >= min_records
        drift = med > tol or (two_sided and med < 1.0 / tol)
        per_engine[key] = {
            "records": len(ratios),
            "median_ratio": round(med, 4),
            "max_ratio": round(max(ratios), 4),
            "counted": counted,
            "drift": bool(counted and drift),
        }
        if counted and drift:
            failures.append(key)
    replayed = sum(len(v) for v in groups.values())
    ok = not failures and replayed > 0 and backend_mismatch == 0
    return {
        "rule": (f"per-(engine,nprocs) median measured/predicted wall "
                 f"must stay <= {tol}x"
                 + (f" and >= {1/tol:.3g}x" if two_sided else "")
                 + f" (groups under {min_records} records reported, "
                 f"not gated)"),
        "tol": tol,
        "two_sided": two_sided,
        "replayed": replayed,
        "skipped": skipped,
        "backend_mismatch": backend_mismatch,
        "engines": per_engine,
        "failures": failures,
        "pass": bool(ok),
    }


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.tune.replay",
        description="replay a recorded cost log against the fitted model")
    ap.add_argument("costs", help="cost-record JSONL (obs/profile.py)")
    ap.add_argument("--calibration", required=True,
                    help="calibration file to fit the model from "
                         "(CALIBRATION_torch.json for the card)")
    ap.add_argument("--tol", type=float, default=DEFAULT_TOL)
    ap.add_argument("--min-records", type=int, default=DEFAULT_MIN_RECORDS)
    ap.add_argument("--two-sided", action="store_true",
                    help="also fail when measured is tol-times FASTER "
                         "than predicted (default: one-sided)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--allow-backend-mismatch", action="store_true")
    args = ap.parse_args(argv)

    model = load_model(args.calibration, seed=args.seed)
    records = read_cost_jsonl(args.costs)
    if not records:
        print("no cost records to replay", file=sys.stderr)
        return 1
    expect = None
    if not args.allow_backend_mismatch:
        expect = str(model.meta.get("backend") or "") or None
    report = replay_records(records, model, tol=args.tol,
                            min_records=args.min_records,
                            two_sided=args.two_sided,
                            expect_backend=expect)
    print(json.dumps(report, indent=1))
    if report["backend_mismatch"]:
        print(f"REPLAY FAIL: {report['backend_mismatch']} records from a "
              f"different backend than the calibration "
              f"({model.meta.get('backend')!r}); re-calibrate or pass "
              f"--allow-backend-mismatch", file=sys.stderr)
        return 1
    if report["replayed"] == 0:
        print("REPLAY FAIL: zero replayable records (all skipped)",
              file=sys.stderr)
        return 1
    if not report["pass"]:
        print(f"REPLAY FAIL: drift beyond {args.tol}x in "
              f"{report['failures']}", file=sys.stderr)
        return 1
    print(f"replay OK: {report['replayed']} records, "
          f"{len(report['engines'])} engine groups within {args.tol}x")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
