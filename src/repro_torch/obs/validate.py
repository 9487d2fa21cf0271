"""Schema + chain validation for trace and cost-record artifacts (port of
repro/obs/validate.py).

Used three ways:

- by `tests/test_torch_obs.py` on in-memory tracer output,
- by the benches and chip_smoke.py right after writing their files,
- as a CLI::

      python -m repro_torch.obs.validate TRACE.json COSTS.jsonl

Validation is structural (required keys, types, timestamp sanity) plus
the acceptance-criteria chain check: every ``answer`` instant with
``exact=True`` that was answered by an engine solve must be enclosed by
a ``tick`` span, preceded by a ``submit`` instant for the same qid, and
matched by a solve span whose ``args.qids`` contains the qid.
"""
from __future__ import annotations

import json
import sys
from typing import Any, Dict, List

from .profile import COST_RECORD_FIELDS_V1, COST_RECORD_FIELDS_V2_EXTRA

__all__ = [
    "validate_chrome_trace",
    "validate_cost_records",
    "reconstruct_answer_chains",
]

SOLVE_SPANS = ("batch_solve", "p2p_solve")
# answers whose `via` names an engine solve (serve/scheduler.VIAS):
# "batch" = multisource engine, "target" = p2p early exit.  trivial/
# cache/landmark/degraded answers legitimately have no solve span.
ENGINE_VIAS = ("batch", "target")


def validate_chrome_trace(doc: Dict[str, Any]) -> List[str]:
    """Return a list of schema violations (empty == valid)."""
    errs: List[str] = []
    if not isinstance(doc, dict) or "traceEvents" not in doc:
        return ["missing top-level traceEvents"]
    events = doc["traceEvents"]
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errs.append(f"event {i}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i"):
            errs.append(f"event {i}: unsupported ph {ph!r}")
            continue
        for key in ("name", "ts", "pid", "tid"):
            if key not in ev:
                errs.append(f"event {i} ({ev.get('name')}): missing {key!r}")
        if not isinstance(ev.get("name"), str):
            errs.append(f"event {i}: name is not a string")
        if not isinstance(ev.get("ts"), (int, float)):
            errs.append(f"event {i}: ts is not numeric")
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)):
                errs.append(f"event {i} ({ev.get('name')}): missing numeric dur")
            elif dur < 0:
                errs.append(f"event {i} ({ev.get('name')}): negative dur")
        if "args" in ev and not isinstance(ev["args"], dict):
            errs.append(f"event {i} ({ev.get('name')}): args is not an object")
    return errs


def validate_cost_records(rows: List[Dict[str, Any]]) -> List[str]:
    """Return a list of cost-record schema violations (empty == valid).

    Accepts both schema versions: v1 records carry only the decision/
    outcome fields; v2 additionally stamps ``backend``/``device_kind``
    (non-empty strings when present) — a record may omit them (v1) but
    may not carry them malformed.
    """
    errs: List[str] = []
    for i, r in enumerate(rows):
        if not isinstance(r, dict):
            errs.append(f"record {i}: not an object")
            continue
        for key in COST_RECORD_FIELDS_V1:
            if key not in r:
                errs.append(f"record {i}: missing {key!r}")
        for key in COST_RECORD_FIELDS_V2_EXTRA:
            if key in r and (not isinstance(r[key], str) or not r[key]):
                errs.append(
                    f"record {i}: {key} must be a non-empty string "
                    f"when present (v2)")
        for key in ("n", "m", "batch", "nprocs", "sweeps", "edges_relaxed"):
            if key in r and (not isinstance(r[key], int) or r[key] < 0):
                errs.append(f"record {i}: {key} must be a non-negative int")
        if "wall_ms" in r and (not isinstance(r["wall_ms"], (int, float)) or r["wall_ms"] < 0):
            errs.append(f"record {i}: wall_ms must be non-negative")
        if "engine" in r and (not isinstance(r["engine"], str) or not r["engine"]):
            errs.append(f"record {i}: engine must be a non-empty string")
        if "converged" in r and not isinstance(r["converged"], bool):
            errs.append(f"record {i}: converged must be a bool")
    return errs


def reconstruct_answer_chains(doc: Dict[str, Any]) -> List[str]:
    """Check every exact engine-served answer has a full span chain.

    Chain: ``submit`` instant (same qid, earlier) → enclosing ``tick``
    span (ts containment) → solve span with qid in args.qids → the
    ``answer`` instant itself.
    """
    errs: List[str] = []
    events = doc.get("traceEvents", [])
    submits = {}
    for ev in events:
        if ev.get("ph") == "i" and ev.get("name") == "submit":
            qid = ev.get("args", {}).get("qid")
            if qid is not None and qid not in submits:
                submits[qid] = ev["ts"]
    ticks = [ev for ev in events if ev.get("ph") == "X" and ev.get("name") == "tick"]
    solves = [ev for ev in events if ev.get("ph") == "X" and ev.get("name") in SOLVE_SPANS]
    answers = [ev for ev in events if ev.get("ph") == "i" and ev.get("name") == "answer"]
    if not answers:
        errs.append("no answer instants found")
    for ev in answers:
        args = ev.get("args", {})
        qid = args.get("qid")
        if qid is None:
            errs.append("answer instant without qid")
            continue
        if not args.get("exact", False):
            continue
        if qid not in submits:
            errs.append(f"answer qid={qid}: no submit instant")
        elif submits[qid] > ev["ts"]:
            errs.append(f"answer qid={qid}: submit after answer")
        if args.get("via") not in ENGINE_VIAS:
            continue  # cache/landmark answers need no solve span
        tick = next(
            (t for t in ticks if t["ts"] <= ev["ts"] <= t["ts"] + t.get("dur", 0)),
            None,
        )
        if tick is None:
            errs.append(f"answer qid={qid}: no enclosing tick span")
        solve = next(
            (s for s in solves if qid in s.get("args", {}).get("qids", ())),
            None,
        )
        if solve is None:
            errs.append(f"answer qid={qid} via={args.get('via')}: no solve span lists it")
        elif tick is not None and not (
            tick["ts"] <= solve["ts"] and solve["ts"] + solve.get("dur", 0) <= tick["ts"] + tick.get("dur", 0) + 1e-3
        ):
            # the solve must have happened within *a* tick; it may be an
            # earlier tick than the answering one (cached rows), so only
            # require some tick to contain it
            if not any(
                t["ts"] <= solve["ts"] <= t["ts"] + t.get("dur", 0) for t in ticks
            ):
                errs.append(f"answer qid={qid}: solve span outside every tick")
    return errs


def main(argv: List[str]) -> int:
    if len(argv) < 1:
        print("usage: python -m repro_torch.obs.validate TRACE.json [COSTS.jsonl]")
        return 2
    with open(argv[0]) as f:
        doc = json.load(f)
    errs = validate_chrome_trace(doc)
    errs += reconstruct_answer_chains(doc)
    n_events = len(doc.get("traceEvents", []))
    if len(argv) > 1:
        rows = []
        with open(argv[1]) as f:
            for line in f:
                line = line.strip()
                if line:
                    rows.append(json.loads(line))
        errs += validate_cost_records(rows)
        if not rows:
            errs.append("cost-record file is empty")
        print(f"cost records: {len(rows)}")
    print(f"trace events: {n_events}")
    if errs:
        for e in errs:
            print(f"INVALID: {e}", file=sys.stderr)
        return 1
    print("OK: trace + cost records schema-valid, answer chains complete")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
