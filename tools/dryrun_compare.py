"""Two directories of dry-run records (``python -m repro_torch.launch.
dryrun --out DIR``), for instance traced under two torch versions: for
each cell in both, whether the dot flops are equal, and each side's GB a
device and collective bytes by kind, with every difference above
``--rtol`` (1%) named.  One JSON line a cell, then a summary line.

    python3 tools/dryrun_compare.py A_DIR B_DIR [--rtol 0.01]

Where both sides have op logs (``--op-log``), a line that differs also
names the ``--top`` ops whose output bytes differ most
(``tools/op_log_diff.py``, which gives the whole diff).
"""
from __future__ import annotations

import argparse
import glob
import json
import os

from op_log_diff import diff


def _load(d: str) -> dict:
    out = {}
    for p in glob.glob(os.path.join(d, "*.json")):
        if not p.endswith(".ops.json"):
            with open(p) as f:
                out[os.path.basename(p)[:-5]] = json.load(f)
    return out


def _figures(rec: dict) -> dict:
    w = rec["weighted"]
    return {"gb_per_device":
            rec["memory_analysis"]["live_bytes_per_device"] / 1e9,
            **{f"{k}_gb": v / 1e9 for k, v in w["collective_bytes"].items()}}


def _top_ops(a_dir: str, b_dir: str, name: str, top: int) -> list | None:
    """The ``top`` ops of the two sides' op logs whose output bytes
    differ most (``op_log_diff.diff``'s ``ops_by_output_bytes``)."""
    logs = [os.path.join(d, name + ".ops.json") for d in (a_dir, b_dir)]
    if not all(os.path.exists(p) for p in logs):
        return None
    with open(logs[0]) as fa, open(logs[1]) as fb:
        return diff(json.load(fa), json.load(fb), top)["ops_by_output_bytes"]


def _differs(a: float, b: float, rtol: float) -> bool:
    return abs(a - b) > rtol * max(abs(a), abs(b))


def compare(a_dir: str, b_dir: str, rtol: float = 0.01,
            top: int = 3) -> tuple:
    """(one dict a cell in both, the summary)."""
    a, b = _load(a_dir), _load(b_dir)
    lines = []
    for name in sorted(set(a) & set(b)):
        fa, fb = _figures(a[name]), _figures(b[name])
        lines.append({
            "cell": name,
            "torch": [a[name]["traced"]["torch"], b[name]["traced"]["torch"]],
            "dot_flops_equal": (a[name]["weighted"]["dot_flops"]
                                == b[name]["weighted"]["dot_flops"]),
            "figures": {k: [fa[k], fb.get(k, 0.0)] for k in fa},
            "differ": sorted(k for k in fa
                             if _differs(fa[k], fb.get(k, 0.0), rtol)),
        })
        if lines[-1]["differ"] or not lines[-1]["dot_flops_equal"]:
            lines[-1]["top_ops"] = _top_ops(a_dir, b_dir, name, top)
    summary = {"cells": len(lines), "only_a": sorted(set(a) - set(b)),
               "only_b": sorted(set(b) - set(a)),
               "dot_flops_differ": [l["cell"] for l in lines
                                    if not l["dot_flops_equal"]],
               "figures_differ": [l["cell"] for l in lines if l["differ"]]}
    return lines, summary


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rtol", type=float, default=0.01)
    ap.add_argument("--top", type=int, default=3)
    args = ap.parse_args(argv)
    lines, summary = compare(args.a, args.b, args.rtol, args.top)
    for line in lines:
        print(json.dumps(line))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
