"""Two op logs of one dry-run cell (``python -m repro_torch.launch.dryrun
--arch A --shape S --op-log``, ``<name>.ops.json``), for instance traced
under two torch versions: what each holds live at its peak by the op that
made it, and the ops (by input shapes) whose calls, output bytes or dot
flops differ, largest first.  One JSON object on stdout.

    python3 tools/op_log_diff.py A.ops.json B.ops.json [--top 25]
"""
from __future__ import annotations

import argparse
import json


def diff(a: dict, b: dict, top: int) -> dict:
    peak = {k: [a["peak_by_op"].get(k, 0), b["peak_by_op"].get(k, 0)]
            for k in set(a["peak_by_op"]) | set(b["peak_by_op"])}
    peak = sorted(((k, v) for k, v in peak.items() if v[0] != v[1]),
                  key=lambda kv: -abs(kv[1][0] - kv[1][1]))
    zero = [0, 0, 0.0]
    ops = {k: [a["ops"].get(k, zero), b["ops"].get(k, zero)]
           for k in set(a["ops"]) | set(b["ops"])}
    ops = [(k, v) for k, v in ops.items() if v[0] != v[1]]
    by_bytes = sorted(ops, key=lambda kv: -abs(kv[1][0][1] - kv[1][1][1]))
    by_dots = sorted((kv for kv in ops if kv[1][0][2] != kv[1][1][2]),
                     key=lambda kv: -abs(kv[1][0][2] - kv[1][1][2]))
    total = lambda log, i: sum(v[i] for v in log["ops"].values())
    return {
        "torch": [a.get("torch"), b.get("torch")],
        "peak_bytes": [sum(a["peak_by_op"].values()),
                       sum(b["peak_by_op"].values())],
        "output_bytes": [total(a, 1), total(b, 1)],
        "dot_flops": [total(a, 2), total(b, 2)],
        "peak_by_op": peak[:top],
        "ops_by_output_bytes": by_bytes[:top],
        "ops_by_dot_flops": by_dots[:top],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args(argv)
    with open(args.a) as fa, open(args.b) as fb:
        print(json.dumps(diff(json.load(fa), json.load(fb), args.top),
                         indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
