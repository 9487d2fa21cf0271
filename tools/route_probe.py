"""Which model code issues each collective and each product of a dry-run
cell: the cell's step traced as ``python -m repro_torch.launch.dryrun``
traces it (rank 0 of a fake mesh, fake meta tensors), with every
collective and every dot op keyed by the model-code lines that issued it.
An op of the backward pass is keyed also by the forward lines that made
its autograd node (anomaly mode keeps them).  One JSON object: the cell's
``figures`` (dot flops, GB a device, collective GB by kind) and ``sites``,
``"op [input shapes] | file:line < file:line ... [| made by file:line
< ...]"`` -> calls, the second list for an op run by the backward pass.

    python3 tools/route_probe.py --arch gemma3-1b --shape train_4k \
        --mesh pod [--override segments=(('LLLLLG',1),)] [--out FILE]
    python3 tools/route_probe.py --diff A.json B.json

Two such files (e.g. one cell under two torch versions) compare with
``--diff``: the sites whose calls differ.  A cut of depth
(``--override segments=...``) keeps every route a layer takes.
"""
from __future__ import annotations

import argparse
import ast
import json
import os
import re
import sys
import traceback

_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')
_MINE = ("repro_torch/models", "repro_torch/sharding", "repro_torch/train")


def _site(lines, depth: int) -> str:
    """The innermost ``depth`` frames of the port's model code in a
    formatted stack, innermost first."""
    frames = []
    for text in lines:
        for path, line, fn in _FRAME.findall(text):
            if any(m in path for m in _MINE):
                frames.append(f"{path.split('repro_torch/')[-1]}:{line} {fn}")
    return " < ".join(reversed(frames[-depth:])) if frames else "?"


def probe(arch: str, shape: str, mesh: str, overrides: dict,
          depth: int = 4) -> dict:
    import torch

    from repro_torch.launch import cost_analysis as C
    from repro_torch.launch import dryrun

    sites: dict = {}

    class SiteCounter(C.StepCounter):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or self._paused:
                return out
            dot = func._overloadpacket in self.flop_registry
            if not dot and func not in self._kinds:
                return out
            here = _site(traceback.format_stack(), depth)
            node = torch._C._current_autograd_node()
            if node is not None:
                # a backward op: the forward lines of its autograd node
                made = _site(node.metadata.get("traceback_", []), depth)
                here = f"{here} | made by {made}"
            shapes = [tuple(t.shape) for t in C._tensors((args, kwargs))]
            key = f"{func}{shapes} | {here}"
            sites[key] = sites.get(key, 0) + 1
            return out

    C.StepCounter = SiteCounter
    with torch.autograd.set_detect_anomaly(True, check_nan=False):
        rec = dryrun.run_cell(arch, shape, mesh, "", overrides=overrides)
    w = rec["weighted"]
    return {"torch": torch.__version__, "cell": [arch, shape, mesh],
            "overrides": {k: repr(v) for k, v in overrides.items()},
            "figures": {"dot_flops": w["dot_flops"],
                        "gb_per_device": rec["memory_analysis"][
                            "live_bytes_per_device"] / 1e9,
                        **{f"{k}_gb": v / 1e9
                           for k, v in w["collective_bytes"].items()}},
            "sites": sites}


def diff(a: dict, b: dict) -> list:
    """[site, calls in a, calls in b] for each site whose calls differ."""
    keys = sorted(set(a["sites"]) | set(b["sites"]))
    return [[k, a["sites"].get(k, 0), b["sites"].get(k, 0)] for k in keys
            if a["sites"].get(k, 0) != b["sites"].get(k, 0)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    ap.add_argument("--override", action="append", default=[])
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--out")
    ap.add_argument("--diff", nargs=2, metavar=("A", "B"))
    args = ap.parse_args(argv)
    if args.diff:
        with open(args.diff[0]) as fa, open(args.diff[1]) as fb:
            for line in diff(json.load(fa), json.load(fb)):
                print(json.dumps(line))
        return 0
    overrides = {}
    for kv in args.override:
        k, _, v = kv.partition("=")
        overrides[k] = ast.literal_eval(v)
    rec = probe(args.arch, args.shape, args.mesh, overrides, args.depth)
    text = json.dumps(rec, indent=1)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))
    raise SystemExit(main())
