"""Bench-gate checking, one copy of the PASS / FAIL contract (the port's own
copy of benchmarks/gates.py).

Every bench writes a JSON doc whose gate sections are the top-level keys
``gate`` and ``gate_*``, each ``{"rule": str, "pass": bool, ...}`` (absent
or None when that leg did not run):

- :func:`iter_gates` — the (name, gate) pairs present in a doc;
- :func:`print_gates` — one ``name[rule]: PASS/FAIL`` line a gate;
- :func:`enforce` — print, then ``SystemExit`` naming every failing gate;
- :func:`check_file` and a CLI::

      python -m repro_torch.benchmarks.gates --check BENCH_torch_sssp.json

  exits 1 if a named file has a failing gate (default: every
  ``BENCH_torch_*.json`` in the current directory).
"""
from __future__ import annotations

import argparse
import glob
import json
import sys
from typing import Any, Dict, Iterator, List, Tuple

__all__ = ["iter_gates", "print_gates", "enforce", "check_file", "main"]


def iter_gates(doc: Dict[str, Any]) -> Iterator[Tuple[str, Dict[str, Any]]]:
    """Yield ``(name, gate)`` for every present gate section, in key
    order."""
    for key in doc:
        if key == "gate" or key.startswith("gate_"):
            gate = doc[key]
            if gate is not None:
                yield key, gate


def print_gates(doc: Dict[str, Any]) -> List[str]:
    """Print one line a gate; returns the failing gate names."""
    failing = []
    for name, gate in iter_gates(doc):
        ok = bool(gate.get("pass"))
        print(f"{name}[{gate.get('rule', '?')}]: {'PASS' if ok else 'FAIL'}")
        if not ok:
            failing.append(name)
    return failing


def enforce(doc: Dict[str, Any]) -> None:
    """Print every gate line, then exit non-zero naming the failures."""
    failing = print_gates(doc)
    if failing:
        raise SystemExit(f"benchmark gate(s) failed: {', '.join(failing)}")


def check_file(path: str, *, verbose: bool = True) -> List[str]:
    """Gate names failing in ``path`` (empty: all pass)."""
    with open(path) as f:
        doc = json.load(f)
    names = list(iter_gates(doc))
    failing = [name for name, gate in names if not gate.get("pass")]
    if verbose:
        print(f"{path}: {len(names)} gate(s), "
              f"{'all PASS' if not failing else 'FAIL ' + str(failing)}")
    return failing


def main(argv: List[str]) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.gates",
        description="check the gate sections of the port's bench docs")
    ap.add_argument("--check", action="store_true", required=True,
                    help="verify every named (or discovered) doc's gates")
    ap.add_argument("paths", nargs="*",
                    help="bench JSON docs (default: ./BENCH_torch_*.json)")
    args = ap.parse_args(argv)
    paths = args.paths or sorted(glob.glob("BENCH_torch_*.json"))
    if not paths:
        print("no BENCH_torch_*.json files found", file=sys.stderr)
        return 1
    bad = {}
    for path in paths:
        failing = check_file(path)
        if failing:
            bad[path] = failing
    if bad:
        print(f"FAIL: {bad}", file=sys.stderr)
        return 1
    print(f"OK: {len(paths)} doc(s), every gate passing")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
