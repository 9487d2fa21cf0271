"""Finds the parts of a cell by name: configurations, graph generators,
traffic mixes and per-layer metric readers are files of their own, so a
later change adds a cell or a metric by adding files and entries of
``BENCHMARK.json``, never by editing a file that is here."""
from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def check_name(name: str, what: str = "name") -> str:
    """``name`` if it is a valid benchmark name (letters, digits, ``_``,
    ``.``, ``-``; at most 64, not starting with ``.`` or ``-``), else raise
    ``ValueError``: a name becomes a file name, so nothing else is let in."""
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{what} {name!r} is not a valid name "
                         "([A-Za-z0-9_][A-Za-z0-9_.-]*, at most 64)")
    return name


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    return _json(Path(root) / "BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    check_name(name, "workload")
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"workload {name!r} is not in BENCHMARK.json")


def load_config(name: str, base: Path = HERE) -> dict:
    return _json(Path(base) / "configs" / f"{check_name(name, 'config')}.json")


def load_mix(name: str, base: Path = HERE) -> dict:
    return _json(Path(base) / "traffic" / f"{check_name(name, 'traffic')}.json")


def _module(path: Path):
    """The module at ``path``, loaded once per path."""
    path = path.resolve()
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found")
    key = "sssp_bench_part_" + hashlib.sha1(str(path).encode()).hexdigest()
    if key in sys.modules:
        return sys.modules[key]
    spec = importlib.util.spec_from_file_location(key, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[key] = mod
    spec.loader.exec_module(mod)
    return mod


def load_generator(name: str, base: Path = HERE):
    """The module ``graphs/<name>.py``; it defines ``generate(params, seed,
    device) -> inputs.EdgeList``."""
    check_name(name, "generator")
    return _module(Path(base) / "graphs" / f"{name}.py")


def load_metric(name: str, base: Path = HERE):
    """The module ``metrics/<name>.py``; it defines ``read(ctx) -> float |
    None`` (None: nothing to read in this run, the metric is left out)."""
    check_name(name, "metric")
    return _module(Path(base) / "metrics" / f"{name}.py")


def cell_metrics(bench: dict, wl: dict, trace: bool) -> list:
    """The metric entries this cell reports: its end-to-end metrics for a
    run with ``--trace 0``, its per-layer metrics for ``--trace 1``.  A
    metric without a ``workloads`` key is reported in every cell that
    reports the end-to-end metric it moves (per-layer) or in every cell
    (end-to-end)."""
    e2e = [m for m in bench["end_to_end"]
           if wl["name"] in m.get("workloads", [wl["name"]])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (wl["name"] in m["workloads"] if "workloads" in m
                else m["moves"] in names)]
