"""The command's own guards: no result without a card, the import check,
and BENCHMARK.json against the rules of its format."""
import json
import os
import re
import subprocess
import sys
import types

import pytest

from sssp_bench import loader, run

ROOT = loader.ROOT
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "sssp_bench/run.py", "--workload",
                        "graph500-s23.solve", "--seed", str(2**33 + 1),
                        "--seconds", "1", "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""


def test_import_check_compares_whole_top_level_names(monkeypatch):
    ok = ["repro_torch", "repro_torch.core.api", "jaxish.sub", "flaxen",
          "torch"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["repro.core", "jax", "jaxlib.xla",
                                       "flax"]) == ["flax", "jax", "jaxlib",
                                                    "repro"]
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("j"))
    assert "jax" in run.forbidden_modules()


def test_benchmark_json_keeps_to_the_contract():
    bench = loader.load_benchmark()
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["sssp_bench"]
    assert 1 <= bench["run_seconds"] <= 51
    for word in bench["command"]:
        assert 1 <= len(word) <= 200 and not word.startswith("/")
    names = set()
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        loader.check_name(c["name"])
        assert c["file"].startswith("sssp_bench/configs/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        for key in c["reduced"]:
            loader.check_name(key)
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
        names.add(c["name"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in names and w["chips"] in (1, 4)
        assert (ROOT / "sssp_bench" / "traffic" / f"{w['traffic']}.json").is_file()
        assert 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    cells = {w["name"] for w in bench["workloads"]}
    metric_names = set()
    for m in bench["end_to_end"] + bench["per_layer"]:
        loader.check_name(m["name"])
        assert m["name"] not in metric_names
        metric_names.add(m["name"])
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", [])) <= cells
        assert (ROOT / "sssp_bench" / "metrics" / f"{m['name']}.py").is_file()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert "bound" not in m and m["moves"] in e2e
        assert 1 <= len(m["layer"]) <= 200
        assert set(m["workloads"]) <= set(
            e2e[m["moves"]].get("workloads", cells))
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.cuda
def test_a_small_cell_on_the_card(run_small):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from sssp_bench import cell
    from sssp_bench.tests.conftest import small_parts
    import time
    bench, wl, cfg, mix = small_parts("graph500-s23.solve")
    res = cell.run_cell(bench, wl, seed=5, seconds=0.5, trace=True,
                        device="cuda", t_process=time.perf_counter(),
                        config=cfg, mix=mix)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
