"""The loader: parts found by name as new files, bad names refused."""
import json
import shutil
import time

import pytest

from sssp_bench import cell, loader
from sssp_bench.tests.conftest import small_parts


@pytest.mark.parametrize("name", ["a b", "../x", "a/b", "", ".hidden",
                                  "-x", "é", "a" * 65, "a,b"])
def test_bad_names_are_refused(name):
    with pytest.raises(ValueError):
        loader.check_name(name)
    with pytest.raises(ValueError):
        loader.load_config(name)


@pytest.mark.parametrize("name", ["graph500-s23", "device_idle.solve", "_x",
                                  "9a", "a" * 64])
def test_good_names_pass(name):
    assert loader.check_name(name) == name


def test_a_new_config_mix_and_metric_are_found_as_new_files(tmp_path):
    for part in ("graphs", "metrics"):
        shutil.copytree(loader.HERE / part, tmp_path / part)
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    cfg = {"name": "tiny-kron", "source": "a test", "generator": "kronecker",
           "params": {"scale": 8, "edgefactor": 4, "A": 0.57, "B": 0.19,
                      "C": 0.19}, "reduced": [], "root_draw": "degree1"}
    (tmp_path / "configs" / "tiny-kron.json").write_text(json.dumps(cfg))
    mix = {"kind": "solve", "clients": 1, "roots": 4, "warmup_solves": 1,
           "check_solves": 2}
    (tmp_path / "traffic" / "few_roots.json").write_text(json.dumps(mix))
    (tmp_path / "metrics" / "solves_seen.py").write_text(
        "def read(ctx):\n    return float(len(ctx.solves))\n")
    bench = loader.load_benchmark()
    wl = {"name": "tiny-kron.few_roots", "config": "tiny-kron",
          "traffic": "few_roots", "chips": 1, "why": "a test"}
    bench["workloads"].append(wl)
    bench["per_layer"].append({
        "name": "solves_seen", "unit": "solves", "better": "higher",
        "source": "host_clock", "layer": "fixpoint loops",
        "moves": "peak_mem_gib", "workloads": ["tiny-kron.few_roots"]})
    res = cell.run_cell(bench, wl, seed=3, seconds=0.2, trace=True,
                        device="cpu", t_process=time.perf_counter(),
                        base=tmp_path)
    assert res["correct"]
    assert res["metrics"]["solves_seen"]["value"] == res["attempted"]
    assert set(res["metrics"]) == {"solves_seen"}


def test_each_cell_reports_its_metrics_and_nothing_else():
    bench = loader.load_benchmark()
    for wl in bench["workloads"]:
        e2e = {m["name"] for m in loader.cell_metrics(bench, wl, False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = loader.cell_metrics(bench, wl, True)
        assert per and all(m["moves"] in e2e for m in per)
    _, wl, _, _ = small_parts("graph500-s23.solve")
    names = {m["name"] for m in loader.cell_metrics(bench, wl, True)}
    assert names == {"solves_per_s.traced", "h2d_ms_per_solve",
                     "sweeps_per_solve",
                     "relax_launches_per_solve", "relax_roofline",
                     "device_idle.solve"}
