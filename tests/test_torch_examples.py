"""The port's examples (repro_torch.examples) on the CPU: each runs
``main([..., "--device", "cpu"])`` and completes its own checks, and each
prints what the JAX package's example prints, device stamps aside.

- ``quickstart``: every engine's distances equal JAX's ``serial`` on JAX's
  quickstart graph, bitwise; its LM part prints JAX's lines.
- ``sssp_pipeline``: every engine against the oracle; at one CPU rank the
  sharded engines are skipped with the reason printed (and the engines
  that need the n x n matrix above ``DENSE_CAP``); on two gloo ranks they
  run.
- ``sssp_dynamic_demo`` / ``sssp_serve_demo``: the same repair, serving
  and spot-check lines as JAX's demos.
"""
import re
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core.graph as j_graph
from repro.core.api import shortest_paths as j_sp
from repro_torch.core.api import ENGINES, SHARDED_ENGINES
from repro_torch.examples import (quickstart, sssp_dynamic_demo,
                                  sssp_pipeline, sssp_serve_demo)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_quickstart_matches_jax_serial(capsys):
    got = quickstart.main(["--device", "cpu"])
    ref = j_sp(j_graph.random_graph(500, 1500, seed=0), 0, engine="serial")
    want = np.asarray(ref.dist, np.float32).tobytes()
    for engine in ("serial", "bellman", "bellman_kernel"):
        assert got[engine].tobytes() == want, engine
    assert got["multisource"][0].tobytes() == want
    out = capsys.readouterr().out
    assert "quickstart OK" in out
    # the LM part: gemma3-1b smoke, one train-loss eval, prefill of 32
    # tokens and 5 decode steps (JAX's quickstart prints the same lines)
    loss = re.search(r"gemma3-1b-smoke: one train-loss eval = ([0-9.]+)",
                     out)
    assert loss and 0 < float(loss.group(1)) < 20
    assert "decoded 5 tokens, cache pos now [37 37]" in out


def test_pipeline_one_cpu_rank_skips_with_reasons(capsys, monkeypatch):
    s = sssp_pipeline.main(["--nodes", "300", "--edges", "900",
                            "--device", "cpu"])
    assert set(s["engines"]) == set(ENGINES) - set(SHARDED_ENGINES)
    assert set(s["skipped"]) == set(SHARDED_ENGINES)
    assert all(e["verify"] and e["max_rel_err"] < 1e-5
               for e in s["engines"].values())
    out = capsys.readouterr().out
    assert out.count("skipped (one rank;") == len(SHARDED_ENGINES)
    # above the cap no n x n matrix is built; its engines say why
    monkeypatch.setattr(sssp_pipeline, "DENSE_CAP", 100)
    s = sssp_pipeline.main(["--nodes", "300", "--edges", "900",
                            "--device", "cpu"])
    matrix = set(sssp_pipeline.MATRIX_ENGINES)
    assert matrix <= set(s["skipped"])
    assert not matrix & set(s["engines"])
    assert "above the dense cap 100" in capsys.readouterr().out


def test_pipeline_runs_the_sharded_engines_on_two_gloo_ranks(capsys):
    s = sssp_pipeline.main(["--nodes", "120", "--edges", "360",
                            "--device", "cpu", "--procs", "2"])
    assert set(s["engines"]) == set(ENGINES) and not s["skipped"]
    assert all(e["verify"] for e in s["engines"].values())
    assert "sharded engines on 2 gloo rank(s)" in capsys.readouterr().out


def _jax_example_lines(name: str, capsys) -> list:
    runpy.run_path(str(ROOT / "examples" / f"{name}.py"))["main"]()
    return capsys.readouterr().out.splitlines()


def test_dynamic_demo_repeats_jax_demo(capsys):
    want = _jax_example_lines("sssp_dynamic_demo", capsys)
    s = sssp_dynamic_demo.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert s["rows_checked"] == 6 and np.isfinite(s["dist"]).all()
    # the same lines, but for the device named on the first
    assert got[0].replace(", on cpu", "") == want[0]
    assert got[1:] == want[1:]


def test_serve_demo_repeats_jax_demo(capsys):
    want = _jax_example_lines("sssp_serve_demo", capsys)
    s = sssp_serve_demo.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    # answer paths by scenario and both spot-checks; the bytes staged
    # differ (the port stages int64 scatter indices)
    keep = ("uniform", "zipf", "p2p", "spot-check")
    assert ([x for x in got if x.startswith(keep)]
            == [x for x in want if x.startswith(keep)])
    assert len([x for x in got if x.startswith(keep)]) == 5
    assert s["answered_via"]["p2p"]
