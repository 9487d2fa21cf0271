"""Port parity for the serving and dynamic drivers and the two benches:
repro_torch.launch.{sssp_serve, sssp_dynamic} and
repro_torch.benchmarks.{serve_bench, tune_bench} on the CPU, in process,
against the JAX package's drivers where a stream is deterministic.

- ``sssp_serve --smoke``, ``--chaos --smoke`` and ``sssp_dynamic
  --smoke`` run with ``--device cpu``, every exact answer bitwise equal to
  a fresh ``serial`` solve (the drivers' own verifiers, which exit on a
  mismatch);
- the chaos replay's answer stream (query, status, via, exact, value) and
  the dynamic replay's are the JAX drivers' under the same seeds;
- the verifier catches a tampered answer;
- ``serve_bench --smoke`` and ``tune_bench --smoke`` (on a CPU calibration
  written by the port's ``tune.calibrate``) write their JSON with every
  gate passing;
- every entry point defaults to CUDA and raises without a GPU, and a
  sharded request without its ranks raises instead of quietly running at
  P = 1;
- ``sssp_serve --smoke --devices 4 --shard-threshold 128`` verifies every
  answer of its three scenarios on 4 gloo ranks, and ``serve_bench
  --devices 4`` writes ``sharded_results`` with a passing
  ``gate_sharded``.
"""
import copy
import json

import numpy as np
import pytest
import torch

import repro.launch.sssp_dynamic as j_dynamic_driver
import repro.launch.sssp_serve as j_serve_driver
from repro.serve import MicroBatchScheduler as JScheduler
from repro_torch.launch import sssp_dynamic, sssp_serve
from repro_torch.serve import MicroBatchScheduler

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _recording(base):
    """A scheduler class that keeps every answer its ticks return."""
    class Recording(base):
        answers: list = []

        def tick(self, now=None):
            out = super().tick(now)
            Recording.answers.extend(out)
            return out

    Recording.answers = []
    return Recording


def _stream(answers):
    out = []
    for a in answers:
        v = a.value
        if isinstance(v, np.ndarray):
            v = ("row", np.asarray(v, np.float32).tobytes())
        elif v is not None:
            v = float(np.float32(v))
        # a query, or a mutation ack's edit
        q = tuple(getattr(a.query, k, None) for k in (
            "graph", "source", "target", "op", "u", "v", "w"))
        out.append((q, a.status, a.via, a.exact, v, a.bounds))
    return out


# ---------------------------------------------------------------------------
# sssp_serve
# ---------------------------------------------------------------------------

def test_sssp_serve_smoke_verifies_every_scenario(tmp_path):
    trace = tmp_path / "serve.json"
    report = sssp_serve.main(["--smoke", *CPU, "--trace-out", str(trace)])
    assert set(report) == {"uniform", "zipf", "p2p"}
    for scen, r in report.items():
        assert r["queries"] == r["exact_checked"] == 60, scen
        assert r["verified_rows"] > 0, scen
        assert r["p99_ms"] >= r["p50_ms"] > 0
    assert trace.exists() and (tmp_path / "serve.cost.jsonl").exists()
    from repro_torch.obs import get_cost_log, get_tracer
    from repro_torch.serve.dispatch import _DEFAULT

    # sssp_serve leaves no policy, tracer or cost log installed
    assert _DEFAULT is None
    assert not get_tracer().enabled and not get_cost_log().enabled


def test_sssp_serve_chaos_stream_equals_jax(monkeypatch):
    port_cls, jax_cls = _recording(MicroBatchScheduler), _recording(
        JScheduler)
    monkeypatch.setattr(sssp_serve, "MicroBatchScheduler", port_cls)
    monkeypatch.setattr(j_serve_driver, "MicroBatchScheduler", jax_cls)
    report = sssp_serve.main(["--chaos", "--smoke", *CPU])
    j_serve_driver.main(["--chaos", "--smoke"])
    assert _stream(report["answers"]) == _stream(jax_cls.answers)
    assert _stream(port_cls.answers) == _stream(jax_cls.answers)
    assert len(report["answers"]) == 120
    assert report["statuses"]["ok"] > 0 and report["verified_rows"] > 0
    assert sum(report["faults_fired"].values()) > 0


def test_sssp_serve_smoke_with_a_cpu_calibration_serves_tuned():
    from pathlib import Path

    cal = str(Path(__file__).resolve().parents[1] / "CALIBRATION.json")
    report = sssp_serve.main(["--smoke", "--scenario", "zipf", *CPU,
                              "--calibration", cal])
    tuned = report["tuned"]
    assert tuned["model_routed"] + tuned["fallback_routed"] > 0
    assert report["zipf"]["verified_rows"] > 0


def test_verifier_catches_a_tampered_answer():
    from repro_torch.core import csr as C
    from repro_torch.serve import (DistanceCache, GraphRegistry,
                                   make_trace)

    cg = C.random_csr_graph(128, 384, seed=3)
    registry = GraphRegistry(device="cpu")
    registry.register("g", cg, landmarks=2)
    sched = MicroBatchScheduler(registry, DistanceCache(16), max_batch=4)
    check = sssp_serve.Verifier(registry, device="cpu")
    events = make_trace("uniform", [("g", cg.n)], num_queries=12,
                        rate=1e4, seed=1)
    answers, wall, paused = sssp_serve.replay(sched, events, check)
    assert len(answers) == 12 and wall > 0 and paused > 0
    assert check.exact == 12 and check.first["g"][0] == 0
    row = copy.copy(next(a for a in answers
                         if a.exact and a.query.target is None))
    row.value = np.array(row.value, copy=True)
    row.value[np.isfinite(row.value).nonzero()[0][-1]] += 1.0
    with pytest.raises(SystemExit, match="mismatch"):
        sssp_serve.Verifier(registry, device="cpu")([row])
    with pytest.raises(SystemExit, match="mismatch"):
        sssp_serve.verify_answers([row], {"g": cg}, device="cpu")
    assert sssp_serve.verify_answers(answers[:1], {"g": cg},
                                     device="cpu") == 1


# ---------------------------------------------------------------------------
# sssp_dynamic
# ---------------------------------------------------------------------------

def test_sssp_dynamic_smoke_stream_equals_jax(monkeypatch):
    port_cls, jax_cls = _recording(MicroBatchScheduler), _recording(
        JScheduler)
    monkeypatch.setattr(sssp_dynamic, "MicroBatchScheduler", port_cls)
    monkeypatch.setattr(j_dynamic_driver, "MicroBatchScheduler", jax_cls)
    report = sssp_dynamic.main(["--smoke", *CPU])
    j_dynamic_driver.main(["--smoke"])
    assert report["answers"] == 120 and report["verified_rows"] > 0
    assert report["mutations"] > 0
    assert _stream(port_cls.answers) == _stream(jax_cls.answers)


def test_sssp_dynamic_wallclock_replay_runs():
    report = sssp_dynamic.main(["--smoke", "--no-verify", "--events", "40",
                                *CPU])
    assert report["answers"] == 40 and report["p99_ms"] >= report["p50_ms"]


# ---------------------------------------------------------------------------
# the benches
# ---------------------------------------------------------------------------

def test_serve_bench_smoke_writes_every_gate_passing(tmp_path):
    from repro_torch.benchmarks import serve_bench

    out = tmp_path / "serve.json"
    serve_bench.run(smoke=True, out=str(out), device="cpu")
    doc = json.loads(out.read_text())
    assert doc["gate"]["pass"] and doc["meta"]["backend"] == "cpu"
    assert {r["scenario"] for r in doc["results"]} == {"uniform", "zipf",
                                                       "p2p"}
    assert {r["sequential_engine"] for r in doc["results"]} == {"frontier"}
    assert all(r["verified_bitwise"] for r in doc["results"])


def test_tune_bench_smoke_on_a_cpu_calibration(tmp_path):
    from repro_torch.benchmarks import tune_bench
    from repro_torch.tune import calibrate
    from repro_torch.tune.replay import main as replay_main

    cal = calibrate.run(smoke=True, repeats=1, out=str(tmp_path / "c.json"),
                        verbose=False, device="cpu")
    out, costs = tmp_path / "tune.json", tmp_path / "costs.jsonl"
    tune_bench.run(smoke=True, repeats=1, calibration=cal, out=str(out),
                   cost_out=str(costs), device="cpu")
    doc = json.loads(out.read_text())
    assert doc["gate_tune"]["pass"]
    assert doc["meta"]["calibration_backend"] == "cpu"
    assert doc["meta"]["model_routed_legs"] >= 1
    assert all(r["agrees_bitwise"] and r["agrees_serial"]
               for r in doc["results"])
    assert replay_main([str(costs), "--calibration", cal, "--tol",
                        "10"]) == 0


# ---------------------------------------------------------------------------
# defaults and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["sssp_serve", "sssp_serve_chaos",
                                   "sssp_dynamic", "serve_bench",
                                   "tune_bench"])
def test_entry_points_default_to_cuda_and_raise_without_a_gpu(entry,
                                                             tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from repro_torch.benchmarks import serve_bench, tune_bench

    call = {
        "sssp_serve": lambda: sssp_serve.main(["--smoke"]),
        "sssp_serve_chaos": lambda: sssp_serve.main(["--chaos", "--smoke"]),
        "sssp_dynamic": lambda: sssp_dynamic.main(["--smoke"]),
        "serve_bench": lambda: serve_bench.main(
            ["--smoke", "--out", str(tmp_path / "s.json")]),
        "tune_bench": lambda: tune_bench.main(
            ["--smoke", "--out", str(tmp_path / "t.json"), "--calibration",
             str(tmp_path / "missing.json")]),
    }[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("entry", ["serve_cuda", "serve_shared_cpu",
                                   "serve_bench_cuda", "tune_bench_cuda"])
def test_sharded_requests_without_their_ranks_raise(entry, tmp_path):
    """No fallback: P CUDA ranks need P GPUs (or the shared-card pairing
    by name), the shared-card pairing needs a card, and nothing runs at
    fewer ranks or on the CPU instead."""
    from repro_torch.benchmarks import serve_bench, tune_bench

    call, err = {
        "serve_cuda": (lambda: sssp_serve.main(
            ["--smoke", "--devices", "4"]), RuntimeError),
        "serve_shared_cpu": (lambda: sssp_serve.main(
            ["--smoke", "--devices", "2", "--shared-card", *CPU]),
            ValueError),
        "serve_bench_cuda": (lambda: serve_bench.main(
            ["--smoke", "--devices", "4", "--out",
             str(tmp_path / "s.json")]), RuntimeError),
        "tune_bench_cuda": (lambda: tune_bench.main(
            ["--smoke", "--devices", "4", "--out",
             str(tmp_path / "t.json")]), RuntimeError),
    }[entry]
    if torch.cuda.device_count() >= 4 and err is RuntimeError:
        pytest.skip("four GPUs are present")
    with pytest.raises(err, match="GPU|CUDA|card"):
        call()
    assert not list(tmp_path.iterdir())     # refused before any work


def test_sssp_serve_driver_sharded_replay_verifies(capsys):
    """JAX's test_sssp_serve_driver_sharded_replay_verifies on 4 gloo
    ranks: every answer of the three scenarios bitwise equal to serial."""
    report = sssp_serve.main(["--smoke", "--devices", "4",
                              "--shard-threshold", "128", *CPU])
    out = capsys.readouterr().out
    assert "sharded route: 4 devices" in out
    assert out.count("verified bitwise vs serial") == 3
    assert " batches + " in out
    for scen, r in report.items():
        assert r["queries"] == r["exact_checked"] == 60, scen
        assert r["sharded_sources"] > 0, scen
    assert not torch.distributed.is_initialized()     # the group closed


def test_serve_bench_sharded_leg_writes_a_passing_gate(tmp_path,
                                                       monkeypatch):
    from repro_torch.benchmarks import serve_bench

    # the sharded leg is what is new here; one scenario keeps the main gate
    monkeypatch.setattr(serve_bench, "SCENARIOS", ("zipf",))
    out = tmp_path / "serve.json"
    serve_bench.run(smoke=True, out=str(out), devices=4, device="cpu")
    doc = json.loads(out.read_text())
    (rec,) = doc["sharded_results"]
    gate = doc["gate_sharded"]
    assert gate["pass"] and not gate["ratio_enforced"]
    assert gate["edges_ratio"] < 1.0
    assert (rec["n"], rec["devices"], rec["backend"]) == (1000, 4, "gloo")
    assert rec["sharded_sources"] > 0 and rec["verified_bitwise"]
    assert (rec["sharded_edges_per_solve"]
            < rec["frontier_edges_per_solve"])
    assert doc["meta"]["devices"] == 4
