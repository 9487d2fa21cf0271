"""The port's benches at smoke size on the CPU: run_bench and dynamic_bench
write their JSON, every gate passes, every kernel engine's record carries
its kernel's launch count, and the work counters equal those of the JAX
benches' smoke records on the same points (exactly: they are counts)."""
import json

import numpy as np
import pytest
import torch

from benchmarks import dynamic_bench as j_dyn_bench
from benchmarks import run_bench as j_run_bench
from repro_torch.benchmarks import dynamic_bench, gates, run_bench
from repro_torch.benchmarks.common import time_engine


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def docs(tmp_path_factory):
    """Both port benches run once at smoke size on the CPU."""
    out = tmp_path_factory.mktemp("bench")
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        paths = (run_bench.run(smoke=True, device="cpu", repeats=1,
                               out=str(out / "BENCH_torch_sssp.json")),
                 dynamic_bench.run(smoke=True, device="cpu",
                                   out=str(out / "BENCH_torch_dynamic.json")))
    finally:
        torch.set_num_threads(prev)
    return {name: json.loads(open(p).read()) | {"path": p}
            for name, p in zip(("sssp", "dynamic"), paths)}


def test_default_outputs_are_the_ports_own():
    assert run_bench.DEFAULT_OUT.endswith("/BENCH_torch_sssp.json")
    assert dynamic_bench.DEFAULT_OUT.endswith("/BENCH_torch_dynamic.json")


@pytest.mark.parametrize("name", ["sssp", "dynamic"])
def test_smoke_bench_writes_its_json_and_every_gate_passes(docs, name):
    doc = docs[name]
    assert gates.check_file(doc["path"]) == []
    assert dict(gates.iter_gates(doc))["gate"]["pass"] is True
    meta = doc["meta"]
    assert meta["smoke"] is True and meta["device"] == "cpu"
    assert meta["torch"] == torch.__version__ and meta["power_limit"] is None
    assert "--cost-out" in meta["not_ported"]


def test_run_bench_records_kernel_launches_and_bitwise_agreement(docs):
    doc = docs["sssp"]
    assert set(doc) >= {"gate", "gate_delta"} and "gate_sharded" not in doc
    # smoke honesty: the rules say that no point reached n >= 10000
    for name in ("gate", "gate_delta"):
        assert "none with n >= 10000" in doc[name]["rule"]
    assert all(r["agrees_bitwise"] for r in doc["results"])
    kernel_recs = [r for r in doc["results"] if r["engine"].endswith(
        "_kernel")]
    assert {r["engine"] for r in kernel_recs} == {
        "bellman_kernel", "bellman_csr_kernel", "frontier_kernel"}
    for r in kernel_recs:
        # the CPU runs the kernels' plain versions: nothing launched
        assert r["kernel"] == run_bench.KERNEL_OF[r["engine"]]
        assert r["kernel_launches"] == 0


def test_engine_caps_lift_the_kernel_caps_on_the_gpu_only():
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    assert run_bench.engine_caps(False, cpu) == run_bench.ENGINE_CAPS
    full_gpu = run_bench.engine_caps(False, gpu)
    for k in run_bench.KERNEL_OF:
        assert full_gpu[k] is None
    assert full_gpu["serial"] == full_gpu["bellman"] == 2000
    smoke_cpu = run_bench.engine_caps(True, cpu)
    for k, v in smoke_cpu.items():
        assert v == j_run_bench.SMOKE_CAPS[k]
    assert run_bench.engine_caps(True, gpu)["frontier_kernel"] == 1000


def _counters(records, corpus, n):
    return [(r["engine"], r["nnz"], r["sweeps"], r["edges_relaxed"],
             r["sources"]) for r in records
            if r["corpus"] == corpus and r["n"] == n]


POINTS = [("dense", n, m) for n, m in ((10, 45), (100, 4950))] + [
    ("sparse", n, m) for n, m in ((10, 30), (100, 300), (1000, 3000))]


@pytest.mark.parametrize("corpus,n,m", POINTS,
                         ids=[f"{c}-{n}" for c, n, _ in POINTS])
def test_run_bench_counters_equal_the_jax_smoke_records(docs, corpus, n, m):
    engines = (j_run_bench.DENSE_ENGINES if corpus == "dense"
               else j_run_bench.SPARSE_ENGINES)
    want = j_run_bench._bench_point(corpus, n, m, engines,
                                    j_run_bench.SMOKE_CAPS, 1)
    got = _counters(docs["sssp"]["results"], corpus, n)
    assert got and got == _counters(want, corpus, n)


@pytest.mark.parametrize("corpus", ["road", "hub"])
def test_run_bench_delta_counters_equal_the_jax_smoke_records(docs, corpus):
    want = j_run_bench._bench_delta_point(corpus, 1000,
                                          j_run_bench.SMOKE_CAPS, 1)
    n = want[0]["n"]
    got = _counters(docs["sssp"]["results"], corpus, n)
    assert got and got == _counters(want, corpus, n)
    gd = docs["sssp"]["gate_delta"]
    assert any(p["corpus"] == corpus and p["n"] == n and p["fewer_sweeps"]
               for p in gd["points"])


@pytest.mark.parametrize("B", dynamic_bench.BATCH_SIZES)
def test_dynamic_bench_counters_equal_the_jax_smoke_records(docs, B):
    assert dynamic_bench.BATCH_SIZES == j_dyn_bench.BATCH_SIZES
    assert (dynamic_bench.ROUNDS, dynamic_bench.WARMUP,
            dynamic_bench.OVERLAY_CAPACITY) == (
        j_dyn_bench.ROUNDS, j_dyn_bench.WARMUP, j_dyn_bench.OVERLAY_CAPACITY)
    want = j_dyn_bench.run_batch_size(1000, B, seed=1000 + B)
    (got,) = [r for r in docs["dynamic"]["results"] if r["batch_edges"] == B]
    keys = ("n", "m", "batch_edges", "rounds", "repair_edges", "full_edges",
            "cone_median", "verified_bitwise_vs_full")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["repair_edges"] < got["full_edges"]


def test_time_engine_is_best_of_repeats():
    calls = []
    t = time_engine(lambda: calls.append(1), repeats=4, device="cpu")
    assert len(calls) == 4 and 0.0 <= t < 1.0


def test_benches_refuse_a_missing_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_bench.run(smoke=True, out=str(tmp_path / "a.json"))
    with pytest.raises(RuntimeError, match="CUDA"):
        dynamic_bench.run(smoke=True, out=str(tmp_path / "b.json"))
    assert not list(tmp_path.iterdir())


def test_gates_cli_checks_files(tmp_path, capsys):
    ok = {"gate": {"rule": "r", "pass": True}, "gate_x": None}
    bad = {"gate": {"rule": "r", "pass": True},
           "gate_delta": {"rule": "d", "pass": False}}
    (tmp_path / "ok.json").write_text(json.dumps(ok))
    (tmp_path / "bad.json").write_text(json.dumps(bad))
    assert gates.main(["--check", str(tmp_path / "ok.json")]) == 0
    assert gates.main(["--check", str(tmp_path / "ok.json"),
                       str(tmp_path / "bad.json")]) == 1
    with pytest.raises(SystemExit, match="gate_delta"):
        gates.enforce(bad)
    assert np.array_equal([n for n, _ in gates.iter_gates(bad)],
                          ["gate", "gate_delta"])
