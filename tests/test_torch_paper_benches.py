"""The port's paper-table benches (repro_torch.benchmarks: table2, fig23,
table3, table4, weak_scaling, run, make_experiments_md) against the JAX
package's root ``benchmarks`` on the CPU.

- With both timers canned to the same values (``time_engine`` calls ``fn``
  once and returns the next value of a fixed sequence; ``run_with_devices``
  / ``run_with_procs`` return the same ``time=...s`` stdout), each bench
  writes a CSV byte-identical to its JAX module's, at sizes shrunk by
  patching the module constants (``PAIRS``, ``SIZES``, ``PROCS``, the
  ``PAPER_SPARSE`` cut), and asks for the same P-rank runs.
- On the tables' graphs the port's engines give JAX's answers bitwise
  (``dist``, and ``pred`` where there is one); the sharded legs run for
  real on gloo ranks through ``run_with_procs`` at P in {1, 2}.
- ``make_experiments_md``'s tables equal JAX's on JAX's committed records
  but for the heading line, which carries the port's device stamp.
- ``run``: ``roofline`` raises naming A.13; a failing bench exits 1; P CUDA
  ranks without P GPUs raise before anything starts.
"""
import csv
import itertools
import re
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmarks.common as j_common
import benchmarks.fig23_size_sweep as j_fig23
import benchmarks.make_experiments_md as j_md
import benchmarks.run as j_run
import benchmarks.table2_sparse_csr as j_table2
import benchmarks.table3_density as j_table3
import benchmarks.table4_scaling as j_table4
import benchmarks.weak_scaling as j_weak
import repro.core.csr as j_csr
import repro.core.graph as j_graph
from repro.core.api import shortest_paths as j_sp
import repro_torch.benchmarks.common as common
import repro_torch.core.graph as t_graph
from repro_torch.benchmarks import (fig23_size_sweep, make_experiments_md,
                                    run, table2_sparse_csr, table3_density,
                                    table4_scaling, weak_scaling)
from repro_torch.core import csr as t_csr
from repro_torch.core.api import shortest_paths as t_sp

ROOT = Path(__file__).resolve().parents[1]
#: the canned timings: every timer returns these in turn
TIMES = (0.0123456789, 1.5, 2.5e-05, 0.75, 3.0, 0.000987654, 12.125)
SMALL_SPARSE = [(10, 30), (100, 300), (200, 600)]
SMALL_PAIRS = [(10, 30), (10, 45), (30, 90), (30, 435)]
SMALL_SIZES = (10, 30)
SMALL_PROCS = (1, 2, 4)
# which modules' constants are shrunk, and to what
SHRINK = (("PAIRS", SMALL_PAIRS, j_table3, table3_density),
          ("SIZES", SMALL_SIZES, j_fig23, fig23_size_sweep),
          ("PROCS", SMALL_PROCS, j_table4, table4_scaling),
          ("PROCS", SMALL_PROCS, j_weak, weak_scaling),
          ("PAPER_SPARSE", SMALL_SPARSE, j_graph, t_graph))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def shrunk(monkeypatch):
    for name, value, *mods in SHRINK:
        for mod in mods:
            monkeypatch.setattr(mod, name, value)


class Canned:
    """One module's timers: ``time_engine`` and the P-rank runner, both
    returning TIMES in turn; the P-rank runs asked for are recorded."""

    def __init__(self):
        self.times = itertools.cycle(TIMES)
        self.runs = []

    def time_engine(self, fn, **kw):
        fn()
        return next(self.times)

    def stdout(self, args, procs):
        flags = dict(zip(args[::2], args[1::2]))
        self.runs.append((flags["--engine"], flags["--nodes"],
                          flags["--edges"], flags["--repeats"], procs))
        return (f"engine={flags['--engine']} corpus=random "
                f"n={flags['--nodes']} procs={procs} "
                f"time={next(self.times):.6f}s\n")

    def run_with_devices(self, module, args, devices, timeout=900):
        assert dict(zip(args[::2], args[1::2]))["--procs"] == str(devices)
        return self.stdout(args, devices)

    def run_with_procs(self, args, procs, device, timeout=900):
        return self.stdout(args, procs)


def _can(monkeypatch, mods, out_dir, jax: bool) -> Canned:
    c = Canned()
    monkeypatch.setattr(j_common if jax else common, "OUT_DIR", str(out_dir))
    for mod in mods:
        if hasattr(mod, "time_engine"):
            monkeypatch.setattr(mod, "time_engine", c.time_engine)
        runner = "run_with_devices" if jax else "run_with_procs"
        if hasattr(mod, runner):
            monkeypatch.setattr(mod, runner, getattr(c, runner))
    return c


def _csvs(d: Path) -> dict:
    return {p.name: p.read_bytes() for p in sorted(d.glob("*.csv"))}


BENCH_CASES = {
    # name: (JAX module, port module, JAX call, port call, CSVs written)
    "table2": (j_table2, table2_sparse_csr,
               lambda: j_table2.run(False, dense_cap=100),
               lambda: table2_sparse_csr.run(False, dense_cap=100,
                                             device="cpu"),
               {"table2_sparse_csr.csv"}),
    "fig23": (j_fig23, fig23_size_sweep, lambda: j_fig23.run(False),
              lambda: fig23_size_sweep.run(False, device="cpu"),
              {"fig23_size_sweep.csv", "multisource_amortization.csv"}),
    "table3": (j_table3, table3_density, lambda: j_table3.run(False),
               lambda: table3_density.run(False, device="cpu",
                                          ranks_device="cpu"),
               {"table3_density.csv"}),
    "table4": (j_table4, table4_scaling, lambda: j_table4.run(False),
               lambda: table4_scaling.run(False, ranks_device="cpu"),
               {"table4_scaling.csv"}),
    "weak": (j_weak, weak_scaling, lambda: j_weak.run(False),
             lambda: weak_scaling.run(False, ranks_device="cpu"),
             {"weak_scaling.csv"}),
}


@pytest.mark.parametrize("name", list(BENCH_CASES))
def test_bench_csv_is_byte_identical_to_jax(name, shrunk, monkeypatch,
                                            tmp_path):
    j_mod, t_mod, j_call, t_call, files = BENCH_CASES[name]
    jc = _can(monkeypatch, [j_mod], tmp_path / "jax", jax=True)
    j_call()
    tc = _can(monkeypatch, [t_mod], tmp_path / "torch", jax=False)
    t_call()
    want = _csvs(tmp_path / "jax")
    assert set(want) == files
    assert _csvs(tmp_path / "torch") == want
    assert tc.runs == jc.runs                  # the same P-rank legs
    if name == "table2":
        assert b",skipped," in want["table2_sparse_csr.csv"]
    # the port records which device each column ran on
    meta = (tmp_path / "torch" / (sorted(files)[0][:-4] + ".meta.json"))
    assert "cpu" in meta.read_text()


def test_run_writes_the_jax_set_byte_identical(shrunk, monkeypatch,
                                               tmp_path):
    mods = [j_table3, j_table4, j_fig23, j_weak]
    jc = _can(monkeypatch, mods, tmp_path / "jax", jax=True)
    monkeypatch.setattr(sys, "argv", ["run", "--quick", "--only",
                                      "table3,table4,fig23,weak"])
    with pytest.raises(SystemExit) as e:
        j_run.main()
    assert e.value.code == 0
    tc = _can(monkeypatch, [table3_density, table4_scaling, fig23_size_sweep,
                            weak_scaling], tmp_path / "torch", jax=False)
    assert run.main(["--quick", "--device", "cpu",
                     "--ranks-device", "cpu"]) == 0
    want = _csvs(tmp_path / "jax")
    assert len(want) == 5
    assert _csvs(tmp_path / "torch") == want
    assert tc.runs == jc.runs


def _same(a, b, pred=True):
    assert a.dist.tobytes() == b.dist.tobytes()
    if pred:
        assert np.array_equal(a.pred, b.pred)


@pytest.mark.parametrize("table", ["table2", "table3", "fig23"])
def test_engines_match_jax_on_the_tables_graphs(table):
    """The single-device columns' engines, on each table's own graphs at
    the test sizes: dist bitwise, pred equal."""
    if table == "table2":
        for n, m in SMALL_SPARSE:
            jg = j_csr.random_csr_graph(n, m, seed=n + m)
            tg = t_csr.random_csr_graph(n, m, seed=n + m)
            for g_j, g_t, engine in ((jg, tg, "bellman_csr"),
                                     (jg.to_dense(), tg.to_dense(),
                                      "bellman")):
                _same(j_sp(g_j, 0, engine=engine),
                      t_sp(g_t, 0, engine=engine, device="cpu"))
        return
    graphs = ([(j_graph.random_graph(n, m, seed=n + m),
                t_graph.random_graph(n, m, seed=n + m))
               for n, m in SMALL_PAIRS] if table == "table3" else
              [(j_graph.sparse_graph(n, seed=n), t_graph.sparse_graph(n, seed=n))
               for n in SMALL_SIZES])
    for jg, tg in graphs:
        for engine in ("serial", "bellman"):
            _same(j_sp(jg, 0, engine=engine),
                  t_sp(tg, 0, engine=engine, device="cpu"))
    if table == "fig23":
        n = SMALL_SIZES[-1]
        jg, tg = (j_graph.sparse_graph(n, seed=1),
                  t_graph.sparse_graph(n, seed=1))
        for s in (1, 4, 16, 64):
            srcs = np.arange(s) % n
            _same(j_sp(jg, srcs, engine="multisource"),
                  t_sp(tg, srcs, engine="multisource", device="cpu"),
                  pred=False)


def test_sharded_legs_on_gloo_ranks_match_jax(tmp_path):
    """The MPI-analogue columns for real: ``sssp_run --procs P`` on gloo
    ranks through run_with_procs, on the graph the legs solve
    (``random_graph(n, m, seed=0)``).  dijkstra_sharded against JAX's at
    P = 1 and JAX's serial at P = 2; bellman_sharded against JAX's
    single-device bellman (JAX's own raises at P > 1)."""
    from repro.core._compat import make_mesh

    import jax

    n, m = SMALL_PAIRS[2]
    legs = [(e, p) for e in ("dijkstra_sharded", "bellman_sharded")
            for p in (1, 2)]

    def leg(engine, procs):
        path = tmp_path / f"{engine}-{procs}.npz"
        out = common.run_with_procs(
            ["--engine", engine, "--nodes", str(n), "--edges", str(m),
             "--repeats", "1", "--save", str(path)], procs, "cpu",
            timeout=300)
        assert re.search(r"time=([\d.e+-]+)s", out), out
        return np.load(path)

    with ThreadPoolExecutor(len(legs)) as ex:
        got = dict(zip(legs, ex.map(lambda a: leg(*a), legs)))
    g = j_graph.random_graph(n, m, seed=0)
    mesh = make_mesh((1,), ("data",), devices=jax.devices()[:1])
    refs = {("dijkstra_sharded", 1): j_sp(g, 0, engine="dijkstra_sharded",
                                          mesh=mesh),
            ("dijkstra_sharded", 2): j_sp(g, 0, engine="serial")}
    refs[("bellman_sharded", 1)] = refs[("bellman_sharded", 2)] = j_sp(
        g, 0, engine="bellman")
    for key, ref in refs.items():
        assert got[key]["dist"].tobytes() == np.asarray(
            ref.dist, np.float32).tobytes(), key
        assert np.array_equal(got[key]["pred"], ref.pred), key


def _weak_csv(d: Path) -> str:
    d.mkdir(parents=True, exist_ok=True)
    path = d / "weak_scaling.csv"
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["engine", "procs", "nodes", "time_s",
                    "weak_efficiency_pct"])
        w.writerows([["dijkstra_sharded", 1, 512, "0.100000", "100.00"],
                     ["dijkstra_sharded", 2, 1024, "0.400000", "25.00"]])
    return str(path)


@pytest.mark.parametrize("table", ["bench_tables", "serve_table",
                                   "dynamic_table", "tune_table",
                                   "weak_scaling_table"])
def test_experiments_tables_equal_jax_but_the_heading(table, tmp_path):
    src = {"bench_tables": "BENCH_sssp.json", "serve_table": "BENCH_serve.json",
           "dynamic_table": "BENCH_dynamic.json",
           "tune_table": "BENCH_tune.json"}
    path = (str(ROOT / src[table]) if table in src
            else _weak_csv(tmp_path))
    want = getattr(j_md, table)(path).split("\n")
    got = getattr(make_experiments_md, table)(path).split("\n")
    assert len(got) == len(want) > 3
    assert got[1:] == want[1:]
    assert got[0] != want[0]
    assert ("torch" in got[0]) if table in src else got[0].startswith(
        "run not recorded")


def test_make_experiments_md_writes_every_section_with_the_card(
        monkeypatch, tmp_path):
    out_dir = tmp_path / "bench"
    _weak_csv(out_dir)
    (out_dir / "weak_scaling.meta.json").write_text(
        '{"torch": "2.11.0+cu128", "device": "cpu", "device_name": '
        '"NVIDIA H100 80GB HBM3", "power_limit": "700.00 W", '
        '"columns": {"time_s": "P gloo ranks on cpu"}}')
    md = tmp_path / "EXPERIMENTS_torch.md"
    monkeypatch.setattr(common, "OUT_DIR", str(out_dir))
    monkeypatch.setattr(make_experiments_md, "MD", str(md))
    assert make_experiments_md.MD != str(ROOT / "EXPERIMENTS.md")
    make_experiments_md.main()
    text = md.read_text()
    for name in ("sssp-bench", "serve-bench", "dynamic-bench", "tune-bench",
                 "weak-scaling"):
        head = text.split(f"<!-- BEGIN GENERATED:{name} -->\n")[1]
        head = head.split("\n")[0]
        assert head.startswith("torch 2.11.0+cu128 on NVIDIA H100 80GB "
                               "HBM3"), (name, head)
        assert "700.00 W" in head, (name, head)
    assert "P gloo ranks on cpu" in text
    # hand-written text outside the markers stays; a rerun changes nothing
    md.write_text(text + "\nhand-written note\n")
    make_experiments_md.main()
    assert md.read_text() == text + "\nhand-written note\n"


def _dryrun_record(arch, shape, mesh, *, dot, traffic, gathered,
                   model_flops):
    """A record as ``repro_torch.launch.dryrun.run_cell`` writes one."""
    from repro_torch.launch import cost_analysis as C
    ws = C.WeightedStats(dot_flops=dot, vector_flops=dot / 100,
                         traffic_bytes=traffic)
    ws.collective_bytes["all-gather"] = gathered
    ws.collective_count["all-gather"] = 3
    chips = 256 if mesh == "pod" else 512
    rf = C.roofline(ws, chips=chips, model_flops=model_flops)
    return {"arch": arch, "shape": shape, "mesh": mesh, "chips": chips,
            "kind": "train", "meta": {}, "trace_s": 12.5,
            "memory_analysis": {"argument_size_in_bytes": 2e9,
                                "output_size_in_bytes": 1e9,
                                "temp_size_in_bytes": 90e9,
                                "live_bytes_per_device": 93e9,
                                "fits": False},
            "weighted": ws.to_dict(), "roofline": rf.to_dict(),
            "mfu_fraction": C.mfu_fraction(rf, chips), "overrides": {},
            "traced": {"torch": "2.13.0+cpu", "device": "meta", "rank": 0}}


def test_run_roofline_and_make_experiments_md_write_both_sections(
        monkeypatch, tmp_path, capsys):
    """``run --only roofline`` tabulates the dry-run records (a tagged
    variant left out) and ``make_experiments_md`` writes the dry-run and
    roofline sections from them, each headed by the prediction caption
    and the torch version that traced the records."""
    import json

    from repro_torch.benchmarks import roofline
    recs = tmp_path / "dryrun_torch"
    recs.mkdir()
    for name, rec in (
            ("gemma3-1b__train_4k__pod", _dryrun_record(
                "gemma3-1b", "train_4k", "pod", dot=4e15, traffic=3e12,
                gathered=1e9, model_flops=2e17)),
            ("sssp__bellman_512k__multipod", dict(_dryrun_record(
                "sssp", "bellman_512k", "multipod", dot=0.0, traffic=1e11,
                gathered=4e6, model_flops=None), kind="sssp")),
            ("gemma3-1b__train_4k__pod_variant", _dryrun_record(
                "gemma3-1b", "train_4k", "pod", dot=1.0, traffic=1.0,
                gathered=0.0, model_flops=None))):
        (recs / f"{name}.json").write_text(json.dumps(rec))
    out_dir, md = tmp_path / "bench", tmp_path / "EXPERIMENTS_torch.md"
    monkeypatch.setattr(roofline, "DRYRUN_DIR", str(recs))
    monkeypatch.setattr(common, "OUT_DIR", str(out_dir))
    monkeypatch.setattr(make_experiments_md, "MD", str(md))
    assert run.main(["--only", "roofline", "--device", "cpu"]) == 0
    table = (out_dir / "roofline_table.md").read_text().splitlines()
    assert table[0] == roofline.CAPTION + (
        "  Traced under torch 2.13.0+cpu: each device's bytes and whether "
        "it fits follow that version's DTensor sharding choices.")
    assert "| tensor_s | simt_s |" in table[2]
    rows = [r for r in table if r.startswith("| gemma3-1b")
            or r.startswith("| sssp")]
    assert len(rows) == 2                          # the variant is left out
    assert "| compute |" in rows[0] and "| 93.0 |" in rows[0]
    assert "| memory |" in rows[1]
    assert "worst roofline fractions" in capsys.readouterr().out
    make_experiments_md.main()
    text = md.read_text()
    for name, head in (("dryrun", "| arch | shape | mesh | chips | trace_s"),
                       ("roofline", "| arch | shape | mesh | tensor_s")):
        body = text.split(f"<!-- BEGIN GENERATED:{name} -->\n")[1]
        body = body.split(f"<!-- END GENERATED:{name} -->")[0].splitlines()
        assert body[0] == table[0] and body[2].startswith(head)
        assert len([r for r in body if r.startswith("| gemma3-1b")
                    or r.startswith("| sssp")]) == 2
    assert "| 12.5 | 93.0 | NO | 1.00 |" in text


def test_run_failing_bench_exits_1(monkeypatch, tmp_path):
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))

    def boom(*a, **kw):
        raise RuntimeError("bench failed")

    monkeypatch.setattr(fig23_size_sweep, "run", boom)
    assert run.main(["--quick", "--only", "fig23", "--device", "cpu"]) == 1


@pytest.mark.parametrize("call", ["run_with_procs", "table3", "table4",
                                  "weak"])
def test_cuda_ranks_without_the_gpus_raise(call, monkeypatch, shrunk,
                                           tmp_path):
    """P CUDA ranks on a machine with fewer GPUs raise _dist's error before
    any process starts; nothing moves to the CPU."""
    monkeypatch.setattr(common, "OUT_DIR", str(tmp_path))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(common.subprocess, "run", None)   # must not start
    calls = {
        "run_with_procs": lambda: common.run_with_procs(
            ["--engine", "dijkstra_sharded"], 8, "cuda"),
        "table3": lambda: table3_density.run(True, device="cpu",
                                             ranks_device="cuda"),
        "table4": lambda: table4_scaling.run(True, ranks_device="cuda"),
        "weak": lambda: weak_scaling.run(True, ranks_device="cuda"),
    }
    with pytest.raises(RuntimeError, match=r"NCCL group of \d+ needs"):
        calls[call]()
    assert not list(tmp_path.glob("*.csv"))


@pytest.mark.parametrize("module", [table2_sparse_csr, fig23_size_sweep,
                                    table3_density])
def test_entry_points_default_to_cuda(module):
    """Without --device the benches run on CUDA, which raises here."""
    with pytest.raises(RuntimeError, match="needs a CUDA GPU"):
        module.main(["--quick"])


def test_out_dir_is_the_ports_own():
    assert common.OUT_DIR.endswith("experiments/bench_torch")
    assert common.OUT_DIR != j_common.OUT_DIR
    assert "experiments/bench_torch/" in (ROOT / ".gitignore").read_text()
    assert make_experiments_md.MD.endswith("EXPERIMENTS_torch.md")
