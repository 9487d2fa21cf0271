"""The port's dry run (repro_torch.launch.dryrun) on small fake meshes.
Every run that needs a process group runs in a child process (a process
holds one default group).

- smoke configs of a dense, an MoE and an SSM arch traced as train_4k
  cells on a fake (2, 2) mesh: the record has JAX's keys, and rank 0's
  parameter and moment argument bytes equal
  ``launch.memory_model.cell_memory``'s ``params_gb`` / ``moments_gb``
  exactly;
- the SSSP cells at n = 1024 on a fake mesh of 4: one ``bellman_sharded``
  sweep is n_pad x loc_n add + min pairs plus one all-gather of
  n_pad x 4 bytes, and Alg. 2's iteration is weighted by n_true;
- the CLI with ``--mesh both``: one record a mesh, and with ``--op-log``
  one op log a mesh whose bytes live at the peak sum to the record's;
- a smoke prefill counts the same on fake CPU and fake meta tensors in
  f32, and in bf16 the meta trace takes the card's tensor-core product
  (``aten.mm.dtype``) where the CPU upcasts;
- the embedding lookup on a fake (2, 2) mesh, its table split by vocab
  over "model": forward and backward all-gather no table rows (an
  indexing lookup did), and the op log's test for such a gather;
- a cell's record names a table gather and the cell fails (an indexing
  lookup patched in);
- ``tools/dryrun_compare.py`` on two hand-made record sets.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.configs import get_config, make_smoke
from repro_torch.launch import cost_analysis as C

ROOT = Path(__file__).resolve().parents[1]
JAX_KEYS = {"memory_analysis", "weighted", "roofline", "mfu_fraction",
            "meta", "overrides"}


def _child(code: str, *args, timeout=300):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code, *args], env=env,
                         capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


_SMALL_CELLS = r"""
import json, sys
from repro_torch import configs
from repro_torch.launch import dryrun, memory_model, specs
from repro_torch.sharding.rules import AbstractMesh

smoke = lambda arch: configs.make_smoke(configs.get_config(arch))
specs.get_config = memory_model.get_config = smoke
mesh = AbstractMesh((2, 2), ("data", "model"))
out = {}
for arch in json.loads(sys.argv[1]):
    rec = dryrun.run_cell(arch, "train_4k", "pod", sys.argv[2], mesh=mesh)
    out[arch] = {"rec": rec, "model": memory_model.cell_memory(
        arch, "train_4k", mesh)}
print(json.dumps(out))
"""


def test_small_train_cells_match_the_memory_model(tmp_path):
    archs = ["qwen1.5-0.5b", "qwen2-moe-a2.7b", "mamba2-130m"]
    got = _child(_SMALL_CELLS, json.dumps(archs), str(tmp_path))
    for arch in archs:
        rec, model = got[arch]["rec"], got[arch]["model"]
        assert JAX_KEYS <= set(rec), arch
        assert {"argument_size_in_bytes", "output_size_in_bytes",
                "temp_size_in_bytes", "live_bytes_per_device",
                "fits"} <= set(rec["memory_analysis"])
        mem = rec["memory_analysis"]
        assert mem["params_bytes"] / 1e9 == model["params_gb"], arch
        assert mem["moments_bytes"] / 1e9 == model["moments_gb"], arch
        assert mem["argument_size_in_bytes"] > (mem["params_bytes"]
                                                + mem["moments_bytes"])
        assert rec["chips"] == 4 and rec["kind"] == "train"
        w = rec["weighted"]
        assert w["dot_flops"] > 0 and w["total_collective_bytes"] > 0
        assert rec["roofline"]["dominant"] in ("compute", "simt", "memory",
                                               "collective", "latency")
        assert 0 < rec["mfu_fraction"] < 1
        assert (tmp_path / f"{arch}__train_4k__pod.json").exists()


_SSSP = r"""
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.core import bellman
from repro_torch.core._dist import ShardGroup
from repro_torch.launch import cost_analysis as C, dryrun
from repro_torch.sharding.rules import AbstractMesh

mesh = AbstractMesh((4,), ("data",))
n = 1024
with dryrun.fake_world(mesh, "cpu"), FakeTensorMode():
    g = ShardGroup(rank=0, size=4, device=torch.device("cpu"),
                   backend="fake")
    adj = torch.empty((n, n // 4))
    dist = bellman.sharded_start(adj, 0)
    ws, _, _ = C.count_step(lambda d, a: bellman.sharded_sweep(d, a, g),
                            dist, adj)
sweep = ws.to_dict()
recs = {sh: dryrun.run_cell("sssp", sh, "pod", None, mesh=mesh,
                            overrides={"n": n})
        for sh in ("bellman_512k", "dijkstra_128k", "multisource_128k")}
print(json.dumps({"sweep": sweep, "recs": recs}))
"""


def test_sssp_cells_at_n_1024_on_four_fake_ranks():
    got = _child(_SSSP)
    n, loc = 1024, 256
    sweep = got["sweep"]
    # the block's add + min pairs, then min with the owned labels, then
    # the change flag (!= and any over the replicated vector)
    assert sweep["vector_flops"] == 2 * n * loc + loc + 2 * n
    assert sweep["collective_count"]["all-gather"] == 1
    assert sweep["collective_bytes"]["all-gather"] == n * 4
    assert sweep["dot_flops"] == 0
    recs = got["recs"]
    dj = recs["dijkstra_128k"]
    # two all-gathers a MINLOC (allgather variant) an iteration, n_true
    # iterations, and the finish's two gathers
    assert dj["meta"]["n"] == n and dj["chips"] == 4
    assert dj["weighted"]["collective_count"]["all-gather"] == 2 * n + 2
    bf = recs["bellman_512k"]
    assert bf["memory_analysis"]["adjacency_bytes"] == n * loc * 4
    assert bf["memory_analysis"]["argument_size_in_bytes"] == n * loc * 4
    assert bf["weighted"]["collective_count"]["all-gather"] == 2
    ms = recs["multisource_128k"]
    assert ms["weighted"]["collective_bytes"]["all-gather"] == 64 * n * 4
    for r in recs.values():
        assert JAX_KEYS <= set(r) and r["mfu_fraction"] is None


def test_cli_writes_one_record_a_mesh(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "sssp",
         "--shape", "bellman_512k", "--mesh", "both", "--override",
         "n=1024", "--out", str(tmp_path), "--tag", "_t", "--op-log"],
        env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.count("[ok] sssp") == 2
    for mesh, chips in (("pod", 256), ("multipod", 512)):
        rec = json.loads((tmp_path / f"sssp__bellman_512k__{mesh}_t.json")
                         .read_text())
        assert rec["chips"] == chips and rec["overrides"] == {"n": 1024}
        assert rec["traced"]["device"] == "meta"
        assert rec["constants"]["peak_flops"] == C.PEAK_FLOPS
        log = json.loads((tmp_path / f"sssp__bellman_512k__{mesh}_t.ops.json")
                         .read_text())
        assert sum(log["peak_by_op"].values()) == (
            rec["memory_analysis"]["live_bytes_per_device"])
        assert any(k.startswith("c10d.") for k in log["ops"])


def test_trace_counts_do_not_depend_on_the_fake_device():
    """A smoke prefill traced with fake CPU tensors and with fake meta
    tensors (the dry run's): in f32 the same counts and memory; in bf16
    the meta trace runs the card's tensor-core product (``aten.mm.dtype``,
    f32 out) and the CPU trace the upcast one.  (chip_smoke's dryrun phase
    holds a meta trace's counts to those over real CUDA tensors.)"""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import TorchDispatchMode

    from repro_torch.models import transformer as T

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.add(func)
            return func(*args, **(kwargs or {}))

    smoke = make_smoke(get_config("gemma2-2b"))
    got, seen = {}, {}
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(smoke, param_dtype=dtype)
        for dev in ("cpu", "meta"):
            with FakeTensorMode(allow_non_fake_inputs=True), Ops() as ops:
                params = _like(T.init_params(cfg, None, "meta"), dev)
                toks = torch.zeros((2, 32), dtype=torch.int32, device=dev)
                ws, mem, _ = C.count_step(
                    lambda p, t: T.prefill(p, t, cfg, max_len=48),
                    params, toks)
            got[dtype, dev] = (ws.to_dict(), mem)
            seen[dtype, dev] = torch.ops.aten.mm.dtype in ops.seen
    assert got["float32", "cpu"] == got["float32", "meta"]
    assert got["float32", "cpu"][0]["dot_flops"] > 0
    assert seen == {("float32", "cpu"): False, ("float32", "meta"): False,
                    ("bfloat16", "cpu"): False, ("bfloat16", "meta"): True}
    assert (got["bfloat16", "meta"][0]["dot_flops"]
            == got["bfloat16", "cpu"][0]["dot_flops"])


def _like(tree, dev):
    from repro_torch.models.tree import tree_map
    return tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device=dev), tree)


_LOOKUP = r"""
import json
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch import configs
from repro_torch.launch import cost_analysis as C, dryrun
from repro_torch.models import common
from repro_torch.sharding import rules
from repro_torch.sharding.rules import AbstractMesh

mesh = AbstractMesh((2, 2), ("data", "model"))
out = {}
with dryrun.fake_world(mesh, "cuda") as dm, \
        FakeTensorMode(allow_non_fake_inputs=True):
    for arch in ("qwen1.5-0.5b", "gemma3-1b"):
        cfg = configs.make_smoke(configs.get_config(arch))
        V, d = cfg.vocab_size, cfg.d_model
        spec = rules.spec_for_param((("key", "embed"), ("key", "tok")),
                                    (V, d), mesh)
        tok = dryrun._fake_leaf(torch.empty((V, d), device="meta"), spec,
                                dm, "meta").requires_grad_()
        toks = dryrun._fake_leaf(
            torch.empty((4, 24), dtype=torch.int32, device="meta"),
            rules.batch_spec((4, 24), mesh), dm, "meta")

        def step(tok, toks):
            x = common.embed(toks, {"tok": tok}, cfg)
            (g,) = torch.autograd.grad(x.float().sum(), tok)
            return x, g

        counter = C.StepCounter()
        with rules.set_mesh(dm):
            ws, _, (x, g) = C.count_step(step, tok, toks, counter=counter)
        coll = dryrun.by_axis(counter.collective_outputs, dm)
        out[arch] = dict(
            vocab=V, spec=list(spec), x=list(x.shape), g=list(g.shape),
            gathers=coll.get("all-gather", {}),
            table=dryrun.table_gathers(coll, V, 2))
print(json.dumps(out))
"""


def test_vocab_split_lookup_gathers_no_table():
    """``models.common.embed`` on a fake (2, 2) mesh, the smoke table laid
    out by ``tok``'s spec (vocab over "model", d over "data") and tokens
    by batch: forward and backward issue no all-gather of the table's
    vocab rows (JAX's ``jnp.take``: each rank's rows, then a sum)."""
    got = _child(_LOOKUP)
    for arch, r in got.items():
        assert r["spec"] == ["model", "data"], arch
        assert r["x"] == [4, 24, 64] and r["g"] == [r["vocab"], 64], arch
        assert r["gathers"], arch          # the tokens are gathered
        assert r["table"] == [], (arch, r["gathers"])


_GATHERING_CELL = r"""
import json, sys
from repro_torch import configs
from repro_torch.launch import dryrun, specs
from repro_torch.models import common
from repro_torch.sharding.rules import AbstractMesh, constrain

specs.get_config = lambda arch: configs.make_smoke(configs.get_config(arch))
mesh = AbstractMesh((2, 2), ("data", "model"))
out = {"ok": dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "pod",
                             sys.argv[1], mesh=mesh)["table_gathers"]}
# the lookup as an index, as it was before it became F.embedding
common.embed = lambda tokens, params, cfg: constrain(params["tok"][tokens],
                                                     "hidden")
try:
    dryrun.run_cell("qwen1.5-0.5b", "decode_32k", "pod", sys.argv[1],
                    mesh=mesh, tag="_indexed")
    out["raised"] = None
except RuntimeError as e:
    out["raised"] = str(e)
with open(sys.argv[1] + "/qwen1.5-0.5b__decode_32k__pod_indexed.json") as f:
    out["indexed"] = json.load(f)["table_gathers"]
print(json.dumps(out))
"""


def test_run_cell_fails_a_cell_that_gathers_its_table(tmp_path):
    """A smoke decode cell on a fake (2, 2) mesh: its record's
    ``table_gathers`` is empty; with the lookup an index into the table,
    the record names the gather of the (V / 2, d) block over "model" and
    the cell raises after writing it."""
    got = _child(_GATHERING_CELL, str(tmp_path))
    gather = "model: (128, 32) -> (256, 32)"
    assert got["ok"] == []
    assert got["indexed"] == [gather]
    assert got["raised"] is not None and gather in got["raised"]


def test_table_gathers_reads_the_axis():
    """A gather over "model" of a (V / tp, .) block or its transpose is the
    table's; the same block over "data" (its d-split: the collective
    gathers along dim 0, so its output has V rows when the axes are of
    one size) and a 3-D logits block are not."""
    from repro_torch.launch.dryrun import table_gathers
    coll = {"all-gather": {
        "model: (16384, 72) -> (262144, 72)": 1,
        "model: (72, 16384) -> (1152, 16384)": 1,
        "data: (16384, 72) -> (262144, 72)": 3,
        "model: (16, 512, 16384) -> (256, 512, 16384)": 2,
        "model: (8, 1) -> (128, 1)": 1}, "all-reduce": {
        "model: (16384, 72) -> (16384, 72)": 1}}
    assert table_gathers(coll, 262144, 16) == [
        "model: (16384, 72) -> (262144, 72)",
        "model: (72, 16384) -> (1152, 16384)"]
    assert table_gathers(coll, 262144, 8) == []
    assert table_gathers({}, 262144, 16) == []


def test_dryrun_compare_names_each_difference(tmp_path):
    """``tools/dryrun_compare.py`` on two hand-made record sets: equal dot
    flops, the figures above 1% apart named, and the op whose output
    bytes differ from the op logs (``tools/op_log_diff.py``'s diff)."""
    sys.path.insert(0, str(ROOT / "tools"))
    from dryrun_compare import compare

    def rec(torch_v, gb, ag):
        return {"traced": {"torch": torch_v},
                "memory_analysis": {"live_bytes_per_device": gb * 1e9},
                "weighted": {"dot_flops": 10.0, "collective_bytes": {
                    "all-gather": ag * 1e9, "all-reduce": 1e9}}}
    ops = {"_c10d_functional.all_gather_into_tensor.default[(4, 8)]":
           [2, 100, 0.0], "aten.mm.default[(4, 8), (8, 8)]": [1, 64, 10.0]}
    peak = {"argument": 256, "aten.mm.default": 64}
    for d, (v, gb, ag, calls) in {"a": ("2.13", 10.0, 5.0, 2),
                                  "b": ("2.11", 10.05, 6.0, 7)}.items():
        (tmp_path / d).mkdir()
        (tmp_path / d / "x__decode_32k__pod.json").write_text(
            json.dumps(rec(v, gb, ag)))
        log = dict(ops)
        log["_c10d_functional.all_gather_into_tensor.default[(4, 8)]"] = [
            calls, 50 * calls, 0.0]
        (tmp_path / d / "x__decode_32k__pod.ops.json").write_text(
            json.dumps({"ops": log, "peak_by_op": peak}))
    lines, summary = compare(str(tmp_path / "a"), str(tmp_path / "b"))
    (line,) = lines
    assert line["torch"] == ["2.13", "2.11"] and line["dot_flops_equal"]
    assert line["differ"] == ["all-gather_gb"]       # 0.5% GB is not
    assert line["top_ops"] == [(
        "_c10d_functional.all_gather_into_tensor.default[(4, 8)]",
        [[2, 100, 0.0], [7, 350, 0.0]])]
    assert summary["figures_differ"] == ["x__decode_32k__pod"]
    assert summary["dot_flops_differ"] == []
