"""The port's step counter and H100 roofline (repro_torch.launch.
cost_analysis), held to hand counts and to the JAX package's
``hlo_analysis`` arithmetic.

- one ``mm``, pointwise ops and a reduction, a loop body's weight and the
  memory tally, each counted by hand; the op log (``StepCounter(log=
  True)``) of the pointwise case and ``tools/op_log_diff.py`` on two
  logs;
- the lookup's backward (``aten.embedding_dense_backward``): its rows,
  index and whole gradient, by hand;
- one all-gather and one all-reduce on a fake group of 4 ranks (the
  direct ``c10d`` ops of ``ShardGroup`` and DTensor's functional ones),
  the all-reduce's payload counted twice (once by ``collective_stats``,
  JAX's legacy scan), in a child process (a process holds one default
  group);
- JAX's ``test_roofline_terms_and_dominant`` with the H100 constants;
- ``analytic_train_flops`` / ``analytic_decode_flops`` equal JAX's for all
  ten archs x the four shapes, exactly;
- counts over fake tensors equal counts over real CPU tensors for a smoke
  prefill and a smoke MoE gradient step, exactly (memory too).
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import SHAPES, get_config as jax_config
from repro.launch import hlo_analysis as H
from repro_torch.configs import ARCHS, get_config, make_smoke
from repro_torch.launch import cost_analysis as C

ROOT = Path(__file__).resolve().parents[1]


def _count(fn, *args):
    return C.count_step(fn, *args)


def test_one_mm_counted_by_hand():
    a, b = torch.ones(16, 32), torch.ones(32, 8)
    ws, mem, out = _count(lambda a, b: a @ b, a, b)
    assert ws.dot_flops == 2 * 16 * 32 * 8
    assert ws.vector_flops == 0
    assert ws.traffic_bytes == (16 * 32 + 32 * 8 + 16 * 8) * 4
    assert mem["argument_size_in_bytes"] == (16 * 32 + 32 * 8) * 4
    assert mem["output_size_in_bytes"] == 16 * 8 * 4
    assert mem["live_bytes_per_device"] == (16 * 32 + 32 * 8 + 16 * 8) * 4
    assert mem["temp_size_in_bytes"] == 0 and mem["fits"]


def test_pointwise_and_reduction_counted_by_hand():
    x = torch.ones(100)

    def f(x):
        y = torch.tanh(x) + x          # 100 + 100 pointwise outputs
        return y.sum()                 # a reduction of 100 inputs

    ws, mem, _ = _count(f, x)
    assert ws.vector_flops == 100 + 100 + 100
    assert ws.dot_flops == 0
    # tanh: 400 in, 400 out; add: 800 in, 400 out; sum: 400 in, 4 out
    assert ws.traffic_bytes == 800 + 1200 + 404
    # the peak is at the add: x, tanh(x) and y, 400 bytes each; the
    # temporaries are the peak less the argument and the output
    assert mem["live_bytes_per_device"] == 1200
    assert mem["argument_size_in_bytes"] == 400
    assert mem["output_size_in_bytes"] == 4
    assert mem["temp_size_in_bytes"] == 1200 - 400 - 4
    assert sum(ws.collective_count.values()) == 0


def test_op_log_by_hand_and_its_diff():
    """The pointwise case's log: each op by its input shapes, and at the
    peak (the add) x, tanh(x) and y live, 400 bytes each; two logs of
    steps one op apart differ by that op's calls and by what is live at
    each peak."""
    sys.path.insert(0, str(ROOT / "tools"))
    from op_log_diff import diff

    def log(f):
        c = C.StepCounter(log=True)
        C.count_step(f, torch.ones(100), counter=c)
        return {"ops": c.ops, "peak_by_op": c.peak_by_op}

    a = log(lambda x: (torch.tanh(x) + x).sum())
    assert a["ops"] == {
        "aten.tanh.default[(100,)]": [1, 400, 0.0],
        "aten.add.Tensor[(100,), (100,)]": [1, 400, 0.0],
        "aten.sum.default[(100,)]": [1, 4, 0.0]}
    assert a["peak_by_op"] == {"argument": 400, "aten.tanh.default": 400,
                               "aten.add.Tensor": 400}
    b = log(lambda x: (torch.exp(torch.tanh(x)) + x).sum())
    d = diff(a, b, top=5)
    assert d["peak_bytes"] == [1200, 1200]
    assert d["output_bytes"] == [804, 1204]
    assert [k for k, _ in d["ops_by_output_bytes"]] == [
        "aten.exp.default[(100,)]"]
    # b peaks first at exp (x, tanh(x), exp live), a at the add
    assert sorted(d["peak_by_op"]) == [("aten.add.Tensor", [400, 0]),
                                       ("aten.exp.default", [0, 400])]


def test_views_count_nothing_and_weights_multiply():
    a, b = torch.ones(8, 4), torch.ones(4, 4)
    c = C.StepCounter()

    def f(a, b):
        v = a.view(4, 8).t().reshape(8, 4)     # views only
        with c.weighted(5):
            return v @ b

    ws, _, _ = C.count_step(f, a, b, counter=c)
    assert ws.dot_flops == 5 * 2 * 8 * 4 * 4
    assert ws.traffic_bytes == 5 * (32 + 16 + 32) * 4


def test_gather_and_scatter_read_only_their_rows():
    table = torch.ones(1000, 16)
    idx = torch.tensor([3, 7])

    ws, _, _ = _count(lambda t, i: t.index_select(0, i), table, idx)
    assert ws.traffic_bytes == 2 * 2 * 16 * 4 + 2 * 8
    cache = torch.zeros(1000, 16)
    ws, _, _ = _count(lambda c, i: c.index_put_((i,), torch.ones(2, 16)),
                      cache, idx)
    assert ws.traffic_bytes == 2 * (2 * 8 + 2 * 16 * 4) + 2 * 16 * 4


def test_lookup_backward_writes_the_table_gradient_once():
    """``aten.embedding_dense_backward`` (``F.embedding``'s backward,
    ``models.common.embed``'s): the rows' gradients and the index read,
    the V x d gradient written once (its zero fill); the lookup's
    backward dispatches it, not a zero table and an ``index_put``."""
    from repro_torch.models import common
    V, d = 1000, 16
    g = torch.ones(4, 8, d, dtype=torch.bfloat16)
    idx = torch.zeros(4, 8, dtype=torch.int64)
    ws, _, _ = _count(lambda g, i: torch.ops.aten.embedding_dense_backward(
        g, i, V, -1, False), g, idx)
    assert ws.traffic_bytes == 4 * 8 * d * 2 + 4 * 8 * 8 + V * d * 2
    assert ws.vector_flops == 0

    cfg = make_smoke(get_config("qwen1.5-0.5b"))
    tok = torch.ones(V, d, dtype=torch.bfloat16, requires_grad=True)
    c = C.StepCounter(log=True)
    C.count_step(lambda t, i: torch.autograd.grad(
        common.embed(i, {"tok": t}, cfg).sum(), t)[0], tok, idx, counter=c)
    ops = {k.split("[")[0] for k in c.ops}
    assert {"aten.embedding.default",
            "aten.embedding_dense_backward.default"} <= ops
    assert not {"aten.index.Tensor", "aten.index_put.default",
                "aten.new_zeros.default"} & ops
    assert c.ops["aten.embedding_dense_backward.default"
                 "[(4, 8, 16), (4, 8)]"] == [1, V * d * 2, 0.0]


_COLLECTIVES_CHILD = r"""
import json, sys
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.core._dist import ShardGroup
from repro_torch.launch import cost_analysis as C
from repro_torch.launch.dryrun import fake_world
from repro_torch.sharding.rules import AbstractMesh

out = {}
with fake_world(AbstractMesh((4,), ("data",)), "cpu") as mesh:
    g = ShardGroup(rank=0, size=4, device=torch.device("cpu"), backend="fake")
    t = torch.ones(8)
    for name, fn in (("gather", lambda t: g.all_gather(t)),
                     ("reduce", lambda t: g.all_reduce(t.clone(), "sum"))):
        ws, _, _ = C.count_step(fn, t)
        out[name] = ws.to_dict()
    out["legacy"] = C.collective_stats(lambda t: g.all_reduce(t, "sum"), t)
    d = DTensor.from_local(torch.ones(2, 3), mesh, [Shard(0)],
                           run_check=False)
    ws, _, _ = C.count_step(lambda d: d.redistribute(mesh, [Replicate()])
                            .to_local(), d)
    out["dtensor"] = ws.to_dict()
print(json.dumps(out))
"""


def test_fake_group_collectives_counted_by_kind():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", _COLLECTIVES_CHILD],
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    g, r, d = got["gather"], got["reduce"], got["dtensor"]
    assert g["collective_count"]["all-gather"] == 1
    assert g["collective_bytes"]["all-gather"] == 4 * 8 * 4
    assert g["total_collective_bytes"] == 4 * 8 * 4
    assert r["collective_count"]["all-reduce"] == 1
    assert r["collective_bytes"]["all-reduce"] == 2 * 8 * 4    # doubled
    assert d["collective_count"]["all-gather"] == 1
    assert d["collective_bytes"]["all-gather"] == 8 * 3 * 4
    # JAX's unweighted legacy scan: each payload once, all-reduce too
    legacy = got["legacy"]
    assert legacy["bytes_by_kind"]["all-reduce"] == 8 * 4
    assert legacy["count_by_kind"]["all-reduce"] == 1
    assert legacy["total_bytes"] == 8 * 4


def test_roofline_terms_and_dominant():
    ws = C.WeightedStats()
    ws.dot_flops = C.PEAK_FLOPS            # 1 second of tensor cores
    ws.traffic_bytes = C.HBM_BW * 2        # 2 seconds of HBM
    ws.collective_bytes["all-reduce"] = C.NET_BW * 0.5
    r = C.roofline(ws, chips=4, model_flops=C.PEAK_FLOPS * 2)
    assert r.dominant == "memory"
    assert r.bound_time_s == pytest.approx(2.0)
    assert r.useful_ratio == pytest.approx(0.5)
    assert C.mfu_fraction(r, 4) == pytest.approx(
        (C.PEAK_FLOPS * 2) / (4 * C.PEAK_FLOPS * 2.0))
    ws.vector_flops = C.SIMT_OPS * 3       # 3 seconds on the CUDA cores
    assert C.roofline(ws, chips=4).dominant == "simt"
    assert set(r.to_dict()) >= {"compute_s", "simt_s", "memory_s",
                                "collective_s", "latency_s", "dominant",
                                "bound_time_s"}


def test_h100_constants_are_the_data_sheets():
    assert (C.PEAK_FLOPS, C.SIMT_OPS, C.HBM_BW, C.NET_BW) == (
        989e12, 33.5e12, 3.35e12, 50e9)
    assert C.COLLECTIVES == H.COLLECTIVES


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_flops_equal_jax(arch):
    jcfg, pcfg = jax_config(arch), get_config(arch)
    for shape in SHAPES.values():
        toks = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                     else 1)
        assert C.analytic_train_flops(pcfg, toks) == \
            H.analytic_train_flops(jcfg, toks)
        assert C.analytic_decode_flops(pcfg, toks) == \
            H.analytic_decode_flops(jcfg, toks)


def _fake_vs_real(fn, args):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.models.tree import tree_map
    ws, mem, _ = C.count_step(fn, *args)
    with FakeTensorMode() as fm:
        fargs = tree_map(fm.from_tensor, args)
        fws, fmem, _ = C.count_step(fn, *fargs)
    return (ws.to_dict(), mem), (fws.to_dict(), fmem)


def test_fake_counts_equal_real_on_a_smoke_prefill():
    from repro_torch.models import transformer as T
    cfg = make_smoke(get_config("gemma2-2b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 32),
                         generator=torch.Generator().manual_seed(1))
    real, fake = _fake_vs_real(
        lambda p, t: T.prefill(p, t, cfg, max_len=48), (params, toks))
    assert real == fake
    assert real[0]["dot_flops"] > 0 and real[1]["temp_size_in_bytes"] > 0


def test_fake_counts_equal_real_on_a_smoke_moe_gradient():
    from repro_torch.models import transformer as T
    from repro_torch.train.step import value_and_grad
    cfg = make_smoke(get_config("qwen2-moe-a2.7b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 16),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    real, fake = _fake_vs_real(lambda p, b: value_and_grad(p, b, cfg),
                               (params, batch))
    assert real == fake
    assert real[0]["dot_flops"] > 0
