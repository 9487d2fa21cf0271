"""The layouts that ``repro_torch.sharding.rules`` pins on a mesh, where
DTensor's own choice depends on the torch version: ``rowwise`` (a norm on
each rank's rows), ``relayout`` (a layout in the forward pass only) and
``reduce_partial`` (a scaled lookup's partial sums).

- On a (2, 2) gloo mesh of four ranks, each pinned route in the model
  code against the same code with the helper taken out (what DTensor
  chooses on its own on this torch), with batch-split activations and
  weights laid out by their specs: the forward and every gradient are
  bitwise equal.  (gemma3-1b's norm over its one K head is not among
  them: pinned, it reads the whole head as one device does, where
  DTensor's own route sums the split head's halves; the model tests
  hold it to one device.)  Its op log
  (``launch.cost_analysis.StepCounter``) shows the product's weight
  gathered over "data" and no all-to-all of the activation; the logits
  and the lookup reduced by a reduce-scatter, not an all-reduce.  The
  cases: gemma3-1b smoke's K product in its heads layout (one KV head,
  its head dim split over "model" by the product; train and decode), a
  hidden state's norm, gemma2-2b smoke's capped logits, the MLP's gate
  in a decode step, gemma3-1b smoke's scaled lookup.
- A fake (16, 16) mesh trace of gemma3-1b's train step at full width
  (``launch.dryrun.run_cell`` in a child process), its depth cut to one
  layer of its pattern (``segments=(("L", 1),)``; every layer takes the
  same routes): K's weight gradient is one (d, 256) product a microbatch
  (the whole head), and no all-to-all moves a hidden state inside the
  layer.
"""
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core._dist import spawn

ROOT = Path(__file__).resolve().parents[1]
SHAPE = (2, 2)
B, S = 4, 8


@contextlib.contextmanager
def _unpinned():
    """The pins taken out: DTensor's own routes."""
    from repro_torch.models import common as cm
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.sharding import rules
    saved = [(m, n, getattr(m, n)) for m, n in (
        (cm, "rowwise"), (cm, "relayout"), (cm, "reduce_partial"),
        (mlp_mod, "relayout"), (rules, "relayout"))]
    cm.rowwise = lambda fn, x, *w: fn(x, *w)
    cm.relayout = mlp_mod.relayout = rules.relayout = lambda x, rule: x
    cm.reduce_partial = lambda x: x
    try:
        yield
    finally:
        for m, n, f in saved:
            setattr(m, n, f)


def _cases(mesh):
    """{case: fn() -> (outputs, inputs to differentiate)}, each built from
    seeded numpy draws and laid out as the dry run lays them out."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.configs import get_config, make_smoke
    from repro_torch.models import attention as attn
    from repro_torch.models import common as cm
    from repro_torch.models import mlp as mlp_mod
    from repro_torch.sharding import rules

    rng = np.random.default_rng(0)

    def draw(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32) * 0.5)

    def place(t, spec):
        return distribute_tensor(t, mesh, rules.placements(
            rules.Spec(*spec), mesh)).requires_grad_()

    def batch(t):
        return place(t, rules.batch_spec(tuple(t.shape), mesh))

    def param(t, rule):
        spec = rules.spec_for_param([("key", rule)], tuple(t.shape), mesh)
        return place(t, spec)

    g3 = make_smoke(get_config("gemma3-1b"))
    g2 = make_smoke(get_config("gemma2-2b"))
    d, kv, hd = g3.d_model, g3.num_kv_heads, g3.head_dim
    wk = draw(d, kv, hd)
    x_train, x_step = draw(B, S, d), draw(B, 1, d)
    scale = draw(d)
    table3, table2 = draw(g3.vocab_size, d), draw(g2.vocab_size, d)
    ids = torch.from_numpy(rng.integers(0, g3.vocab_size, (B, S)))
    gate, up, down = draw(d, g3.d_ff), draw(d, g3.d_ff), draw(g3.d_ff, d)

    def k_proj(x):
        # the K product in its heads layout, as _project_kv lays it out
        # before the norm over each head and RoPE
        def run():
            xs, w = batch(x), param(wk, "wk")
            return (rules.relayout(attn._heads(xs, w), "heads"),), [xs, w]
        return run

    def norm():
        xs = batch(x_train)
        s = distribute_tensor(scale, mesh, rules.placements(
            rules.Spec(), mesh)).requires_grad_()
        return (cm.rmsnorm(xs, {"scale": s}, g3.norm_eps),), [xs, s]

    def logits():
        xs, tok = batch(x_train), param(table2, "tok")
        return (cm.unembed(xs, {"tok": tok}, g2),), [xs, tok]

    def mlp_step():
        xs = batch(x_step)
        p = {"wi_gate": param(gate, "wi_gate"), "wi_up": param(up, "wi_up"),
             "wo": param(down, "mlp_wo")}
        return (mlp_mod.mlp(p, xs, g3),), [xs, *p.values()]

    def lookup():
        tok = param(table3, "tok")
        ids_d = DTensor.from_local(ids, mesh, rules.placements(
            rules.Spec(), mesh), run_check=False)
        return (cm.embed(ids_d, {"tok": tok}, g3),), [tok]

    return {"k_train": k_proj(x_train), "k_decode": k_proj(x_step),
            "norm": norm, "logits": logits, "mlp_decode": mlp_step,
            "lookup": lookup}


def _run(fn):
    """Outputs and gradients (full tensors, numpy) of ``fn``'s outputs'
    sum of squares, and the collectives it issued by mesh axis."""
    from repro_torch.launch import cost_analysis as C
    from repro_torch.launch.dryrun import by_axis

    counter = C.StepCounter()
    with counter:
        outs, ins = fn()
        loss = sum((o.float() ** 2).sum() for o in outs)
        grads = torch.autograd.grad(loss, ins)
    mesh = ins[0].device_mesh
    full = lambda t: t.full_tensor().detach().float().numpy()
    return ([full(o) for o in outs], [full(g) for g in grads],
            by_axis(counter.collective_outputs, mesh))


def _layouts_rank(group):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.sharding import rules

    mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=("data", "model"))
    out = {}
    with rules.set_mesh(mesh):
        for name, fn in _cases(mesh).items():
            pinned = _run(fn)
            with _unpinned():
                plain = _run(fn)
            out[name] = {"pinned": pinned, "plain": plain}
    return out


@pytest.fixture(scope="module")
def layouts(tmp_path_factory):
    torch.set_num_threads(1)
    return spawn(_layouts_rank, SHAPE[0] * SHAPE[1], backend="gloo",
                 store_dir=tmp_path_factory.mktemp("layouts"), timeout=600)


def _calls(colls, kind, axis=None):
    return {k: n for k, n in colls.get(kind, {}).items()
            if axis is None or k.startswith(axis + ":")}


CASES = ["k_train", "k_decode", "norm", "logits", "mlp_decode", "lookup"]


@pytest.mark.parametrize("case", CASES)
def test_pinned_route_is_bitwise_dtensors_own(layouts, case):
    for rank in layouts:
        (o1, g1, _), (o0, g0, _) = (rank[case]["pinned"],
                                    rank[case]["plain"])
        assert len(o1) == len(o0) and len(g1) == len(g0)
        for a, b in zip(o1 + g1, o0 + g0):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("case", ["k_train", "k_decode", "logits",
                                  "mlp_decode"])
def test_pinned_product_gathers_its_weight_over_data(layouts, case):
    """The product's weight is gathered over "data" (FSDP), the
    activation keeps its batch split: no all-to-all of the (B, S, d)
    activation."""
    colls = layouts[0][case]["pinned"][2]
    assert _calls(colls, "all-gather", "data"), colls
    for key in _calls(colls, "all-to-all"):
        assert not key.split(": ")[1].startswith(f"({B // SHAPE[0]}, "), key


@pytest.mark.parametrize("case", ["k_train", "norm"])
def test_pinned_route_moves_no_hidden_state(layouts, case):
    colls = layouts[0][case]["pinned"][2]
    assert not _calls(colls, "all-to-all"), colls


@pytest.mark.parametrize("case", ["logits", "lookup"])
def test_partial_sums_reduced_by_reduce_scatter(layouts, case):
    """The capped logits and the scaled lookup reduce their partial sums
    with a reduce-scatter (and, for the lookup, its all-gather), not an
    all-reduce of the whole block."""
    colls = layouts[0][case]["pinned"][2]
    assert _calls(colls, "reduce-scatter"), colls
    fwd = _calls(colls, "all-reduce")
    size = lambda k: int(np.prod(json.loads(
        k.split(" -> ")[1].replace("(", "[").replace(")", "]")
        .replace(",]", "]"))))
    assert all(size(k) < B * S for k in fwd), fwd


_TRACE = r"""
import json, sys
from repro_torch.launch import dryrun
from repro_torch.launch import cost_analysis as C

counter = []
class Logged(C.StepCounter):
    def __init__(self, log=False):
        super().__init__(log=True)
        counter.append(self)
C.StepCounter = Logged
rec = dryrun.run_cell("gemma3-1b", "train_4k", "pod", "",
                      overrides={"segments": (("L", 1),)})
print(json.dumps({"ops": counter[0].ops, "meta": rec["meta"]}))
"""


def test_gemma3_pod_train_k_gradient_whole_and_no_hidden_all_to_all():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    res = subprocess.run([sys.executable, "-c", _TRACE], env=env,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    ops = got["ops"]
    d, hd, seq = 1152, 256, 4096
    micro = got["meta"]["grad_accum"]
    rows = 256 // 16 // micro * seq            # a data rank's microbatch
    # K's weight gradient: the whole head, once a microbatch (V's keeps
    # the product's split over "model": 16 columns)
    assert ops[f"aten.mm.default[({d}, {rows}), ({rows}, {hd})]"][0] == micro
    assert ops[f"aten.mm.default[({d}, {rows}), ({rows}, {hd // 16})]"][
        0] == micro
    # no all-to-all of a hidden state, batch- or d-split, but the
    # lookup's (into the batch split, forward and backward) and the final
    # norm's gradient (from the unembedding's d split): three a microbatch
    hidden = [(k, v[0]) for k, v in ops.items()
              if k.startswith("_dtensor.shard_dim_alltoall")
              and (f", {seq}, {d})" in k or f", {seq}, {d // 16})" in k)]
    assert sum(n for _, n in hidden) == 3 * micro, hidden
