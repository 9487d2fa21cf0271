"""The port's models on DTensor meshes of gloo ranks (repro_torch.models
under ``sharding.rules.set_mesh`` of a ``DeviceMesh``) against the same
models on one device, on the CPU; and its expert-parallel MoE against
JAX's ``moe_ep`` on an Auto-axes mesh.

Bounds, fixed before measuring:

- meshes (data, model) = (1, 2), (2, 1), (2, 2), one ``_dist.spawn`` a
  mesh shape with every check inside it;
- gemma3-1b (1 KV head of 4: each model rank attends 2 heads of the
  shared KV head; the single device under the abstract (1, 2) mesh takes
  the expanded-KV branch), qwen1.5-0.5b, qwen2-moe (``expert_pad_to=8``) and
  mamba2-130m smoke configs in f32, parameters and batch replicated over
  the mesh: the final hidden states within 1e-5 x their largest entry,
  ``train_loss`` within 1e-5 relative, every gradient leaf within 1e-5 x
  its largest entry, of the single device's under an abstract mesh of
  the same shape (the MoE's groups are the data shards, as JAX's are);
  every rank's values equal;
- the same f32 cases with the parameters laid out by their specs
  (``rules.port_param_specs``; a tied table split by vocab over "model"
  and d over "data") and the batch by data: ``train_loss`` and every
  gradient leaf within the bounds above, each gradient in its
  parameter's layout;
- the same four archs in bf16 on each mesh, a second witness of the
  gradient reduction where rounding keeps the mesh from matching one
  device: each leaf's gradient against the f32 gradient of the same
  (bf16-valued) parameters, by Frobenius norm relative to the f32
  leaf's; the mesh's worst leaf within BF16_FACTOR = 2 times one
  device's worst leaf.  A gradient scaled by 2 reads 1 there and one
  that misses a rank's partial sum about 0.7, against one device's
  bf16 rounding of a few hundredths (more for qwen2-moe, whose bf16
  routing picks other experts than f32's for some tokens);
- the expert-parallel path (qwen2-moe smoke, ``expert_pad_to=8``, x of
  (4, 512): 1024 tokens or more a data shard, so ``moe`` takes it)
  against the grouped path on one device: output within 2e-3 and aux
  within 1e-4 (JAX's bounds, tests/test_integration.py:200), gradients
  within 1e-5 x their largest entry; and against JAX's ``moe_ep`` in a
  JAX child process with four host devices on an Auto-axes mesh of the
  same shape, within 2e-3 / 1e-4;
- the expanded-KV branch on one device under an abstract (1, 2) mesh
  equal to the grouped branch within 1e-6;
- ``core._dist.install_gloo_cuda_gather`` (the route of DTensor's
  all-gathers for gloo ranks on a card), forced onto CPU tensors: the
  redistributions that gather equal torch's own bitwise, and gemma3-1b
  smoke's loss and gradients on a (1, 2) mesh through it within the
  bounds above.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, make_smoke
from repro_torch.core._dist import spawn
from repro_torch.models import attention as pattn
from repro_torch.models import transformer as PT
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.tree import leaves, tree_map
from repro_torch.sharding import rules
from repro_torch.train.step import value_and_grad

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("gemma3-1b", "qwen1.5-0.5b", "qwen2-moe-a2.7b", "mamba2-130m")
MESHES = [(1, 2), (2, 1), (2, 2)]
TOL = 1e-5
EP_OUT, EP_AUX = 2e-3, 1e-4
EP_X = (4, 512)
BF16_FACTOR = 2.0


def _cfg(arch):
    cfg = make_smoke(get_config(arch))
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, expert_pad_to=8)
    return cfg


def _inputs(arch):
    cfg = _cfg(arch)
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab_size, (4, 16))
    batch = {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(np.roll(tok, -1, 1))}
    return cfg, params, batch


def _bf16_inputs(arch):
    """``_inputs`` in bf16, and the f32 config for the same values."""
    cfg, _, batch = _inputs(arch)
    cfg = dataclasses.replace(cfg, param_dtype="bfloat16")
    params = PT.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return cfg, params, batch, dataclasses.replace(cfg,
                                                   param_dtype="float32")


def _f32(tree):
    return [t.detach().float().numpy() for t in leaves(tree)]


def _ep_inputs():
    cfg = _cfg("qwen2-moe-a2.7b")
    p = init_moe(cfg, torch.Generator().manual_seed(2), "cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        EP_X + (cfg.d_model,)).astype(np.float32))
    return cfg, p, x


def _np(tree):
    return [t.detach().numpy().copy() for t in leaves(tree)]


def _reference(shape):
    """The single device's hidden, loss and gradients of each arch, and
    the grouped MoE's output, aux and gradients, under an abstract mesh
    of ``shape``."""
    out = {}
    with rules.set_mesh(rules.AbstractMesh(shape, ("data", "model"))):
        for arch in ARCHS:
            cfg, params, batch = _inputs(arch)
            hidden = PT.forward(params, batch["tokens"], cfg)[0]
            loss, _, grads = value_and_grad(params, batch, cfg)
            out[arch] = (hidden.numpy(), float(loss), _np(grads))
            cfg, params, batch, c32 = _bf16_inputs(arch)
            one = value_and_grad(params, batch, cfg)[2]
            f32 = value_and_grad(tree_map(lambda t: t.float(), params),
                                 batch, c32)[2]
            out[arch, "bf16"] = (_f32(one), _f32(f32))
        cfg, p, x = _ep_inputs()
        ps = tree_map(lambda t: t.clone().requires_grad_(), p)
        o, aux = moe(ps, x, cfg)
        g = torch.autograd.grad((o ** 2).sum() + aux, leaves(ps))
        out["moe"] = (o.detach().numpy(), float(aux.detach()),
                      [t.numpy() for t in g])
    return out


def _spec_laid(params, batch, cfg, mesh):
    """``params`` laid out by their specs (``rules.port_param_specs``: the
    table split by vocab over "model" and by d over "data") and ``batch``
    by ``rules.batch_spec``, as the dry run's cells are."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.tree import unflatten

    place = lambda t, s: distribute_tensor(t, mesh, rules.placements(s,
                                                                     mesh))
    specs = leaves(rules.port_param_specs(params, cfg, mesh),
                   is_leaf=lambda x: isinstance(x, rules.Spec))
    return (unflatten(params, [place(t, s)
                               for t, s in zip(leaves(params), specs)]),
            {k: place(v, rules.batch_spec(tuple(v.shape), mesh))
             for k, v in batch.items()})


def _mesh_rank(group, shape):
    """Every check's values on this rank of a ``shape`` mesh."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate

    import repro_torch.models.moe as M

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    rep = [Replicate()] * 2
    dt = lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
    full = lambda t: t.full_tensor() if rules.is_dtensor(t) else t
    out = {}
    with rules.set_mesh(mesh):
        for arch in ARCHS:
            cfg, params, batch = _inputs(arch)
            dparams = tree_map(dt, params)
            dbatch = {k: dt(v) for k, v in batch.items()}
            hidden = full(PT.forward(dparams, dbatch["tokens"], cfg)[0])
            loss, _, grads = value_and_grad(dparams, dbatch, cfg)
            out[arch] = (hidden.detach().numpy(), float(full(loss)),
                         [full(g).numpy() for g in leaves(grads)],
                         sorted({str(g.placements) for g in leaves(grads)}))
            cfg, params, batch, _ = _bf16_inputs(arch)
            grads = value_and_grad(tree_map(dt, params),
                                   {k: dt(v) for k, v in batch.items()},
                                   cfg)[2]
            out[arch, "bf16"] = [full(g).float().numpy()
                                 for g in leaves(grads)]
            cfg, params, batch = _inputs(arch)
            loss, _, grads = value_and_grad(*_spec_laid(params, batch, cfg,
                                                        mesh), cfg)
            out[arch, "spec"] = (
                float(full(loss)), [full(g).numpy() for g in leaves(grads)],
                [str(g.placements) for g in leaves(grads)],
                [str(t.placements) for t in leaves(_spec_laid(
                    params, batch, cfg, mesh)[0])])
        cfg, p, x = _ep_inputs()
        calls = []
        ep = M.moe_ep
        M.moe_ep = lambda *a: calls.append(1) or ep(*a)
        try:
            ps = tree_map(lambda t: dt(t).requires_grad_(), p)
            o, aux = moe(ps, dt(x), cfg)
            g = torch.autograd.grad((o ** 2).sum() + aux, leaves(ps))
        finally:
            M.moe_ep = ep
        out["moe"] = (full(o).detach().numpy(), float(full(aux)),
                      [full(t).numpy() for t in g], len(calls))
    return out


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    torch.set_num_threads(1)
    runs = {}
    for shape in MESHES:
        got = spawn(_mesh_rank, shape[0] * shape[1], backend="gloo",
                    store_dir=tmp_path_factory.mktemp("mesh"),
                    args=(shape,), timeout=600)
        runs[shape] = (got, _reference(shape))
    return runs


def _close(a, b, tol):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    return float(np.abs(a - b).max()) <= tol * max(float(np.abs(b).max()),
                                                     1e-30)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_model_on_mesh_matches_one_device(mesh_runs, shape, arch):
    got, ref = mesh_runs[shape]
    hidden, loss, grads = ref[arch]
    r0 = got[0][arch]
    assert _close(r0[0], hidden, TOL)
    assert abs(r0[1] - loss) <= TOL * abs(loss)
    assert len(r0[2]) == len(grads)
    for a, b in zip(r0[2], grads):
        assert _close(a, b, TOL)
    # gradients come back in the parameters' layout, replicated
    assert r0[3] == ["(Replicate(), Replicate())"]
    for other in got[1:]:
        assert other[arch][1] == r0[1]
        for a, b in zip(other[arch][2], r0[2]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_spec_laid_model_on_mesh_matches_one_device(mesh_runs, shape, arch):
    """The parameters laid out by their specs (a tied table split by vocab
    and d, so the lookup's masked partial and its backward run) and the
    batch by data: ``train_loss`` and every gradient leaf within the
    bounds above of one device's, each gradient in its parameter's
    layout, every rank's values equal."""
    got, ref = mesh_runs[shape]
    _, loss, grads = ref[arch]
    r0 = got[0][arch, "spec"]
    assert abs(r0[0] - loss) <= TOL * abs(loss)
    assert len(r0[1]) == len(grads)
    for a, b in zip(r0[1], grads):
        assert _close(a, b, TOL)
    assert r0[2] == r0[3]
    if shape == (2, 2):
        assert "Shard(dim=0)" in r0[3][0], r0[3][0]   # the table is split
    for other in got[1:]:
        assert other[arch, "spec"][0] == r0[0]
        for a, b in zip(other[arch, "spec"][1], r0[1]):
            np.testing.assert_array_equal(a, b)


def _worst_leaf(grads, ref) -> float:
    """The largest ||g - r|| / ||r|| over the leaves."""
    return max(float(np.linalg.norm((g - r).ravel()))
               / max(float(np.linalg.norm(r.ravel())), 1e-30)
               for g, r in zip(grads, ref))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_bf16_gradients_on_mesh_as_close_to_f32_as_one_device(
        mesh_runs, shape, arch):
    got, ref = mesh_runs[shape]
    one, f32 = ref[arch, "bf16"]
    mesh = got[0][arch, "bf16"]
    assert len(mesh) == len(one) == len(f32)
    e_one, e_mesh = _worst_leaf(one, f32), _worst_leaf(mesh, f32)
    assert 0.0 < e_one < 0.5
    assert e_mesh <= BF16_FACTOR * e_one, (e_mesh, e_one)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_moe_ep_on_mesh_matches_grouped(mesh_runs, shape):
    got, ref = mesh_runs[shape]
    out, aux, grads = ref["moe"]
    o, a, g, calls = got[0]["moe"]
    assert calls == 1                     # moe took the expert-parallel path
    assert float(np.abs(o - out).max()) <= EP_OUT
    assert abs(a - aux) <= EP_AUX
    for x, y in zip(g, grads):
        assert _close(x, y, TOL)


_JAX_EP = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro.configs import get_config, make_smoke
from repro.core._compat import set_mesh
from repro.models.moe import moe
import dataclasses
d = np.load(sys.argv[1])
cfg = dataclasses.replace(make_smoke(get_config("qwen2-moe-a2.7b")),
                          expert_pad_to=8)
p = {k: jnp.asarray(d[k]) for k in ("router", "wi_gate", "wi_up", "wo")}
p["shared"] = {k: jnp.asarray(d["shared_" + k])
               for k in ("wi_gate", "wi_up", "wo")}
x = jnp.asarray(d["x"])
res = {}
for shape in json.loads(sys.argv[2]):
    mesh = jax.make_mesh(tuple(shape), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    with set_mesh(mesh):
        o, a = jax.jit(lambda p, x: moe(p, x, cfg))(p, x)
    res[str(tuple(shape))] = (np.asarray(o, np.float32).tolist(), float(a))
print("JAX_EP " + json.dumps(res))
"""


def test_moe_ep_matches_jax_moe_ep(mesh_runs, tmp_path):
    cfg, p, x = _ep_inputs()
    arrays = {k: v.numpy() for k, v in p.items() if k != "shared"}
    arrays.update({"shared_" + k: v.numpy()
                   for k, v in p["shared"].items()})
    np.savez(tmp_path / "in.npz", x=x.numpy(), **arrays)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    r = subprocess.run([sys.executable, "-c", _JAX_EP,
                        str(tmp_path / "in.npz"),
                        json.dumps([list(s) for s in MESHES])],
                       env=env, capture_output=True, text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("JAX_EP ")]
    assert line, r.stdout[-2000:] + r.stderr[-4000:]
    jax_res = json.loads(line[0][len("JAX_EP "):])
    for shape in MESHES:
        o, a, _, calls = mesh_runs[shape][0][0]["moe"]
        jo, ja = jax_res[str(shape)]
        assert calls == 1
        assert float(np.abs(o - np.asarray(jo, np.float32)).max()) <= EP_OUT
        assert abs(a - ja) <= EP_AUX


def test_expanded_kv_branch_matches_grouped_branch():
    """gemma3's 1 KV head of 4 at tp = 2 takes JAX's expanded-KV branch
    (``Sq > 1, G > 1, KV % tp != 0, (KV * G) % tp == 0``); its values are
    the grouped branch's."""
    rng = np.random.default_rng(4)
    B, S, H, KV, hd = 2, 8, 4, 1, 16
    f32 = lambda shape: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32))
    q, k, v = f32((B, S, H, hd)), f32((B, S, KV, hd)), f32((B, S, KV, hd))
    pos = torch.arange(S).expand(B, S)
    kw = dict(q_pos=pos, k_pos=pos, k_valid=torch.ones(B, S, dtype=torch.bool),
              causal=True, window=0, attn_softcap=50.0)
    taken = []
    constrain = pattn.constrain

    def spy(x, rule):
        taken.append(rule)
        return constrain(x, rule)
    pattn.constrain = spy
    try:
        grouped = pattn.attend(q, k, v, **kw)
        with rules.set_mesh(rules.AbstractMesh((1, 2), ("data", "model"))):
            expanded = pattn.attend(q, k, v, **kw)
            # decode (Sq = 1) keeps the grouped branch
            one = pattn.attend(q[:, :1], k, v, **dict(kw, q_pos=pos[:, :1]))
    finally:
        pattn.constrain = constrain
    assert taken == ["scores", "scores_h", "scores"]
    assert float((expanded - grouped).abs().max()) <= 1e-6
    assert float((one - grouped[:, :1]).abs().max()) <= 1e-6


def _shim_rank(group):
    """DTensor gathers and a model's gradients with the gather shim taking
    CPU tensors too (on a card it takes CUDA ones)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    import repro_torch.core._dist as D

    mesh = init_device_mesh("cpu", (1, 2), mesh_dim_names=("data", "model"))
    full = torch.arange(6 * 8, dtype=torch.float32).reshape(6, 8)
    blk = DTensor.from_local(full[:, group.rank * 4:(group.rank + 1) * 4],
                             mesh, [Replicate(), Shard(1)], run_check=False)
    want = [blk.redistribute(mesh, [Replicate(), Replicate()]).to_local(),
            blk.redistribute(mesh, [Replicate(), Shard(0)]).to_local()]
    calls = []
    D._gathers_direct = lambda t: calls.append(1) or True
    D.install_gloo_cuda_gather()
    got = [blk.redistribute(mesh, [Replicate(), Replicate()]).to_local(),
           blk.redistribute(mesh, [Replicate(), Shard(0)]).to_local()]
    n_gathers = len(calls)
    cfg, params, batch = _inputs("gemma3-1b")
    rep = [Replicate()] * 2
    dt = lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
    with rules.set_mesh(mesh):
        loss, _, grads = value_and_grad(tree_map(dt, params),
                                        {k: dt(v) for k, v in batch.items()},
                                        cfg)
    return ([torch.equal(a, b) for a, b in zip(got, want)], n_gathers,
            len(calls), float(loss.full_tensor()),
            [g.full_tensor().numpy() for g in leaves(grads)])


def test_gloo_cuda_gather_route_is_torchs_gather(tmp_path):
    got = spawn(_shim_rank, 2, backend="gloo", store_dir=tmp_path)
    with rules.set_mesh(rules.AbstractMesh((1, 2), ("data", "model"))):
        cfg, params, batch = _inputs("gemma3-1b")
        loss, _, grads = value_and_grad(params, batch, cfg)
    for equal, n_gathers, n_all, mesh_loss, mesh_grads in got:
        assert equal == [True, True]
        assert n_gathers >= 1 and n_all > n_gathers   # the model gathered
        assert abs(mesh_loss - float(loss)) <= TOL * abs(float(loss))
        for a, b in zip(mesh_grads, leaves(grads)):
            assert _close(a, b.numpy(), TOL)
