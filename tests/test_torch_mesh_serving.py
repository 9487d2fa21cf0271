"""Serving on a DTensor mesh of gloo ranks, parameters laid out by their
specs as the dry run lays them out (repro_torch.launch.dryrun): prefill
into caches laid out by theirs (``rules.zeros_on_mesh``), then decode
steps writing each rank's block of them (``attention.write_at``,
``ssm._ssm_decode_mesh``), against the same steps on one device and
against the JAX package's ``prefill`` / ``decode_step``.

The smoke configs (f32, f32 caches: a bf16 cache rounds the mesh's
partial sums apart from one device's) of gemma3-1b (one KV head, the
expanded-KV layout), qwen2-moe (``expert_pad_to=8``) and mamba2-130m get
JAX's parameters with their zero-initialised leaves drawn
(``test_torch_lm_models``'s ``carried_params``), carried into the port by
``from_jax_params``.  Bounds, fixed before measuring, on a (data, model)
= (2, 2) mesh of four gloo ranks:

- prefill's logits and four decode steps' logits within 1e-5 x their
  largest entry of the port's single device's under the abstract (2, 2)
  mesh; every rank's values equal;
- the same logits within 1e-4 (max abs err) of JAX's on the same tokens,
  the port's f32 serving bound (``test_torch_lm_serve.py``).  On the mesh
  the MoE dispatches one group a data shard, each with its own capacity,
  as JAX's does on a mesh (``_num_groups``); JAX's reference runs off a
  mesh, in one group, so at the default capacity factor other assignments
  drop.  The MoE case held to JAX therefore runs with
  ``capacity_factor=64`` (no assignment drops, as in JAX's
  ``test_decode_matches_forward``), beside the default one held to one
  device.

The caches hold 20 positions, so gemma3-1b's (one KV head, which the
model axis cannot split) split the sequence over "model" and each decode
write lands on one rank's block.  JAX runs in the test's process only:
the ranks get numpy parameters and tokens.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, make_smoke
from repro_torch.core._dist import spawn
from repro_torch.models import transformer as PT
from repro_torch.models.convert import from_jax_params
from repro_torch.sharding import rules

#: case -> (arch, config overrides of both packages)
CASES = {"gemma3-1b": ("gemma3-1b", {}),
         "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", {}),
         "qwen2-moe-a2.7b/no-drop": ("qwen2-moe-a2.7b",
                                     {"capacity_factor": 64.0}),
         "mamba2-130m": ("mamba2-130m", {})}
#: the cases held to JAX (module doc)
JAX_CASES = ("gemma3-1b", "qwen2-moe-a2.7b/no-drop", "mamba2-130m")
SHAPE = (2, 2)
B, S, STEPS = 4, 16, 4
TOL = 1e-5
JAX_TOL = 1e-4


def _cfg(cfg, case):
    if cfg.num_experts:
        cfg = dataclasses.replace(cfg, expert_pad_to=8)
    return dataclasses.replace(cfg, **CASES[case][1])


def _jax_inputs(case):
    """JAX's smoke config, its carried numpy parameters, the prompt and
    the decode tokens (int32, numpy)."""
    from repro.configs import get_config as jax_config
    from repro.configs import make_smoke as jax_smoke
    from test_torch_lm_models import carried_params

    jcfg = _cfg(jax_smoke(jax_config(CASES[case][0])), case)
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    steps = [rng.integers(0, jcfg.vocab_size, (B, 1)).astype(np.int32)
             for _ in range(STEPS)]
    return jcfg, carried_params(jcfg), prompt, steps


def _port(case, tree):
    cfg = _cfg(make_smoke(get_config(CASES[case][0])), case)
    return cfg, from_jax_params(tree, cfg, "cpu")


def _serve(params, prompt, steps, cfg, place=lambda t: t,
           full=lambda t: t):
    logits, caches, pos = PT.prefill(params, place(torch.from_numpy(prompt)),
                                     cfg, max_len=S + STEPS,
                                     cache_dtype=torch.float32)
    out = [full(logits).detach().numpy()]
    for tok in steps:
        logits, caches, pos = PT.decode_step(
            params, place(torch.from_numpy(tok)), pos, caches, cfg)
        out.append(full(logits).detach().numpy())
    return out


def _jax_serve(jcfg, tree, prompt, steps):
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    params = jax.tree.map(jnp.asarray, tree)
    prefill = jax.jit(lambda p, t: JT.prefill(
        p, t, jcfg, max_len=S + STEPS, cache_dtype=jnp.float32))
    decode = jax.jit(lambda p, t, q, c: JT.decode_step(p, t, q, c, jcfg))
    logits, caches, pos = prefill(params, jnp.asarray(prompt))
    out = [np.asarray(logits)]
    for tok in steps:
        logits, caches, pos = decode(params, jnp.asarray(tok), pos, caches)
        out.append(np.asarray(logits))
    return out


def _serve_rank(group, inputs):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.models.tree import leaves, unflatten

    mesh = init_device_mesh("cpu", SHAPE, mesh_dim_names=("data", "model"))
    full = lambda t: t.full_tensor() if rules.is_dtensor(t) else t
    place = lambda t: distribute_tensor(t, mesh, rules.placements(
        rules.batch_spec(tuple(t.shape), mesh), mesh))
    out = {}
    for case in CASES:
        tree, prompt, steps = inputs[case]
        cfg, params = _port(case, tree)
        specs = leaves(rules.port_param_specs(params, cfg, mesh),
                       is_leaf=lambda x: isinstance(x, rules.Spec))
        dparams = unflatten(params, [
            distribute_tensor(t, mesh, rules.placements(s, mesh))
            for t, s in zip(leaves(params), specs)])
        with torch.no_grad(), rules.set_mesh(mesh):
            out[case] = _serve(dparams, prompt, steps, cfg, place, full)
    return out


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    torch.set_num_threads(1)
    inputs, jax_ref = {}, {}
    for case in CASES:
        jcfg, tree, prompt, steps = _jax_inputs(case)
        inputs[case] = (tree, prompt, steps)
        if case in JAX_CASES:
            jax_ref[case] = _jax_serve(jcfg, tree, prompt, steps)
    got = spawn(_serve_rank, SHAPE[0] * SHAPE[1], backend="gloo",
                store_dir=tmp_path_factory.mktemp("serve"), args=(inputs,),
                timeout=600)
    ref = {}
    with torch.no_grad(), rules.set_mesh(rules.AbstractMesh(
            SHAPE, ("data", "model"))):
        for case in CASES:
            tree, prompt, steps = inputs[case]
            cfg, params = _port(case, tree)
            ref[case] = _serve(params, prompt, steps, cfg)
    return got, ref, jax_ref


@pytest.mark.parametrize("arch", CASES)
def test_prefill_and_decode_on_a_mesh_match_one_device(served, arch):
    got, ref, _ = served
    for rank in got:
        for a, b in zip(rank[arch], ref[arch]):
            assert a.shape == b.shape
            assert np.abs(a - b).max() <= TOL * np.abs(b).max(), arch
    for rank in got[1:]:
        for a, b in zip(rank[arch], got[0][arch]):
            assert np.array_equal(a, b)


@pytest.mark.parametrize("case", JAX_CASES)
def test_prefill_and_decode_on_a_mesh_match_jax(served, case):
    got, _, jax_ref = served
    assert len(jax_ref[case]) == STEPS + 1
    for rank in got:
        assert len(rank[case]) == STEPS + 1
        for step, (a, b) in enumerate(zip(rank[case], jax_ref[case])):
            assert a.shape == b.shape
            err = float(np.abs(a.astype(np.float64) - b).max())
            assert err <= JAX_TOL, (case, step, err)
