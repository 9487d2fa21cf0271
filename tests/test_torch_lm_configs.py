"""The port's LM configs, single-device sharding hooks and model primitives
(repro_torch.configs, .sharding.rules, .models.common / .mlp) against the
JAX package's, on the CPU.

- configs: the registry, every arch's config and smoke config, the shapes
  and the cells are equal to JAX's (a copy, held so);
- sharding: off a mesh JAX's ``constrain`` is the identity and its mesh
  sizes are 1, as the port's always are;
- primitives: the same numpy inputs through JAX's function and the port's,
  f32, max abs err <= 1e-4 (the bound for port vs JAX in f32).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jcfg
import repro.models.common as jcm
import repro.models.mlp as jmlp
import repro.sharding.rules as jrules
import repro_torch.configs as pcfg
import repro_torch.models.common as pcm
import repro_torch.models.mlp as pmlp
import repro_torch.sharding.rules as prules

TOL = 1e-4


def _np(x):
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _err(a, b):
    return float(np.max(np.abs(_np(a).astype(np.float64)
                                - _np(b).astype(np.float64))))


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def test_registry_and_shapes_equal_jax():
    assert pcfg.ARCHS == jcfg.ARCHS
    assert pcfg.LONG_CONTEXT_ARCHS == jcfg.LONG_CONTEXT_ARCHS
    for name in ("SHAPES", "SMOKE_SHAPES"):
        p, j = getattr(pcfg, name), getattr(jcfg, name)
        assert {k: dataclasses.asdict(v) for k, v in p.items()} == \
               {k: dataclasses.asdict(v) for k, v in j.items()}, name
    for skipped in (False, True):
        assert pcfg.cells(skipped) == jcfg.cells(skipped)
    assert len(pcfg.cells(True)) == 40
    with pytest.raises(KeyError):
        pcfg.get_config("gpt-5")


@pytest.mark.parametrize("arch", jcfg.ARCHS)
def test_config_and_smoke_config_equal_jax(arch):
    for make in (lambda c: c, None):
        p = pcfg.get_config(arch)
        j = jcfg.get_config(arch)
        if make is None:
            p, j = pcfg.make_smoke(p), jcfg.make_smoke(j)
        assert dataclasses.asdict(p) == dataclasses.asdict(j)
        assert p.param_count() == j.param_count()
        assert p.active_param_count() == j.active_param_count()
        assert p.layer_kinds() == j.layer_kinds()
        assert p.num_layers == j.num_layers
    assert pcfg.make_smoke(pcfg.get_config(arch)).param_dtype == "float32"


def test_sharding_hooks_are_jax_off_mesh():
    x = np.arange(6, dtype=np.float32).reshape(1, 2, 3)
    assert jrules.dp_size() == prules.dp_size() == 1
    assert jrules.tp_size() == prules.tp_size() == 1
    t = torch.from_numpy(x)
    assert prules.constrain(t, "hidden") is t
    assert np.array_equal(np.asarray(jrules.constrain(jnp.asarray(x),
                                                      "hidden")), x)


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32) * 0.1
    j = jcm.rmsnorm(jnp.asarray(x), {"scale": jnp.asarray(scale)}, 1e-6)
    p = pcm.rmsnorm(torch.from_numpy(x), {"scale": torch.from_numpy(scale)},
                    1e-6)
    assert _err(j, p) <= TOL
    j = jcm.rmsnorm_nobias(jnp.asarray(x), jnp.asarray(scale), 1e-6)
    p = pcm.rmsnorm_nobias(torch.from_numpy(x), torch.from_numpy(scale),
                           1e-6)
    assert _err(j, p) <= TOL


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_jax(theta):
    """Split halves, not interleaved; positions up to 64."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 64, 4, 16)).astype(np.float32)
    pos = np.broadcast_to(np.arange(64), (2, 64)).astype(np.int32)
    assert _err(jcm.rope_freqs(16, theta), pcm.rope_freqs(16, theta)) <= TOL
    j = jcm.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    p = pcm.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    assert _err(j, p) <= TOL


def test_softcap_bounds_and_matches_jax():
    """JAX's test_softcap_bounds_logits on the port, and the values."""
    x = np.linspace(-1000, 1000, 101).astype(np.float32)
    y = pcm.softcap(torch.from_numpy(x), 30.0)
    assert float(y.abs().max()) <= 30.0
    assert torch.equal(pcm.softcap(torch.from_numpy(x), 0.0),
                       torch.from_numpy(x))
    assert _err(jcm.softcap(jnp.asarray(x), 30.0), y) <= TOL


@pytest.mark.parametrize("arch", ["gemma2-2b", "llama-3.2-vision-11b"])
def test_embed_and_unembed_match_jax(arch):
    """gemma2: √d embedding scale, tied unembedding, logit softcap 30;
    llama: an untied lm_head."""
    cfg = jcfg.make_smoke(jcfg.get_config(arch))
    rng = np.random.default_rng(2)
    tok = (rng.standard_normal((cfg.vocab_size, cfg.d_model)) * 0.5
           ).astype(np.float32)
    head = rng.standard_normal((cfg.d_model, cfg.vocab_size)
                               ).astype(np.float32) * 0.5
    ids = rng.integers(0, cfg.vocab_size, (2, 7)).astype(np.int32)
    lm_head = None if cfg.tie_embeddings else head
    je = jcm.embed(jnp.asarray(ids), {"tok": jnp.asarray(tok)}, cfg)
    pe = pcm.embed(torch.from_numpy(ids), {"tok": torch.from_numpy(tok)}, cfg)
    assert _err(je, pe) <= TOL
    jl = jcm.unembed(je, {"tok": jnp.asarray(tok)}, cfg,
                     None if lm_head is None else jnp.asarray(lm_head))
    pl = pcm.unembed(pe, {"tok": torch.from_numpy(tok)}, cfg,
                     None if lm_head is None else torch.from_numpy(lm_head))
    assert pl.dtype == torch.float32
    assert _err(jl, pl) <= TOL


def test_mlp_matches_jax():
    cfg = jcfg.make_smoke(jcfg.get_config("phi4-mini-3.8b"))
    rng = np.random.default_rng(3)
    p = {"wi_gate": rng.standard_normal((64, 128)) / 8,
         "wi_up": rng.standard_normal((64, 128)) / 8,
         "wo": rng.standard_normal((128, 64)) / 11}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 9, 64)).astype(np.float32)
    j = jmlp.mlp({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
                 cfg)
    t = pmlp.mlp({k: torch.from_numpy(v) for k, v in p.items()},
                 torch.from_numpy(x), cfg)
    assert _err(j, t) <= TOL


def test_dot_f32_promotes_like_jax_einsum():
    """f32 x bf16 is an f32 product with an f32 result, as
    ``jnp.einsum(..., preferred_element_type=float32)``; bf16 x bf16 too."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((3, 5, 32)).astype(np.float32)
    b = rng.standard_normal((32, 6)).astype(np.float32)
    bb = torch.from_numpy(b).to(torch.bfloat16)
    jb = jnp.asarray(b).astype(jnp.bfloat16)
    for ta, ja in ((torch.from_numpy(a), jnp.asarray(a)),
                   (torch.from_numpy(a).to(torch.bfloat16),
                    jnp.asarray(a).astype(jnp.bfloat16))):
        got = pcm.dot_f32(ta, bb)
        want = jnp.einsum("...d,df->...f", ja, jb,
                          preferred_element_type=jnp.float32)
        assert got.dtype == torch.float32
        assert _err(want, got) <= TOL


def test_dense_init_draws_jax_distribution():
    """Truncated normal on [-2, 2] / sqrt(fan_in): the bounds, the
    truncated law's std (0.8796 / sqrt(fan_in)) against JAX's sample, the
    dtype, and one generator seed giving one draw."""
    shape, fan_in = (256, 512), 256
    j = np.asarray(jcm.dense_init(jax.random.PRNGKey(0), shape, jnp.float32))
    g = lambda: torch.Generator().manual_seed(7)
    p = pcm.dense_init(shape, torch.float32, g(), "cpu")
    assert torch.equal(p, pcm.dense_init(shape, torch.float32, g(), "cpu"))
    lim = 2.0 / np.sqrt(fan_in)
    assert float(p.abs().max()) <= lim + 1e-7
    want = 0.87962566 / np.sqrt(fan_in)
    assert abs(float(p.std()) - want) / want < 0.01
    assert abs(float(j.std()) - want) / want < 0.01
    assert abs(float(p.mean())) < 0.01 * want
    assert pcm.dense_init(shape, torch.bfloat16, g(), "cpu",
                          fan_in=3).dtype == torch.bfloat16
