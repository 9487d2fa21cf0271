"""Dot-flop parity of the port's step counter (repro_torch.launch.
cost_analysis.count_step) with the JAX package's loop-weighted HLO walk
(``hlo_analysis.weighted_stats`` of the compiled step), on smoke configs
at B 2, S 64 with JAX's parameters carried over (``from_jax_params``):

- ``prefill`` on all ten archs (stub image embeddings / encoder frames
  for llama-3.2-vision and seamless-m4t);
- one ``decode_step`` (from prefill's caches) and ``value_and_grad`` of
  ``train_loss`` on gemma2-2b, qwen2-moe and mamba2-130m.

Bounds, fixed before measuring: exact for every case but two; mamba2-130m's
decode and gradient differ, within 2%, by exactly the ops named in
:data:`GAPS` (ROADMAP queue C).
"""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import make_smoke as jax_smoke
from repro.launch import hlo_analysis as H
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, get_config, make_smoke
from repro_torch.launch import cost_analysis as C
from repro_torch.models import transformer as PT
from repro_torch.models.convert import from_jax_params
from repro_torch.train.step import value_and_grad
from test_torch_lm_models import carried_params, extras, make_batch, to_torch

B, S = 2, 64
REL_BOUND = 0.02


def _ssm_layers(cfg) -> int:
    return sum(rep * sum(k in "MS" for k in pat) for pat, rep in cfg.segments)


def _conv_dot(cfg) -> float:
    """JAX's decode takes the depthwise conv's tap sum as an einsum
    ("bkc,kc->bc", a dot: 2 B k C a layer); the port as a multiply and a
    sum (vector ops)."""
    conv = cfg.d_inner + 2 * cfg.ssm_state
    return 2 * B * cfg.ssm_conv * conv * _ssm_layers(cfg)


def _ssd_backward_dots(cfg) -> float:
    """JAX's gradient of ``ssd_chunked``'s three-operand einsums forms
    three (B, nc, Q, H, P) products as dots with no contracted dim (2
    flops an element); the port's gradient forms them as elementwise
    multiplies (vector ops)."""
    return 3 * 2 * B * S * cfg.d_inner * _ssm_layers(cfg)


#: (arch, step) -> JAX's dot flops less the port's, by the named op
GAPS = {("mamba2-130m", "decode"): _conv_dot,
        ("mamba2-130m", "train"): _ssd_backward_dots}


def _jax_dots(fn, *args) -> float:
    return H.weighted_stats(jax.jit(fn).lower(*args).compile()
                            .as_text()).dot_flops


def _setup(arch):
    jcfg, pcfg = jax_smoke(jax_config(arch)), make_smoke(get_config(arch))
    tree = carried_params(jcfg)
    batch = make_batch(jcfg, B, S)
    jp = jax.tree.map(jnp.asarray, tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    pp = from_jax_params(tree, pcfg, "cpu")
    pb = to_torch(batch)
    return jcfg, pcfg, jp, jb, pp, pb


def _check(arch, step, jax_dots, port_dots, pcfg):
    gap = GAPS.get((arch, step))
    assert port_dots + (gap(pcfg) if gap else 0) == jax_dots, (
        arch, step, jax_dots, port_dots)
    assert abs(port_dots - jax_dots) <= REL_BOUND * jax_dots


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_dot_flops_equal_jax(arch):
    torch.set_num_threads(1)
    jcfg, pcfg, jp, jb, pp, pb = _setup(arch)
    jd = _jax_dots(lambda p, t, e: JT.prefill(p, t, jcfg, max_len=S, **e),
                   jp, jb["tokens"], extras(jb))
    ws, _, _ = C.count_step(
        lambda p, t, e: PT.prefill(p, t, pcfg, max_len=S, **e),
        pp, pb["tokens"], extras(pb))
    _check(arch, "prefill", jd, ws.dot_flops, pcfg)


@pytest.mark.parametrize("arch", ("gemma2-2b", "qwen2-moe-a2.7b",
                                  "mamba2-130m"))
def test_decode_and_gradient_dot_flops_equal_jax(arch):
    torch.set_num_threads(1)
    jcfg, pcfg, jp, jb, pp, pb = _setup(arch)
    ex, pex = extras(jb), extras(pb)
    _, jc, _ = jax.jit(lambda p, t, e: JT.prefill(p, t, jcfg, max_len=S,
                                                  **e))(jp, jb["tokens"], ex)
    tok = jb["tokens"][:, :1]
    jpos = jnp.full((B,), S - 1, jnp.int32)
    jd = _jax_dots(lambda p, t, q, c: JT.decode_step(p, t, q, c, jcfg),
                   jp, tok, jpos, jc)
    _, pc, _ = PT.prefill(pp, pb["tokens"], pcfg, max_len=S, **pex)
    ws, _, _ = C.count_step(
        lambda p, t, q, c: PT.decode_step(p, t, q, c, pcfg), pp,
        pb["tokens"][:, :1], torch.full((B,), S - 1, dtype=torch.int32), pc)
    _check(arch, "decode", jd, ws.dot_flops, pcfg)

    jd = _jax_dots(jax.value_and_grad(
        lambda p, b: JT.train_loss(p, b, jcfg)[0]), jp, jb)
    ws, _, _ = C.count_step(lambda p, b: value_and_grad(p, b, pcfg), pp, pb)
    _check(arch, "train", jd, ws.dot_flops, pcfg)
