"""Shared model primitives: norms, RoPE, embeddings, init, softcap (port of
``repro/models/common.py``).

Plain functions on tensors: parameters are nested dicts of tensors, every
module an ``init_*`` plus an apply function, as in the JAX package.  JAX
runs every matmul with ``preferred_element_type=float32``, so products
accumulate in f32 and some results stay f32 (logits, the MLP's gate and
up, attention scores); :func:`dot_f32` is that einsum.  Norms and softmax
statistics are f32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.sharding.rules import (constrain, grad_in_layout,
                                       mesh_reshape, reduce_partial,
                                       relayout, replicate, rowwise)


def dtype_of(cfg) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def dense_init(shape, dtype, generator, device, fan_in=None):
    """Truncated normal on [-2, 2] with 1/sqrt(fan_in) scale (fan_in =
    shape[0] by default), drawn from ``generator``: JAX's distribution,
    not its bits (torch cannot replay JAX's PRNG)."""
    fi = fan_in if fan_in is not None else shape[0]
    x = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (x * (1.0 / np.sqrt(max(fi, 1)))).to(dtype)


def dot_f32(a, b):
    """``a @ b`` accumulated in f32 with an f32 result: JAX's
    ``jnp.einsum(..., preferred_element_type=jnp.float32)``.

    ``a`` is (..., K) against a (K, N) ``b``, or (N, M, K) against
    (N, K, P).  Unlike dtypes promote first (f32 x bf16 is an f32 product,
    as ``jnp.einsum``'s).  Two bf16 operands on CUDA stay bf16 on the
    tensor cores with an f32 output (``out_dtype``); elsewhere they are
    upcast, which gives the same exact products and f32 sums.  Meta
    tensors (the dry run's) take the CUDA branch, so a trace of them
    counts the card's ops.
    """
    if (a.dtype == b.dtype == torch.bfloat16
            and a.device.type in ("cuda", "meta")):
        if b.dim() == 2:
            out = _Bf16DotF32.apply(
                mesh_reshape(a, (-1, a.shape[-1])), b)
            return mesh_reshape(out, (*a.shape[:-1], b.shape[-1]))
        return _Bf16DotF32.apply(a, b)
    return torch.matmul(a.float(), b.float())


class _Bf16DotF32(torch.autograd.Function):
    """``torch.mm/bmm(a, b, out_dtype=float32)`` of two bf16 CUDA tensors,
    which has no derivative of its own in torch.  Its backward is the one
    the upcast product has on the CPU (and JAX's): the f32 cotangent
    times the other operand in f32, each gradient rounded once to its
    operand's dtype."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        mm = torch.mm if b.dim() == 2 else torch.bmm
        return mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        ga = gb = None
        if ctx.needs_input_grad[0]:
            ga = torch.matmul(g, b.float().transpose(-1, -2)).to(a.dtype)
        if ctx.needs_input_grad[1]:
            gb = torch.matmul(a.float().transpose(-1, -2), g).to(b.dtype)
        return ga, gb


def matmul(x, w):
    """x @ w with f32 accumulation regardless of storage dtype."""
    return dot_f32(x, w).to(x.dtype)


def matmul_reduce(x, w, cfg):
    """JAX's ``einsum(x, w, preferred_element_type=pet).astype(x.dtype)``
    with ``pet`` x's dtype under ``cfg.bf16_partial_reduce``, else f32.
    XLA computes a product whose preferred type is narrower than an
    operand with that operand cast to it, so with the switch on, bf16
    activations meet an f32 weight rounded to bf16; products accumulate
    in f32 either way."""
    if cfg is not None and cfg.bf16_partial_reduce:
        w = w.to(x.dtype)
    return matmul(x, w)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d, dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(x, params, eps):
    return rmsnorm_nobias(x, params["scale"], eps)


def rmsnorm_nobias(x, scale, eps):
    # on a mesh each rank normalizes its own rows (rules.rowwise), so the
    # backward takes one route on every torch version
    return rowwise(lambda x, scale: _rmsnorm(x, scale, eps), x, scale)


def _rmsnorm(x, scale, eps):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return theta ** (-torch.arange(0, head_dim, 2, dtype=torch.float32,
                                   device=device) / head_dim)


def apply_rope(x, positions, theta):
    """x: (..., S, H, hd); positions: broadcastable to (..., S).  The two
    halves of ``hd`` rotate together (split, not interleaved)."""
    hd = x.shape[-1]
    inv = rope_freqs(hd, theta, x.device)                 # (hd/2,)
    ang = positions[..., None].float() * inv              # (..., S, hd/2)
    sin, cos = torch.sin(ang)[..., None, :], torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x, cap: float):
    """Gemma-2 logit soft-capping: cap * tanh(x / cap)."""
    if cap <= 0.0:
        return x
    return (cap * torch.tanh(x.float() / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / unembedding
# ---------------------------------------------------------------------------

def init_embed(cfg, generator, device):
    return {"tok": dense_init((cfg.vocab_size, cfg.d_model), dtype_of(cfg),
                              generator, device, fan_in=cfg.d_model)}


def embed(tokens, params, cfg):
    # JAX's jnp.take: on a vocab-split table each rank looks up its own
    # rows and the ranks' rows are summed (DTensor's masked partial), with
    # no gather of the table.  The ids are replicated first, so DTensor's
    # costs take that route on every mesh (with sequence-split ids, a
    # small table's gather can cost less than the ids')
    x = torch.nn.functional.embedding(replicate(tokens),
                                      grad_in_layout(params["tok"]))
    if cfg.embed_scale:
        # the rows summed before the scale, by one route on every torch
        # version (rules.reduce_partial)
        x = reduce_partial(x) * torch.tensor(np.sqrt(cfg.d_model),
                                             dtype=x.dtype)
    return constrain(x, "hidden")


def unembed(x, embed_params, cfg, lm_head=None):
    """f32 logits, whatever the parameters' dtype."""
    w = (lm_head if lm_head is not None
         else grad_in_layout(embed_params["tok"]).T)
    logits = dot_f32(x, w)
    if cfg.logit_softcap > 0.0:
        # the product's partial sums reduced into the logits' layout before
        # the cap, on every torch version (rules.relayout)
        logits = relayout(logits, "logits")
    return softcap(logits, cfg.logit_softcap)
