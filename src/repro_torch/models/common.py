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

from repro_torch.sharding.rules import constrain


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
    upcast, which gives the same exact products and f32 sums.
    """
    if a.dtype == b.dtype == torch.bfloat16 and a.is_cuda:
        if b.dim() == 2:
            out = torch.mm(a.reshape(-1, a.shape[-1]), b,
                           out_dtype=torch.float32)
            return out.reshape(*a.shape[:-1], b.shape[-1])
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.matmul(a.float(), b.float())


def matmul(x, w):
    """x @ w with f32 accumulation regardless of storage dtype."""
    return dot_f32(x, w).to(x.dtype)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------

def init_rmsnorm(d, dtype, device):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(x, params, eps):
    return rmsnorm_nobias(x, params["scale"], eps)


def rmsnorm_nobias(x, scale, eps):
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
    x = params["tok"][tokens]
    if cfg.embed_scale:
        x = x * torch.tensor(np.sqrt(cfg.d_model), dtype=x.dtype)
    return constrain(x, "hidden")


def unembed(x, embed_params, cfg, lm_head=None):
    """f32 logits, whatever the parameters' dtype."""
    w = lm_head if lm_head is not None else embed_params["tok"].T
    return softcap(dot_f32(x, w), cfg.logit_softcap)
