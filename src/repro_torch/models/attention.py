"""Attention: GQA, RoPE, sliding window, softcap, QK-norm, QKV bias,
cross-attention, and a KV cache for decode (port of
``repro/models/attention.py``).

Grouped-query attention never repeats KV heads: scores are a grouped
product ``(B,S,KV,G,hd) x (B,T,KV,hd)`` (one batched matmul over B x KV),
so decode reads each cached KV byte once.  Scores, softcap, mask and
softmax are JAX's ops in JAX's order, in f32; the probabilities are cast
to the dtype of ``v`` before the second product, as JAX casts them.

``q_chunk`` bounds the live score tensor to (B, H, q_chunk, T): the query
axis is processed a chunk at a time, with the same numerics.  JAX's
expanded-KV branch (``repro/models/attention.py:75-92``) runs only on a
model axis wider than one device, so it waits for the mesh side of the
port (ROADMAP A.13c).
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.sharding.rules import constrain

NEG_INF = -1.0e30


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_attention(cfg, generator, device, *, cross: bool = False):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = cm.dtype_of(cfg)
    p = {
        "wq": cm.dense_init((d, H, hd), dt, generator, device, fan_in=d),
        "wk": cm.dense_init((d, KV, hd), dt, generator, device, fan_in=d),
        "wv": cm.dense_init((d, KV, hd), dt, generator, device, fan_in=d),
        "wo": cm.dense_init((H, hd, d), dt, generator, device,
                            fan_in=H * hd),
    }
    zeros = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    if cfg.qkv_bias:
        p["bq"], p["bk"], p["bv"] = zeros(H, hd), zeros(KV, hd), zeros(KV, hd)
    if cfg.qk_norm:
        p["q_norm"], p["k_norm"] = zeros(hd), zeros(hd)
    if cross:
        p["gate"] = zeros()             # llama3.2-vision tanh gate
    return p


# ---------------------------------------------------------------------------
# core attend
# ---------------------------------------------------------------------------

def _mask(q_pos, k_pos, k_valid, *, causal, window):
    """(B, Sq, Tk) additive mask from positions."""
    qp = q_pos[:, :, None]        # (B, Sq, 1)
    kp = k_pos[:, None, :]        # (B, 1, Tk)
    ok = k_valid[:, None, :]
    if causal:
        ok = ok & (kp <= qp)
    if window > 0:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF).float()


def _attend_block(q, k, v, mask, attn_softcap, scale):
    """q: (B,Sq,KV,G,hd); k/v: (B,Tk,KV,hd); mask: (B,Sq,Tk) -> (B,Sq,KV,G,hd)."""
    B, Sq, KV, G, hd = q.shape
    Tk = k.shape[1]
    qb = q.permute(0, 2, 3, 1, 4).reshape(B * KV, G * Sq, hd)
    kb = k.permute(0, 2, 3, 1).reshape(B * KV, hd, Tk)
    s = cm.dot_f32(qb, kb).view(B, KV, G, Sq, Tk) * scale
    s = constrain(s, "scores")
    if attn_softcap > 0.0:
        s = attn_softcap * torch.tanh(s / attn_softcap)
    s = s + mask[:, None, None, :, :]
    p = torch.softmax(s, dim=-1).to(v.dtype)
    vb = v.permute(0, 2, 1, 3).reshape(B * KV, Tk, hd)
    out = cm.dot_f32(p.reshape(B * KV, G * Sq, Tk), vb).to(v.dtype)
    return out.view(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4)


def attend(q, k, v, *, q_pos, k_pos, k_valid, causal, window,
           attn_softcap=0.0, q_chunk=0):
    """q: (B,Sq,H,hd); k,v: (B,Tk,KV,hd).  Returns (B,Sq,H,hd)."""
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qg = q.reshape(B, Sq, KV, G, hd)

    if q_chunk and Sq > q_chunk and Sq % q_chunk == 0:
        outs = []
        for c in range(0, Sq, q_chunk):
            m = _mask(q_pos[:, c:c + q_chunk], k_pos, k_valid,
                      causal=causal, window=window)
            outs.append(_attend_block(qg[:, c:c + q_chunk], k, v, m,
                                      attn_softcap, scale))
        out = torch.cat(outs, dim=1)
    else:
        m = _mask(q_pos, k_pos, k_valid, causal=causal, window=window)
        out = _attend_block(qg, k, v, m, attn_softcap, scale)
    return out.reshape(B, Sq, H, hd)


# ---------------------------------------------------------------------------
# full layers
# ---------------------------------------------------------------------------

def _heads(x, w):
    """einsum("bsd,dhk->bshk") accumulated in f32, in the dtype of x."""
    d, h, k = w.shape
    return cm.matmul(x, w.reshape(d, h * k)).unflatten(-1, (h, k))


def _project_q(p, x, cfg, positions, theta, *, rope=True):
    q = _heads(x, p["wq"])
    if "bq" in p:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = cm.rmsnorm_nobias(q, p["q_norm"], cfg.norm_eps)
    if rope:
        q = cm.apply_rope(q, positions, theta)
    return constrain(q, "heads")


def _project_kv(p, x, cfg, positions, theta, *, rope=True):
    k, v = _heads(x, p["wk"]), _heads(x, p["wv"])
    if "bk" in p:
        k, v = k + p["bk"], v + p["bv"]
    if cfg.qk_norm:
        k = cm.rmsnorm_nobias(k, p["k_norm"], cfg.norm_eps)
    if rope:
        k = cm.apply_rope(k, positions, theta)
    return constrain(k, "heads"), constrain(v, "heads")


def _out_proj(p, ctx, cfg=None):
    """einsum("bshk,hkd->bsd") in the dtype of ``ctx`` (bf16 when decode
    attended over a bf16 cache, even with f32 parameters, as JAX's), under
    JAX's ``bf16_partial_reduce`` switch."""
    h, k, d = p["wo"].shape
    out = cm.matmul_reduce(ctx.flatten(-2), p["wo"].reshape(h * k, d), cfg)
    return constrain(out, "hidden")


def self_attention(p, x, positions, cfg, *, causal, window, theta,
                   q_chunk=0):
    """Full-sequence self-attention (train / prefill).

    Returns (out (B,S,d), (k, v)) — k/v handed back for cache fill.
    """
    q = _project_q(p, x, cfg, positions, theta)
    k, v = _project_kv(p, x, cfg, positions, theta)
    valid = torch.ones(positions.shape, dtype=torch.bool,
                       device=positions.device)
    ctx = attend(q, k, v, q_pos=positions, k_pos=positions, k_valid=valid,
                 causal=causal, window=window,
                 attn_softcap=cfg.attn_softcap, q_chunk=q_chunk)
    return _out_proj(p, ctx, cfg), (k, v)


def decode_self_attention(p, x, pos, cache_k, cache_v, cfg, *,
                          window, theta):
    """One-token decode.  x: (B,1,d); pos: (B,) write index;
    cache_k/v: (B,S,KV,hd), written in place at ``pos``.  Returns (out,
    cache_k, cache_v).  Attends over the whole cache with ``k_pos <=
    pos``, as JAX's."""
    B, S = cache_k.shape[0], cache_k.shape[1]
    q = _project_q(p, x, cfg, pos[:, None], theta)
    k_new, v_new = _project_kv(p, x, cfg, pos[:, None], theta)
    bidx = torch.arange(B, device=pos.device)
    cache_k[bidx, pos] = k_new[:, 0].to(cache_k.dtype)
    cache_v[bidx, pos] = v_new[:, 0].to(cache_v.dtype)
    k_pos = torch.arange(S, dtype=pos.dtype, device=pos.device).expand(B, S)
    valid = k_pos <= pos[:, None]
    ctx = attend(q, cache_k, cache_v, q_pos=pos[:, None], k_pos=k_pos,
                 k_valid=valid, causal=True, window=window,
                 attn_softcap=cfg.attn_softcap)
    return _out_proj(p, ctx, cfg), cache_k, cache_v


def cross_attention(p, x, positions, ctx_kv, cfg, *, q_chunk=0):
    """Cross-attention to precomputed context K/V (vision / encoder).

    ctx_kv: (k, v) each (B, T_ctx, KV, hd) — computed once via
    ``cross_kv``; no RoPE on either side (positionless context).
    Output is tanh-gated (llama3.2-vision style) when a gate param exists.
    """
    q = _project_q(p, x, cfg, positions, theta=1.0, rope=False)
    k, v = ctx_kv
    B, T = k.shape[0], k.shape[1]
    k_pos = torch.zeros((B, T), dtype=positions.dtype, device=k.device)
    valid = torch.ones((B, T), dtype=torch.bool, device=k.device)
    ctx = attend(q, k, v, q_pos=positions, k_pos=k_pos, k_valid=valid,
                 causal=False, window=0, attn_softcap=cfg.attn_softcap,
                 q_chunk=q_chunk)
    out = _out_proj(p, ctx, cfg)
    if "gate" in p:
        out = out * torch.tanh(p["gate"].float()).to(out.dtype)
    return out


def cross_kv(p, ctx_x, cfg):
    """Project context embeddings to K/V once (cached across decode steps)."""
    return _project_kv(p, ctx_x, cfg, positions=None, theta=1.0, rope=False)
