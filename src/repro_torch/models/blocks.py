"""Per-layer blocks, keyed by layer kind (see configs.base for the legend);
port of ``repro/models/blocks.py`` for the attention-only kinds.

    init_layer(kind, cfg, generator, device)        -> params dict
    apply_layer_full(p, kind, x, positions, ...)    -> (x, cache_entry, aux)
    apply_layer_decode(p, kind, x, pos, entry, ...) -> (x, cache_entry)
    init_cache_entry(kind, cfg, batch, max_len, dtype, device)

Kinds G, L, D, C, E and X are here.  MoE FFNs (``_is_moe``) and the Mamba2
kinds M and S, with Zamba2's shared block, come with the next slice of the
port (ROADMAP A.13b) and raise ``NotImplementedError`` until then.  Decode
writes the cache entry's tensors in place.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.mlp import init_mlp, mlp

ATTN_KINDS = "GLDE"


def _not_yet(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: it comes with the MoE / SSM slice of "
        f"the port (ROADMAP A.13b)")


def _is_moe(kind: str, cfg) -> bool:
    return cfg.num_experts > 0 and kind in "GL"


def _refuse(kind: str, cfg) -> None:
    if _is_moe(kind, cfg):
        raise _not_yet(f"the MoE FFN of {cfg.name}'s {kind!r} layers")
    if kind in "MS":
        raise _not_yet(f"the Mamba2 layer kind {kind!r} of {cfg.name}")


def _attn_statics(kind: str, cfg):
    """(causal, window, rope_theta) for an attention layer kind."""
    causal = kind != "E"
    window = cfg.sliding_window if kind == "L" else 0
    theta = (cfg.local_rope_theta if (kind == "L" and cfg.local_rope_theta)
             else cfg.rope_theta)
    return causal, window, theta


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(kind: str, cfg, generator, device):
    _refuse(kind, cfg)
    d, dt = cfg.d_model, cm.dtype_of(cfg)
    norm = lambda: cm.init_rmsnorm(d, dt, device)
    if kind in ATTN_KINDS:
        p = {"ln1": norm(), "attn": attn.init_attention(cfg, generator, device),
             "ln2": norm(), "ffn": init_mlp(cfg, generator, device)}
        if cfg.use_post_norms:
            p["post_ln1"] = norm()
            p["post_ln2"] = norm()
        return p
    if kind == "C":      # cross-attention layer (VLM)
        return {
            "ln1": norm(),
            "xattn": attn.init_attention(cfg, generator, device, cross=True),
            "ln2": norm(),
            "ffn": init_mlp(cfg, generator, device),
            "gate_ffn": torch.zeros((), dtype=dt, device=device),
        }
    if kind == "X":      # decoder layer: self + cross (enc-dec)
        return {
            "ln1": norm(),
            "attn": attn.init_attention(cfg, generator, device),
            "lnx": norm(),
            "xattn": attn.init_attention(cfg, generator, device),
            "ln2": norm(),
            "ffn": init_mlp(cfg, generator, device),
        }
    raise ValueError(f"unknown layer kind {kind!r}")


def init_shared_block(cfg, generator, device):
    """Zamba2's weight-shared attention+FFN block."""
    raise _not_yet(f"Zamba2's shared block ({cfg.name})")


# ---------------------------------------------------------------------------
# cache entries
# ---------------------------------------------------------------------------

def init_cache_entry(kind: str, cfg, batch: int, max_len: int, dtype,
                     device):
    _refuse(kind, cfg)
    KV, hd = cfg.num_kv_heads, cfg.head_dim
    zeros = lambda T: torch.zeros((batch, T, KV, hd), dtype=dtype,
                                  device=device)
    if kind in "GLD":
        return {"k": zeros(max_len), "v": zeros(max_len)}
    if kind == "C":
        nimg = max(cfg.num_image_tokens, 1)
        return {"ck": zeros(nimg), "cv": zeros(nimg)}
    if kind == "X":
        T = max_len // cfg.audio_downsample
        return {"k": zeros(max_len), "v": zeros(max_len),
                "ck": zeros(T), "cv": zeros(T)}
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# full-sequence application (train / prefill)
# ---------------------------------------------------------------------------

def _sandwich(p, name, y, cfg):
    if cfg.use_post_norms:
        return cm.rmsnorm(y, p[name], cfg.norm_eps)
    return y


def _write_full_kv(entry, k, v):
    """Fill the cache's first S positions with the prefill K/V."""
    S = k.shape[1]
    entry["k"][:, :S] = k.to(entry["k"].dtype)
    entry["v"][:, :S] = v.to(entry["v"].dtype)
    return entry


def apply_layer_full(p, kind: str, x, positions, cfg, *,
                     ctx=None, entry=None, q_chunk=0):
    """Returns (x, cache_entry_or_None, aux).  A C or X layer's entry
    takes the context K/V as computed, in the activations' dtype (JAX
    does not cast them to the cache's)."""
    _refuse(kind, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ATTN_KINDS:
        causal, window, theta = _attn_statics(kind, cfg)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, (k, v) = attn.self_attention(
            p["attn"], h, positions, cfg, causal=causal, window=window,
            theta=theta, q_chunk=q_chunk)
        x = x + _sandwich(p, "post_ln1", y, cfg)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _sandwich(p, "post_ln2", mlp(p["ffn"], h, cfg), cfg)
        if entry is not None and kind != "E":
            entry = _write_full_kv(entry, k, v)
        return x, entry, aux

    if kind == "C":
        ck, cv = attn.cross_kv(p["xattn"], ctx["image_embeds"], cfg)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = x + attn.cross_attention(p["xattn"], h, positions, (ck, cv), cfg,
                                     q_chunk=q_chunk)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        g = torch.tanh(p["gate_ffn"].float()).to(x.dtype)
        x = x + g * mlp(p["ffn"], h, cfg)
        if entry is not None:
            entry.update(ck=ck, cv=cv)
        return x, entry, aux

    if kind == "X":
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, (k, v) = attn.self_attention(
            p["attn"], h, positions, cfg, causal=True, window=0,
            theta=cfg.rope_theta, q_chunk=q_chunk)
        x = x + y
        ck, cv = attn.cross_kv(p["xattn"], ctx["encoder_out"], cfg)
        h = cm.rmsnorm(x, p["lnx"], cfg.norm_eps)
        x = x + attn.cross_attention(p["xattn"], h, positions, (ck, cv), cfg,
                                     q_chunk=q_chunk)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p["ffn"], h, cfg)
        if entry is not None:
            entry = _write_full_kv(entry, k, v)
            entry.update(ck=ck, cv=cv)
        return x, entry, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

def apply_layer_decode(p, kind: str, x, pos, entry, cfg):
    """x: (B, 1, d); pos: (B,).  Returns (x, entry), the entry written in
    place.  C and X layers read their context K/V from the entry."""
    _refuse(kind, cfg)
    if kind in "GLD":
        _, window, theta = _attn_statics(kind, cfg)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, _, _ = attn.decode_self_attention(
            p["attn"], h, pos, entry["k"], entry["v"], cfg,
            window=window, theta=theta)
        x = x + _sandwich(p, "post_ln1", y, cfg)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _sandwich(p, "post_ln2", mlp(p["ffn"], h, cfg), cfg)
        return x, entry

    if kind == "C":
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        x = x + attn.cross_attention(p["xattn"], h, pos[:, None],
                                     (entry["ck"], entry["cv"]), cfg)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        g = torch.tanh(p["gate_ffn"].float()).to(x.dtype)
        x = x + g * mlp(p["ffn"], h, cfg)
        return x, entry

    if kind == "X":
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, _, _ = attn.decode_self_attention(
            p["attn"], h, pos, entry["k"], entry["v"], cfg,
            window=0, theta=cfg.rope_theta)
        x = x + y
        h = cm.rmsnorm(x, p["lnx"], cfg.norm_eps)
        x = x + attn.cross_attention(p["xattn"], h, pos[:, None],
                                     (entry["ck"], entry["cv"]), cfg)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + mlp(p["ffn"], h, cfg)
        return x, entry
    raise ValueError(kind)
