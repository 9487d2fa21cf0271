"""Per-layer blocks, keyed by layer kind (see configs.base for the legend);
port of ``repro/models/blocks.py``.

    init_layer(kind, cfg, generator, device)        -> params dict
    apply_layer_full(p, kind, x, positions, ...)    -> (x, cache_entry, aux)
    apply_layer_decode(p, kind, x, pos, entry, ...) -> (x, cache_entry)
    init_cache_entry(kind, cfg, batch, max_len, dtype, device)

Every kind: G, L, D, C, E, X, the Mamba2 kinds M and S (S: Zamba2's
weight-shared attention block after the Mamba2 block), and the MoE FFN of
G / L layers when the config has experts.  Decode writes the cache
entry's tensors in place.  Prefill writes K/V into the cache in place and
sets an entry's context K/V (C, X) and Mamba2 conv tail and state as
computed, in the activations' dtype (the state f32), as JAX's does.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as attn
from repro_torch.models import common as cm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.models.moe import init_moe, moe
from repro_torch.models.ssm import init_ssm, ssm_decode, ssm_forward

ATTN_KINDS = "GLDE"


def _is_moe(kind: str, cfg) -> bool:
    return cfg.num_experts > 0 and kind in "GL"


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
    d, dt = cfg.d_model, cm.dtype_of(cfg)
    norm = lambda: cm.init_rmsnorm(d, dt, device)
    if kind in ATTN_KINDS:
        p = {"ln1": norm(),
             "attn": attn.init_attention(cfg, generator, device),
             "ln2": norm(),
             "ffn": (init_moe(cfg, generator, device) if _is_moe(kind, cfg)
                     else init_mlp(cfg, generator, device))}
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
    if kind in "MS":     # mamba2 (S: + the shared block applied after)
        return {"ln": norm(), "ssm": init_ssm(cfg, generator, device)}
    raise ValueError(f"unknown layer kind {kind!r}")


def init_shared_block(cfg, generator, device):
    """Zamba2's weight-shared attention+FFN block (one copy a model)."""
    d, dt = cfg.d_model, cm.dtype_of(cfg)
    return {
        "ln1": cm.init_rmsnorm(d, dt, device),
        "attn": attn.init_attention(cfg, generator, device),
        "ln2": cm.init_rmsnorm(d, dt, device),
        "ffn": init_mlp(cfg, generator, device),
    }


# ---------------------------------------------------------------------------
# cache entries
# ---------------------------------------------------------------------------

def init_cache_entry(kind: str, cfg, batch: int, max_len: int, dtype,
                     device):
    """A zeroed entry: K/V in ``dtype``; a Mamba2 conv tail in ``dtype``
    and its state in f32 whatever ``dtype`` is."""
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
    if kind in "MS":
        conv_dim = cfg.d_inner + 2 * cfg.ssm_state
        e = {"conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                 dtype=dtype, device=device),
             "state": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                   cfg.ssm_state), dtype=torch.float32,
                                  device=device)}
        if kind == "S":
            e["sk"], e["sv"] = zeros(max_len), zeros(max_len)
        return e
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# full-sequence application (train / prefill)
# ---------------------------------------------------------------------------

def _sandwich(p, name, y, cfg):
    if cfg.use_post_norms:
        return cm.rmsnorm(y, p[name], cfg.norm_eps)
    return y


def _write_full_kv(entry, k, v, names=("k", "v")):
    """Fill the cache's first S positions with the prefill K/V."""
    for name, t in zip(names, (k, v)):
        attn.write_prefix(entry[name], t)
    return entry


def _shared_full(shared, x, positions, cfg, q_chunk):
    """Zamba2's shared block over a full sequence: (x, (k, v))."""
    h = cm.rmsnorm(x, shared["ln1"], cfg.norm_eps)
    y, kv = attn.self_attention(
        shared["attn"], h, positions, cfg, causal=True, window=0,
        theta=cfg.rope_theta, q_chunk=q_chunk)
    x = x + y
    h = cm.rmsnorm(x, shared["ln2"], cfg.norm_eps)
    return x + mlp(shared["ffn"], h, cfg), kv


def _ffn(p, kind, h, cfg):
    """The layer's FFN: (y, aux); aux is 0 for a dense FFN."""
    if _is_moe(kind, cfg):
        return moe(p["ffn"], h, cfg)
    return mlp(p["ffn"], h, cfg), None


def apply_layer_full(p, kind: str, x, positions, cfg, *,
                     ctx=None, shared=None, entry=None, q_chunk=0):
    """Returns (x, cache_entry_or_None, aux).  A C or X layer's entry
    takes the context K/V as computed, in the activations' dtype (JAX
    does not cast them to the cache's); an M or S layer's its conv tail
    and f32 state.  ``shared`` is Zamba2's shared block (S layers)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in ATTN_KINDS:
        causal, window, theta = _attn_statics(kind, cfg)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, (k, v) = attn.self_attention(
            p["attn"], h, positions, cfg, causal=causal, window=window,
            theta=theta, q_chunk=q_chunk)
        x = x + _sandwich(p, "post_ln1", y, cfg)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        y, moe_aux = _ffn(p, kind, h, cfg)
        x = x + _sandwich(p, "post_ln2", y, cfg)
        if entry is not None and kind != "E":
            entry = _write_full_kv(entry, k, v)
        return x, entry, aux if moe_aux is None else moe_aux

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

    if kind in "MS":
        h = cm.rmsnorm(x, p["ln"], cfg.norm_eps)
        y, (conv_tail, state) = ssm_forward(p["ssm"], h, cfg)
        x = x + y
        if entry is not None:
            entry.update(conv=conv_tail, state=state)
        if kind == "S":
            x, (k, v) = _shared_full(shared, x, positions, cfg, q_chunk)
            if entry is not None:
                entry = _write_full_kv(entry, k, v, names=("sk", "sv"))
        return x, entry, aux
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# single-token decode
# ---------------------------------------------------------------------------

def apply_layer_decode(p, kind: str, x, pos, entry, cfg, *, shared=None):
    """x: (B, 1, d); pos: (B,).  Returns (x, entry), the entry written in
    place.  C and X layers read their context K/V from the entry; S layers
    run ``shared``, Zamba2's shared block, over their own K/V."""
    if kind in "GLD":
        _, window, theta = _attn_statics(kind, cfg)
        h = cm.rmsnorm(x, p["ln1"], cfg.norm_eps)
        y, _, _ = attn.decode_self_attention(
            p["attn"], h, pos, entry["k"], entry["v"], cfg,
            window=window, theta=theta)
        x = x + _sandwich(p, "post_ln1", y, cfg)
        h = cm.rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _sandwich(p, "post_ln2", _ffn(p, kind, h, cfg)[0], cfg)
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

    if kind in "MS":
        h = cm.rmsnorm(x, p["ln"], cfg.norm_eps)
        y, conv, state = ssm_decode(p["ssm"], h, cfg, entry["conv"],
                                    entry["state"])
        x = x + y
        entry["conv"].copy_(conv)
        entry["state"].copy_(state)
        if kind == "S":
            h = cm.rmsnorm(x, shared["ln1"], cfg.norm_eps)
            y, _, _ = attn.decode_self_attention(
                shared["attn"], h, pos, entry["sk"], entry["sv"], cfg,
                window=0, theta=cfg.rope_theta)
            x = x + y
            h = cm.rmsnorm(x, shared["ln2"], cfg.norm_eps)
            x = x + mlp(shared["ffn"], h, cfg)
        return x, entry
    raise ValueError(kind)
