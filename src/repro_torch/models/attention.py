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
expanded-KV branch (``repro/models/attention.py:75-92``) is taken on a
model axis that divides the head count and not the KV-head count, under
an abstract mesh.  On a device mesh (DTensors) each rank attends its own
batch rows and heads (:func:`_attend_mesh`), which is the layout that
branch asks for, so a rank's block takes the grouped branch.
"""
from __future__ import annotations

import torch

from repro_torch.models import common as cm
from repro_torch.sharding import rules
from repro_torch.sharding.rules import constrain, dp_size, is_dtensor, tp_size

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
    # JAX's expanded-KV branch: when the KV-head count cannot shard over
    # the model axis but the full head count can (gemma3's 1 KV head of 4
    # at tp = 2), K/V are expanded to merged heads so the scores shard on
    # heads instead of on the key axis
    tp = tp_size()
    if Sq > 1 and G > 1 and KV % tp != 0 and (KV * G) % tp == 0:
        H = KV * G
        kh = k[:, :, :, None, :].expand(B, Tk, KV, G, hd).reshape(B, Tk, H, hd)
        vh = v[:, :, :, None, :].expand(B, Tk, KV, G, hd).reshape(B, Tk, H, hd)
        qb = q.reshape(B, Sq, H, hd).permute(0, 2, 1, 3).reshape(B * H, Sq, hd)
        kb = kh.permute(0, 2, 3, 1).reshape(B * H, hd, Tk)
        s = cm.dot_f32(qb, kb).view(B, H, Sq, Tk) * scale
        s = constrain(s, "scores_h")
        if attn_softcap > 0.0:
            s = attn_softcap * torch.tanh(s / attn_softcap)
        s = s + mask[:, None, :, :]
        p = torch.softmax(s, dim=-1).to(v.dtype)
        vb = vh.permute(0, 2, 1, 3).reshape(B * H, Tk, hd)
        out = cm.dot_f32(p.reshape(B * H, Sq, Tk), vb).to(v.dtype)
        return out.view(B, H, Sq, hd).permute(0, 2, 1, 3).reshape(
            B, Sq, KV, G, hd)
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
    if is_dtensor(q):
        return _attend_mesh(q, k, v, q_pos=q_pos, k_pos=k_pos,
                            k_valid=k_valid, causal=causal, window=window,
                            attn_softcap=attn_softcap, q_chunk=q_chunk)
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


def _attend_mesh(q, k, v, *, q_pos, k_pos, k_valid, **kw):
    """:func:`attend` on DTensors: each rank attends its batch rows (the
    dp axes) and its heads (the model axis, when it divides the heads),
    the layout JAX's "scores" / "scores_h" rules give the scores.  A
    rank's heads [m·H/tp, (m+1)·H/tp) read the KV heads they group onto:
    a block of them when tp divides the KV heads, else the one they share
    (the expanded-KV case, gemma3's one KV head at tp = 2).  Heads that no
    such split fits run whole on every model rank.  Each rank's K/V
    gradient is a partial sum over the model axis."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    tp, dp = tp_size(), dp_size()
    H_loc = H // tp if tp > 1 and H % tp == 0 else H
    if H_loc < H and not (H_loc % G == 0 or G % H_loc == 0):
        H_loc = H
    rows = Shard(0) if B % dp == 0 else Replicate()
    split = H_loc < H
    q_pl = rules.layout(mesh, data=rows,
                        model=Shard(2) if split else Replicate())
    kv_pl = rules.layout(mesh, data=rows, model=Replicate())
    kv_grad = rules.layout(mesh, data=rows,
                           model=Partial() if split else Replicate())
    row_pl = rules.layout(mesh, data=rows, model=Replicate())
    ql = rules.local_block(q, mesh, q_pl)
    kl = rules.local_block(k, mesh, kv_pl, kv_grad)
    vl = rules.local_block(v, mesh, kv_pl, kv_grad)
    if split:
        h0 = mesh.get_local_rank("model") * H_loc
        k0, k1 = h0 // G, (h0 + H_loc - 1) // G + 1
        kl, vl = kl[:, :, k0:k1], vl[:, :, k0:k1]
    qp, kp, kval = (rules.local_block(t, mesh, row_pl)
                    for t in (q_pos, k_pos, k_valid))
    # the local block runs off the mesh: its heads are already this
    # rank's, so JAX's expanded-KV branch (a layout for the scores) has
    # nothing to lay out and would only copy K/V G-fold
    with rules.set_mesh(None):
        out = attend(ql, kl, vl, q_pos=qp, k_pos=kp, k_valid=kval, **kw)
    return DTensor.from_local(out, mesh, q_pl, run_check=False)


# ---------------------------------------------------------------------------
# full layers
# ---------------------------------------------------------------------------

def _heads(x, w):
    """einsum("bsd,dhk->bshk") accumulated in f32, in the dtype of x."""
    d, h, k = w.shape
    y = cm.matmul(x, rules.mesh_reshape(w, (d, h * k)))
    return rules.mesh_reshape(y, (*y.shape[:-1], h, k))


def _project_q(p, x, cfg, positions, theta, *, rope=True):
    q = _heads(x, p["wq"])
    if rope or cfg.qk_norm:
        q = rules.relayout(q, "heads")
    if "bq" in p:
        q = q + p["bq"]
    if cfg.qk_norm:
        q = cm.rmsnorm_nobias(q, p["q_norm"], cfg.norm_eps)
    if rope:
        q = cm.apply_rope(q, positions, theta)
    return constrain(q, "heads")


def _project_kv(p, x, cfg, positions, theta, *, rope=True):
    k, v = _heads(x, p["wk"]), _heads(x, p["wv"])
    if rope or cfg.qk_norm:
        # Q and K in their heads layout before the norm over each head and
        # RoPE's halves of it (rules.relayout): a decode step's partial
        # sums reduced into the batch split, gemma3's one K head made
        # whole (its weight gradient then at full width)
        k = rules.relayout(k, "heads")
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
    out = cm.matmul_reduce(
        rules.mesh_reshape(ctx, (*ctx.shape[:-2], h * k)),
        rules.mesh_reshape(p["wo"], (h * k, d)), cfg)
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
    write_at(cache_k, k_new[:, 0], pos)
    write_at(cache_v, v_new[:, 0], pos)
    k_pos = torch.arange(S, dtype=pos.dtype, device=pos.device).expand(B, S)
    valid = k_pos <= pos[:, None]
    ctx = attend(q, cache_k, cache_v, q_pos=pos[:, None], k_pos=k_pos,
                 k_valid=valid, causal=True, window=window,
                 attn_softcap=cfg.attn_softcap)
    return _out_proj(p, ctx, cfg), cache_k, cache_v


def _seq_block(cache) -> tuple:
    """(this rank's block of a DTensor cache (B, S, ...), the global
    position of its first slot): the sequence dim's shards taken in mesh
    order, as DTensor lays out a dim split over several mesh dims."""
    from torch.distributed.tensor import Shard

    local = cache.to_local()
    blk = 0
    for i, (p, c) in enumerate(zip(cache.placements,
                                   cache.device_mesh.get_coordinate())):
        if isinstance(p, Shard) and p.dim == 1:
            blk = blk * cache.device_mesh.size(i) + c
    return local, blk * local.shape[1]


def _like_cache(cache, drop_seq: bool) -> list:
    """Placements of a tensor laid out as ``cache`` but whole along the
    sequence (whose dim it lacks when ``drop_seq``)."""
    from torch.distributed.tensor import Replicate, Shard

    out = []
    for p in cache.placements:
        d = p.dim if isinstance(p, Shard) else None
        if d is None or d == 1:
            out.append(Replicate())
        else:
            out.append(Shard(d - 1 if drop_seq and d > 1 else d))
    return out


def write_at(cache, new, pos):
    """``cache[b, pos[b]] = new[b]`` for every row ``b``, in place: cache
    (B, S, ...), new (B, ...), pos (B,).  On a device mesh each rank
    writes its own block of the cache (JAX's partitioned
    dynamic-update-slice): its rows and heads, at the positions that
    fall in its block of the sequence."""
    if not is_dtensor(cache):
        bidx = torch.arange(cache.shape[0], device=pos.device)
        cache[bidx, pos] = new.to(cache.dtype)
        return
    from torch.distributed.tensor import Replicate, Shard

    mesh = cache.device_mesh
    local, first = _seq_block(cache)
    nl = rules.local_block(new, mesh, _like_cache(cache, True)).to(
        local.dtype)
    rows = [Shard(0) if isinstance(p, Shard) and p.dim == 0
            else Replicate() for p in cache.placements]
    lp = rules.local_block(pos, mesh, rows) - first
    s_loc = local.shape[1]
    mine = ((lp >= 0) & (lp < s_loc)).view((-1,) + (1,) * (nl.dim() - 1))
    lp = lp.clamp(0, s_loc - 1)
    bidx = torch.arange(local.shape[0], device=lp.device)
    local[bidx, lp] = torch.where(mine, nl, local[bidx, lp])


def write_prefix(cache, new):
    """``cache[:, :T] = new`` in place (new (B, T, ...)); on a device mesh
    each rank writes the positions that fall in its block of the
    sequence."""
    if not is_dtensor(cache):
        cache[:, :new.shape[1]] = new.to(cache.dtype)
        return
    local, first = _seq_block(cache)
    nl = rules.local_block(new, cache.device_mesh,
                           _like_cache(cache, False))
    lo = max(0, first)
    hi = min(new.shape[1], first + local.shape[1])
    if lo < hi:
        local[:, lo - first:hi - first] = nl[:, lo:hi].to(local.dtype)


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
