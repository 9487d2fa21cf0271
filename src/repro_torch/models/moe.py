"""Mixture-of-Experts FFN with group-local sort-based capacity dispatch
(port of ``repro/models/moe.py``'s grouped path, ``moe_gspmd``).

Tokens are split into G groups, one a data-parallel shard (G = 1 on one
device); inside a group: top-k ids -> stable argsort -> position in its
expert -> a (G, E, C, d) buffer -> grouped expert products -> the
weighted combine.  Shapes are static: an assignment past its expert's
capacity C is dropped (it lands on a trash row that is sliced away, where
JAX scatters with ``mode="drop"``).  Padded (dead) experts get
probability 0 and so no token.  Shared experts are one always-on SwiGLU
of width ``num_shared_experts * moe_d_ff``.

Ties in the top-k go to the lower expert id, as ``jax.lax.top_k`` breaks
them (a stable descending sort).  The dispatch is a scatter and the
combine a gather plus a sum over each token's k assignments, so neither
direction needs an atomic add: the layer is deterministic on CUDA.  JAX's
expert-parallel ``moe_ep`` (``shard_map``) needs a mesh (ROADMAP A.13c);
with no mesh JAX's ``moe`` takes the grouped path for ``moe_impl="ep"``
too, and so does the port's.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.sharding.rules import constrain, dp_size


def _padded_experts(cfg) -> int:
    return max(cfg.num_experts, cfg.expert_pad_to)


def init_moe(cfg, generator, device):
    E, d, ff = _padded_experts(cfg), cfg.d_model, cfg.moe_d_ff
    dt = cm.dtype_of(cfg)
    p = {
        "router": cm.dense_init((d, cfg.num_experts), torch.float32,
                                generator, device),
        "wi_gate": cm.dense_init((E, d, ff), dt, generator, device, fan_in=d),
        "wi_up": cm.dense_init((E, d, ff), dt, generator, device, fan_in=d),
        "wo": cm.dense_init((E, ff, d), dt, generator, device, fan_in=ff),
    }
    if cfg.num_shared_experts:
        p["shared"] = init_mlp(cfg, generator, device,
                               d_ff=cfg.num_shared_experts * ff)
    return p


def _capacity(Tg: int, cfg) -> int:
    c = int(cfg.capacity_factor * Tg * cfg.moe_top_k / max(cfg.num_experts, 1))
    return max(8, -(-c // 8) * 8)  # round up to 8


def _num_groups(T: int) -> int:
    """Dispatch groups = data-parallel shards (1 off a mesh)."""
    g = dp_size()
    while g > 1 and T % g:
        g //= 2
    return max(g, 1)


def route(router, xt, cfg, C: int) -> dict:
    """Routing of ``xt`` (G, Tg, d), JAX's ops in JAX's order.  Returns
    probs (G, Tg, E), the top-k ``w`` / ``ids`` (G, Tg, k), the per-group
    expert ``counts`` (G, E), and in JAX's sorted order (G, Tg*k) the
    argsort ``order``, ``keep`` and ``slot`` (E*C for a dropped
    assignment)."""
    G, Tg, _ = xt.shape
    E, k = _padded_experts(cfg), cfg.moe_top_k
    logits = torch.matmul(xt.float(), router)
    probs = torch.softmax(logits, dim=-1)                    # (G, Tg, E_real)
    if E > cfg.num_experts:                                  # dead experts
        probs = F.pad(probs, (0, E - cfg.num_experts))
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :k], ids[..., :k]
    w = w / torch.sum(w, dim=-1, keepdim=True)               # renormalize

    flat_ids = ids.reshape(G, Tg * k)
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_e = torch.gather(flat_ids, 1, order)
    counts = torch.zeros((G, E), dtype=torch.long, device=xt.device)
    counts.scatter_add_(1, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = (torch.arange(Tg * k, device=xt.device)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < C
    slot = torch.where(keep, sorted_e * C + pos_in_e, E * C)
    return dict(probs=probs, w=w, ids=ids, counts=counts, order=order,
                keep=keep, slot=slot)


def _unsort(order, v):
    """``v`` in sorted order (G, Tg*k) back in assignment order."""
    return torch.empty_like(v).scatter_(1, order, v)


def moe(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar): JAX's ``moe`` off
    a mesh, which is its grouped path for either ``moe_impl``."""
    return moe_gspmd(p, x, cfg)


def moe_gspmd(p, x, cfg):
    B, S, d = x.shape
    E, k = _padded_experts(cfg), cfg.moe_top_k
    T = B * S
    G = _num_groups(T)
    Tg = T // G
    C = _capacity(Tg, cfg)
    xt = constrain(x.reshape(G, Tg, d), "tokens_grouped")
    r = route(p["router"], xt, cfg, C)

    # ---- dispatch: each kept assignment's token row into its slot --------
    slot_a = _unsort(r["order"], r["slot"])                  # (G, Tg*k)
    keep_a = _unsort(r["order"], r["keep"])
    src = xt[:, :, None, :].expand(G, Tg, k, d).reshape(G, Tg * k, d)
    buf = torch.zeros((G, E * C + 1, d), dtype=x.dtype, device=x.device)
    buf = buf.scatter(1, slot_a[..., None].expand(G, Tg * k, d), src)
    h = constrain(buf[:, :E * C].reshape(G, E, C, d), "moe_buffer")

    # ---- expert FFN (grouped products over E) ---------------------------
    he = h.transpose(0, 1).reshape(E, G * C, d)
    gte = cm.dot_f32(he, p["wi_gate"])
    u = cm.dot_f32(he, p["wi_up"])
    act = constrain((F.silu(gte) * u).to(x.dtype), "moe_buffer")
    y = cm.dot_f32(act, p["wo"]).to(x.dtype)                 # (E, G*C, d)
    yflat = y.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: a gather a (token, choice), summed over the k choices --
    idx = slot_a.clamp(max=E * C - 1)
    gathered = torch.gather(yflat, 1, idx[..., None].expand(G, Tg * k, d))
    wk = (r["w"].reshape(G, Tg * k) * keep_a).to(x.dtype)
    out = (gathered * wk[..., None]).reshape(G, Tg, k, d).sum(2)
    out = constrain(out, "tokens_grouped")

    # ---- aux load-balancing loss (Switch eq. 4, global) -----------------
    frac_tokens = torch.sum(r["counts"], dim=0).float() / (T * k)
    mean_prob = torch.mean(r["probs"], dim=(0, 1))
    aux = (cfg.num_experts * torch.sum(frac_tokens * mean_prob)
           * cfg.router_aux_weight)

    if "shared" in p:
        out = out + mlp(p["shared"], xt, cfg)
    return out.reshape(B, S, d), aux
