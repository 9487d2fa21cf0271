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
direction needs an atomic add: the layer is deterministic on CUDA.

On a device mesh (a DTensor ``x``) the layer runs on each rank's block:
:func:`moe_ep` is JAX's expert-parallel ``shard_map`` over the "model"
axis, and the grouped path routes each data shard's groups locally.  Off
a mesh JAX's ``moe`` takes the grouped path for ``moe_impl="ep"`` too,
and so does the port's.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import common as cm
from repro_torch.models.mlp import init_mlp, mlp
from repro_torch.sharding.rules import (constrain, dp_size, is_dtensor,
                                        layout, local_block, mesh_shape)


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


def _top_k(router, xt, cfg):
    """probs (G, Tg, E) and the renormalized top-k ``w`` / ``ids`` (G, Tg,
    k) of ``xt`` (G, Tg, d), JAX's ops in JAX's order."""
    E, k = _padded_experts(cfg), cfg.moe_top_k
    logits = torch.matmul(xt.float(), router)
    probs = torch.softmax(logits, dim=-1)                    # (G, Tg, E_real)
    if E > cfg.num_experts:                                  # dead experts
        probs = F.pad(probs, (0, E - cfg.num_experts))
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[..., :k], ids[..., :k]
    w = w / torch.sum(w, dim=-1, keepdim=True)               # renormalize
    return probs, w, ids


def _dispatch(flat_ids, n_bins: int, C: int, n_real: int | None = None):
    """The sorted dispatch of expert ids ``flat_ids`` (G, N) over
    ``n_bins`` bins of capacity C: (counts (G, n_bins), and in sorted
    order the argsort ``order``, ``keep`` and ``slot``).  Ids at or past
    ``n_real`` (expert parallelism's "not mine" bin) are never kept;
    a dropped assignment's slot is ``n_real * C``."""
    G, N = flat_ids.shape
    n_real = n_bins if n_real is None else n_real
    order = torch.argsort(flat_ids, dim=-1, stable=True)
    sorted_e = torch.gather(flat_ids, 1, order)
    counts = torch.zeros((G, n_bins), dtype=torch.long,
                         device=flat_ids.device)
    counts.scatter_add_(1, flat_ids, torch.ones_like(flat_ids))
    starts = torch.cumsum(counts, dim=-1) - counts
    pos_in_e = (torch.arange(N, device=flat_ids.device)[None, :]
                - torch.gather(starts, 1, sorted_e))
    keep = pos_in_e < C
    if n_real < n_bins:
        keep = keep & (sorted_e < n_real)
    slot = torch.where(keep, sorted_e * C + pos_in_e, n_real * C)
    return counts, order, keep, slot


def route(router, xt, cfg, C: int) -> dict:
    """Routing of ``xt`` (G, Tg, d), JAX's ops in JAX's order.  Returns
    probs (G, Tg, E), the top-k ``w`` / ``ids`` (G, Tg, k), the per-group
    expert ``counts`` (G, E), and in JAX's sorted order (G, Tg*k) the
    argsort ``order``, ``keep`` and ``slot`` (E*C for a dropped
    assignment)."""
    G, Tg, _ = xt.shape
    probs, w, ids = _top_k(router, xt, cfg)
    counts, order, keep, slot = _dispatch(
        ids.reshape(G, Tg * cfg.moe_top_k), _padded_experts(cfg), C)
    return dict(probs=probs, w=w, ids=ids, counts=counts, order=order,
                keep=keep, slot=slot)


def _unsort(order, v):
    """``v`` in sorted order (G, Tg*k) back in assignment order."""
    return torch.empty_like(v).scatter_(1, order, v)


def _experts(xt, w, order, keep, slot, wi_gate, wi_up, wo, C: int):
    """Dispatch ``xt`` (G, Tg, d) into the (G, E, C, d) buffer of the
    experts ``wi_gate`` / ``wi_up`` / ``wo`` (E leading), run them, and
    combine: (G, Tg, d), each token's kept choices weighted by ``w``."""
    G, Tg, d = xt.shape
    E, k = wi_gate.shape[0], w.shape[-1]
    slot_a = _unsort(order, slot)                            # (G, Tg*k)
    keep_a = _unsort(order, keep)
    src = xt[:, :, None, :].expand(G, Tg, k, d).reshape(G, Tg * k, d)
    buf = torch.zeros((G, E * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf = buf.scatter(1, slot_a[..., None].expand(G, Tg * k, d), src)
    h = constrain(buf[:, :E * C].reshape(G, E, C, d), "moe_buffer")

    # ---- expert FFN (grouped products over E) ---------------------------
    he = h.transpose(0, 1).reshape(E, G * C, d)
    gte = cm.dot_f32(he, wi_gate)
    u = cm.dot_f32(he, wi_up)
    act = constrain((F.silu(gte) * u).to(xt.dtype), "moe_buffer")
    y = cm.dot_f32(act, wo).to(xt.dtype)                     # (E, G*C, d)
    yflat = y.reshape(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)

    # ---- combine: a gather a (token, choice), summed over the k choices --
    idx = slot_a.clamp(max=E * C - 1)
    gathered = torch.gather(yflat, 1, idx[..., None].expand(G, Tg * k, d))
    wk = (w.reshape(G, Tg * k) * keep_a).to(xt.dtype)
    return (gathered * wk[..., None]).reshape(G, Tg, k, d).sum(2)


def moe(p, x, cfg):
    """x: (B, S, d) -> (out (B, S, d), aux_loss scalar).

    Dispatches to the expert-parallel :func:`moe_ep` when
    ``cfg.moe_impl == "ep"``, ``x`` is a DTensor on a device mesh whose
    "model" axis divides the (padded) expert count, and a data shard holds
    at least 1024 tokens (JAX's cut: decode-sized token counts do not
    amortize the combine's all-reduce); else the grouped path."""
    if cfg.moe_impl == "ep" and is_dtensor(x):
        mesh = x.device_mesh
        sh = mesh_shape(mesh)
        T_loc = (x.shape[0] * x.shape[1]) // max(_dp(mesh), 1)
        if ("model" in sh and _padded_experts(cfg) % sh["model"] == 0
                and T_loc >= 1024):
            return moe_ep(p, x, cfg, mesh)
    if is_dtensor(x):
        return _moe_grouped_mesh(p, x, cfg, x.device_mesh)
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
    out = _experts(xt, r["w"], r["order"], r["keep"], r["slot"],
                   p["wi_gate"], p["wi_up"], p["wo"], C)
    out = constrain(out, "tokens_grouped")

    # ---- aux load-balancing loss (Switch eq. 4, global) -----------------
    frac_tokens = torch.sum(r["counts"], dim=0).float() / (T * k)
    mean_prob = torch.mean(r["probs"], dim=(0, 1))
    aux = (cfg.num_experts * torch.sum(frac_tokens * mean_prob)
           * cfg.router_aux_weight)

    if "shared" in p:
        out = out + mlp(p["shared"], xt, cfg)
    return out.reshape(B, S, d), aux


# ---------------------------------------------------------------------------
# on a device mesh: the grouped path a data shard at a time, and the
# expert-parallel path (JAX's shard_map over the "model" axis)
# ---------------------------------------------------------------------------
#
# Both run on each rank's local block (``DTensor.to_local``) and name the
# placements of every input's gradient, as JAX's shard_map names its
# specs: a weight that every data shard uses gets a partial-sum gradient
# over the data axes, one whose experts a model rank holds alone a
# partial sum over "model" too; the rank's output comes back as a DTensor
# of the same layout.


def _dp(mesh) -> int:
    sh = mesh_shape(mesh)
    return math.prod(sh[a] for a in ("pod", "data") if a in sh)


def _rows(sharded: bool) -> tuple:
    """(the placement of a tensor's batch rows on the dp axes, that of a
    gradient every data shard adds to): ``Shard(0)`` and a partial sum
    when the batch is split over them, else both replicated."""
    return (Shard(0), Partial()) if sharded else (Replicate(), Replicate())


def _global_sum(v, mesh, x_sharded: bool):
    """Sum of a rank's ``v`` over the data shards (identical over the
    model axis), differentiable: a partial DTensor made whole."""
    if not x_sharded or _dp(mesh) == 1:
        return v
    part = layout(mesh, data=Partial(), model=Replicate())
    rep = (Replicate(),) * mesh.ndim
    return DTensor.from_local(v, mesh, part, run_check=False).redistribute(
        mesh, rep).to_local()


def _switch_aux(cfg, cnt, prob_sum, T_global: int):
    k = cfg.moe_top_k
    frac = cnt.float() / (T_global * k)
    mean_prob = prob_sum / T_global
    return (cfg.num_experts * torch.sum(frac * mean_prob)
            * cfg.router_aux_weight)


def _moe_grouped_mesh(p, x, cfg, mesh):
    """The grouped path on a DTensor ``x``: each data shard routes its own
    groups (JAX's groups are the data shards), every model rank runs all
    experts, and the aux loss takes its counts and probabilities summed
    over the data shards."""
    B, S, d = x.shape
    T = B * S
    G = _num_groups(T)
    Tg = T // G
    C = _capacity(Tg, cfg)
    dp = _dp(mesh)
    sharded = B % dp == 0 and G == dp
    rep = (Replicate(),) * mesh.ndim
    rows, dgrad = _rows(sharded)
    xl_pl = layout(mesh, data=rows, model=Replicate())
    w_grad = layout(mesh, data=dgrad, model=Replicate())
    xl = local_block(x, mesh, xl_pl, xl_pl)
    ws = [local_block(p[n], mesh, rep, w_grad)
          for n in ("router", "wi_gate", "wi_up", "wo")]
    xt = xl.reshape(-1, Tg, d)
    probs, w, ids = _top_k(ws[0], xt, cfg)
    G_loc = xt.shape[0]
    counts, order, keep, slot = _dispatch(
        ids.reshape(G_loc, Tg * cfg.moe_top_k), _padded_experts(cfg), C)
    out = _experts(xt, w, order, keep, slot, *ws[1:], C)
    cnt = _global_sum(torch.sum(counts, dim=0).float(), mesh, sharded)
    psum = _global_sum(torch.sum(probs, dim=(0, 1)), mesh, sharded)
    aux = DTensor.from_local(_switch_aux(cfg, cnt, psum, T), mesh, rep,
                             run_check=False)
    out = DTensor.from_local(out.reshape(xl.shape), mesh, xl_pl,
                             run_check=False)
    if "shared" in p:
        out = out + mlp(p["shared"], x, cfg)
    return out, aux


# Between tensor-parallel layers the hidden states are replicated over the
# model axis, so every model rank holds all of its data shard's tokens:
# expert parallelism needs no dispatch all-to-all.  Each rank routes
# identically, keeps the assignments of its own expert slice, runs those
# experts, combines its partial output, and one sum all-reduce over
# "model" completes the combine (JAX's ``moe_ep``).

def moe_ep(p, x, cfg, mesh):
    """x: (B, S, d) DTensor on ``mesh``: the batch over the dp axes when
    it divides, replicated over "model"; each model rank holds E / ep of
    the padded experts."""
    E, k = _padded_experts(cfg), cfg.moe_top_k
    ep = mesh_shape(mesh)["model"]
    E_loc = E // ep
    m = mesh.get_local_rank("model")
    B, S, d = x.shape
    dp = _dp(mesh)
    sharded = B % max(dp, 1) == 0
    rep = (Replicate(),) * mesh.ndim
    rows, dgrad = _rows(sharded)
    xl_pl = layout(mesh, data=rows, model=Replicate())
    x_grad = layout(mesh, data=rows, model=Partial())
    w_pl = layout(mesh, data=Replicate(), model=Shard(0))
    w_grad = layout(mesh, data=dgrad, model=Shard(0))
    r_grad = layout(mesh, data=dgrad, model=Partial())
    xl = local_block(x, mesh, xl_pl, x_grad)
    router = local_block(p["router"], mesh, rep, r_grad)
    wig, wiu, wog = (local_block(p[n], mesh, w_pl, w_grad)
                     for n in ("wi_gate", "wi_up", "wo"))

    Bl, Sl, _ = xl.shape
    T = Bl * Sl
    C = _capacity(T, cfg)
    xt = xl.reshape(1, T, d)
    probs, w, ids = _top_k(router, xt, cfg)
    e_base = m * E_loc
    lids = torch.where((ids >= e_base) & (ids < e_base + E_loc),
                       ids - e_base, E_loc)                  # E_loc: not mine
    _, order, keep, slot = _dispatch(lids.reshape(1, T * k), E_loc + 1, C,
                                     E_loc)
    partial = _experts(xt, w, order, keep, slot, wig, wiu, wog, C)
    out_pl = layout(mesh, data=rows, model=Partial())
    out = DTensor.from_local(partial.reshape(Bl, Sl, d), mesh, out_pl,
                             run_check=False).redistribute(mesh, xl_pl)

    # aux: routing statistics summed over the data shards, so the load
    # balance matches the grouped path; every model rank holds the same
    # value, so JAX's psum over "model" / ep is a partial sum of value / ep
    cnt = torch.zeros(E, dtype=torch.long, device=ids.device)
    cnt.scatter_add_(0, ids.reshape(-1), torch.ones_like(ids.reshape(-1)))
    cnt = _global_sum(cnt.float(), mesh, sharded)
    psum = _global_sum(torch.sum(probs, dim=(0, 1)), mesh, sharded)
    aux = _switch_aux(cfg, cnt, psum, T * (dp if sharded else 1)) / ep
    aux_pl = layout(mesh, data=Replicate(), model=Partial())
    aux = DTensor.from_local(aux, mesh, aux_pl, run_check=False
                             ).redistribute(mesh, rep)
    if "shared" in p:
        out = out + mlp(p["shared"], x, cfg)
    return out, aux
