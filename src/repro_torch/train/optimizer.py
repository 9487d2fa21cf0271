"""AdamW with warmup + cosine schedule, global-norm clipping, weight decay
and a configurable moment dtype (port of ``repro/train/optimizer.py``).

Plain functions over the parameter tree, computed in f32 as JAX's are
(``b1 ** count`` is an f32 power), not ``torch.optim.AdamW``: the decay
mask (keyed on a leaf's own dict key), the bias correction and the cast
back to each parameter's dtype are JAX's.  Moments are stored in
``moment_dtype``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.models.tree import (leaves, leaves_with_path, tree_map,
                                     unflatten)


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"     # float32 | bfloat16


def schedule(step, cfg: OptConfig):
    """The learning rate at ``step`` (a tensor), f32."""
    step = step.float()
    warm = cfg.lr * step / max(cfg.warmup_steps, 1)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return torch.where(step < cfg.warmup_steps, warm, cfg.lr * cos)


def init_opt_state(params, cfg: OptConfig):
    mdt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=mdt, device=p.device)
    count_dev = leaves(params)[0].device
    return {
        "mu": tree_map(zeros, params),
        "nu": tree_map(zeros, params),
        "count": torch.zeros((), dtype=torch.int32, device=count_dev),
    }


def global_norm(tree):
    sq = [torch.sum(torch.square(leaf.float())) for leaf in leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sq)))


def clip_by_global_norm(grads, max_norm):
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / (gn + 1e-9), max=1.0)
    return tree_map(lambda g: g.float() * scale, grads), gn


def _decay_mask(path) -> bool:
    """No weight decay on norms / biases / scalars."""
    kind, name = path[-1] if path else ("idx", None)
    name = name if kind == "key" else ""
    return name not in ("scale", "conv_b", "bq", "bk", "bv", "A_log", "D",
                        "dt_bias", "norm", "gate", "gate_ffn")


def adamw_update(grads, opt_state, params, cfg: OptConfig):
    """Returns (new_params, new_opt_state, metrics)."""
    grads, gn = clip_by_global_norm(grads, cfg.clip_norm)
    count = opt_state["count"] + 1
    lr = schedule(count, cfg)
    c1 = 1.0 - cfg.b1 ** count.float()
    c2 = 1.0 - cfg.b2 ** count.float()
    mdt = getattr(torch, cfg.moment_dtype)

    def upd(path, p, g, mu, nu):
        mu_f = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu_f = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        step = (mu_f / c1) / (torch.sqrt(nu_f / c2) + cfg.eps)
        if _decay_mask(path):
            step = step + cfg.weight_decay * p.float()
        new_p = p.float() - lr * step
        return new_p.to(p.dtype), mu_f.to(mdt), nu_f.to(mdt)

    outs = [upd(path, p, g, mu, nu) for (path, p), g, mu, nu in zip(
        leaves_with_path(params), leaves(grads), leaves(opt_state["mu"]),
        leaves(opt_state["nu"]))]
    new_params = unflatten(params, [o[0] for o in outs])
    new_state = {"mu": unflatten(params, [o[1] for o in outs]),
                 "nu": unflatten(params, [o[2] for o in outs]),
                 "count": count}
    return new_params, new_state, {"grad_norm": gn, "lr": lr}
