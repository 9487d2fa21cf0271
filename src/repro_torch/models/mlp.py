"""Dense FFN: SwiGLU (gate ⊙ up -> down), the FFN of every assigned arch
(port of ``repro/models/mlp.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.sharding.rules import constrain


def init_mlp(cfg, generator, device, d_ff=None):
    d = cfg.d_model
    ff = d_ff if d_ff is not None else cfg.d_ff
    dt = cm.dtype_of(cfg)
    return {
        "wi_gate": cm.dense_init((d, ff), dt, generator, device),
        "wi_up": cm.dense_init((d, ff), dt, generator, device),
        "wo": cm.dense_init((ff, d), dt, generator, device, fan_in=ff),
    }


def mlp(p, x, cfg=None):
    """The gate and up products stay f32 through ``silu``, as JAX's.  JAX's
    ``bf16_partial_reduce`` changes only how tensor-parallel partial sums
    are reduced; on one device the down projection is one f32-accumulated
    product either way."""
    g = cm.dot_f32(x, p["wi_gate"])
    u = cm.dot_f32(x, p["wi_up"])
    h = constrain((F.silu(g) * u).to(x.dtype), "ffh")
    return cm.matmul(h, p["wo"])
