"""Dense FFN: SwiGLU (gate ⊙ up -> down), the FFN of every assigned arch
(port of ``repro/models/mlp.py``)."""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.sharding.rules import constrain, relayout


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
    """The gate and up products stay f32 through ``silu``, as JAX's; the
    down projection follows JAX's ``bf16_partial_reduce`` switch
    (:func:`repro_torch.models.common.matmul_reduce`)."""
    # a decode step's partial sums reduced into the "ffh" layout before
    # silu, on every torch version (rules.relayout)
    g = relayout(cm.dot_f32(x, p["wi_gate"]), "ffh")
    u = cm.dot_f32(x, p["wi_up"])
    h = constrain((F.silu(g) * u).to(x.dtype), "ffh")
    # on a mesh the down projection's sums over the model axis are
    # reduced here, as the attention's output projection's are (XLA's
    # partitioner places this on its own; DTensor's per-op choice would
    # carry the partial sums into the next layer's products)
    return constrain(cm.matmul_reduce(h, p["wo"], cfg), "hidden")
