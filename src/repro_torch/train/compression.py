"""int8 error-feedback gradient compression for the data-parallel group
(port of ``repro/train/compression.py``).

Each rank quantizes (grad + carried error) to int8 with a per-tensor
scale, all-gathers the int8 payloads and the scales over its
:class:`repro_torch.core._dist.ShardGroup`, and dequant-averages
locally; the quantization residual is carried into the next step (error
feedback).  The payload is gathered as int8, one byte an element (gloo
and NCCL both carry int8).  Used by ``train.step.make_ddp_train_step``.
"""
from __future__ import annotations

import torch

from repro_torch.models.tree import leaves, tree_map, unflatten


def quantize_int8(x):
    """Symmetric per-tensor int8.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_mean(g, err, group):
    """Error-feedback int8 all-gather mean over ``group``.  Returns
    (g_hat, the mean of the dequantized payloads; new_err)."""
    target = g.float() + err
    q, scale = quantize_int8(target)
    new_err = target - dequantize_int8(q, scale)
    qs = group.all_gather(q[None])                   # (P, ...) int8
    ss = group.all_gather(scale.reshape(1))          # (P,)
    g_hat = torch.mean(qs.float() * ss.reshape((-1,) + (1,) * g.dim()),
                       dim=0)
    return g_hat, new_err


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_tree(grads, err_state, group):
    """:func:`compressed_mean` leaf by leaf."""
    outs = [compressed_mean(g, e, group)
            for g, e in zip(leaves(grads), leaves(err_state))]
    return (unflatten(grads, [o[0] for o in outs]),
            unflatten(grads, [o[1] for o in outs]))
