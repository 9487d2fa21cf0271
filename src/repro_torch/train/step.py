"""Train and serve steps (port of ``repro/train/step.py``).

``make_train_step``: gradients of ``train_loss`` (CE + MoE aux) with
respect to every parameter by ``torch.autograd.grad`` -> clip -> AdamW;
optional gradient accumulation over microbatches in f32.

``make_ddp_train_step``: the explicit data-parallel step over a
:class:`repro_torch.core._dist.ShardGroup` (JAX's ``shard_map`` over the
data axis): parameters replicated, each rank's gradients from its rows of
the batch, then the int8 error-feedback compressed mean (or an
``all_reduce`` mean), and the same update on every rank.

``make_prefill_step`` / ``make_decode_step``: the serving entry points.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.tree import leaves, tree_map, unflatten
from repro_torch.sharding.rules import is_dtensor
from repro_torch.train import compression as comp
from repro_torch.train.optimizer import OptConfig, adamw_update
from repro_torch.train.state import TrainState


def value_and_grad(params, batch, cfg):
    """(loss, metrics, grads): ``train_loss`` and its gradient in each
    parameter (in the parameter's dtype), as ``jax.value_and_grad``."""
    with torch.enable_grad():
        ps = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, metrics = T.train_loss(ps, batch, cfg)
        flat = leaves(ps)
        gs = torch.autograd.grad(loss, flat, allow_unused=True)
    gs = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]
    if any(is_dtensor(g) for g in gs):
        gs = _as_params(gs, flat)
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(params, gs))


def _as_params(grads, params) -> list:
    """DTensor gradients laid out as their parameters: their partial sums
    over the data shards and the model axis reduced.  Gradients that are
    partial sums or replicas on every mesh axis, of one dtype and one
    target layout, are reduced as one flat buffer (one all-reduce a
    bucket, as DDP buckets them; each element's sum is the same); the
    rest one by one."""
    from torch.distributed.tensor import DTensor, Shard

    out = list(grads)
    buckets: dict = {}
    for i, (g, p) in enumerate(zip(grads, params)):
        if tuple(g.placements) == tuple(p.placements):
            continue
        if any(isinstance(pl, Shard) for pl in (*g.placements,
                                                *p.placements)):
            out[i] = g.redistribute(p.device_mesh, p.placements)
            continue
        buckets.setdefault((tuple(g.placements), tuple(p.placements),
                            g.dtype), []).append(i)
    for (have, want, _), idx in buckets.items():
        mesh = grads[idx[0]].device_mesh
        flat = torch.cat([grads[i].to_local().reshape(-1) for i in idx])
        flat = DTensor.from_local(flat, mesh, have, run_check=False
                                  ).redistribute(mesh, want).to_local()
        for i, part in zip(idx, torch.split(
                flat, [grads[i].numel() for i in idx])):
            out[i] = DTensor.from_local(part.view(grads[i].shape), mesh,
                                        want, run_check=False)
    return out


def make_train_step(cfg, opt_cfg: OptConfig, *, grad_accum: int = 1):
    def train_step(state: TrainState, batch):
        if grad_accum == 1:
            loss, metrics, grads = value_and_grad(state.params, batch, cfg)
        else:
            Bsz = batch["tokens"].shape[0]
            assert Bsz % grad_accum == 0
            mb = Bsz // grad_accum
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), state.params)
            loss = torch.zeros((), dtype=torch.float32,
                               device=batch["tokens"].device)
            ms = []
            for i in range(grad_accum):
                micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, m, g = value_and_grad(state.params, micro, cfg)
                grads = tree_map(lambda a, b: a + b.float(), grads, g)
                loss = loss + l
                ms.append(m)
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = loss / grad_accum
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]))
                       for k in ms[0]}

        new_params, new_opt, om = adamw_update(
            grads, state.opt_state, state.params, opt_cfg)
        new_state = TrainState(new_params, new_opt, state.step + 1)
        return new_state, {"loss": loss, **metrics, **om}

    return train_step


def make_ddp_train_step(cfg, opt_cfg: OptConfig, group, *,
                        compress: bool = True):
    """Explicit-DP step over ``group`` with int8 EF compression.  The
    returned ``step(params, opt_state, err, batch)`` is called on every
    rank with the same global batch; it returns (params, opt_state, err,
    the group's mean loss)."""

    def step(params, opt_state, err, batch):
        Bsz = batch["tokens"].shape[0]
        if Bsz % group.size:
            raise ValueError(f"batch {Bsz} does not split over "
                             f"{group.size} ranks")
        rows = slice(group.rank * (Bsz // group.size),
                     (group.rank + 1) * (Bsz // group.size))
        local = {k: v[rows] for k, v in batch.items()}
        loss, _, grads = value_and_grad(params, local, cfg)
        if compress:
            grads, err = comp.compress_tree(grads, err, group)
        else:
            grads = tree_map(
                lambda g: group.all_reduce(g.clone(), "sum") / group.size,
                grads)
        new_params, new_opt, _ = adamw_update(grads, opt_state, params,
                                              opt_cfg)
        mean_loss = group.all_reduce(loss.clone(), "sum") / group.size
        return new_params, new_opt, err, mean_loss

    return step


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def make_prefill_step(cfg, *, max_len: int):
    def prefill_step(params, tokens, image_embeds=None, encoder_frames=None):
        return T.prefill(params, tokens, cfg, max_len=max_len,
                         image_embeds=image_embeds,
                         encoder_frames=encoder_frames)
    return prefill_step


def make_decode_step(cfg):
    def decode_step(params, token, pos, caches, image_embeds=None):
        return T.decode_step(params, token, pos, caches, cfg,
                             image_embeds=image_embeds)
    return decode_step
