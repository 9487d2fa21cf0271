"""Meta-device input stand-ins + shardings for every LM cell (port of
``repro/launch/specs.py``).

``build_cell(arch, shape_name, mesh)`` returns what one (architecture x
input shape) cell's step takes: the step callable, its arguments as
``torch.empty(..., device="meta")`` stand-ins (JAX's
``ShapeDtypeStruct``), and the in/out specs from the rules engine, with
no memory allocated.  Trees are the port's (one dict a layer); the specs
of a per-layer leaf are JAX's for its stacked leaf with the rep entry
dropped (``sharding.rules.port_param_specs`` / ``port_cache_specs``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.models import transformer as T
from repro_torch.sharding import rules
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.state import TrainState, train_state_shape
from repro_torch.train.step import make_train_step


def S32(shape):
    return torch.empty(shape, dtype=torch.int32, device="meta")


def BF16(shape):
    return torch.empty(shape, dtype=torch.bfloat16, device="meta")


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                 # train | prefill | decode
    step_fn: Callable
    args: tuple               # meta-device stand-ins
    in_shardings: tuple
    out_shardings: Any
    cfg: Any
    meta: dict


def _modality_specs(cfg, B, S):
    extras = {}
    if cfg.num_image_tokens:
        extras["image_embeds"] = BF16((B, cfg.num_image_tokens, cfg.d_model))
    if cfg.encoder_segments:
        extras["encoder_frames"] = BF16(
            (B, S // cfg.audio_downsample, cfg.d_model))
    return extras


def default_opt_config(cfg) -> OptConfig:
    # bf16 moments for 1T-class models (see train/optimizer.py)
    big = cfg.param_count() > 50e9
    return OptConfig(moment_dtype="bfloat16" if big else "float32")


def default_grad_accum(cfg, B: int) -> int:
    """Microbatching keeps a device's activation memory inside its budget
    at train_4k's global batch 256."""
    if cfg.d_model >= 4096:
        return 4
    if cfg.d_model >= 1152:
        return 2
    return 1


def build_cell(arch: str, shape_name: str, mesh, *,
               opt_cfg: OptConfig | None = None,
               grad_accum: int | None = None,
               cfg_overrides: dict | None = None) -> Cell:
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len

    if shape.kind == "train":
        opt_cfg = opt_cfg or default_opt_config(cfg)
        accum = grad_accum or default_grad_accum(cfg, B)
        state_shape = train_state_shape(cfg, opt_cfg)
        batch = {"tokens": S32((B, S)), "labels": S32((B, S)),
                 **_modality_specs(cfg, B, S)}
        state_sh = TrainState(
            params=rules.port_param_specs(state_shape.params, cfg, mesh),
            opt_state={
                "mu": rules.port_param_specs(state_shape.opt_state["mu"],
                                             cfg, mesh),
                "nu": rules.port_param_specs(state_shape.opt_state["nu"],
                                             cfg, mesh),
                "count": rules.replicated(mesh),
            },
            step=rules.replicated(mesh),
        )
        batch_sh = rules.batch_shardings(batch, mesh)
        step = make_train_step(cfg, opt_cfg, grad_accum=accum)
        return Cell(arch, shape_name, "train", step,
                    (state_shape, batch), (state_sh, batch_sh),
                    (state_sh, None), cfg,
                    {"tokens_per_step": B * S, "grad_accum": accum})

    params_shape = T.init_params(cfg, device="meta")
    params_sh = rules.port_param_specs(params_shape, cfg, mesh)
    extras = _modality_specs(cfg, B, S)

    if shape.kind == "prefill":
        tokens = S32((B, S))

        def prefill_step(params, tokens, extras=None):
            return T.prefill(params, tokens, cfg, max_len=S,
                             **(extras or {}))

        args = (params_shape, tokens)
        in_sh = (params_sh, rules.batch_shardings(tokens, mesh))
        if extras:
            args = args + (extras,)
            in_sh = in_sh + (rules.batch_shardings(extras, mesh),)
        return Cell(arch, shape_name, "prefill", prefill_step, args,
                    in_sh, None, cfg, {"tokens_per_step": B * S})

    # ---- decode ----
    caches_shape = T.init_cache(cfg, B, S, torch.bfloat16, device="meta")
    caches_sh = rules.port_cache_specs(caches_shape, mesh)
    token, pos = S32((B, 1)), S32((B,))
    img = extras.get("image_embeds")

    def decode_step(params, token, pos, caches, image_embeds=None):
        return T.decode_step(params, token, pos, caches, cfg,
                             image_embeds=image_embeds)

    args = (params_shape, token, pos, caches_shape)
    in_sh = (params_sh, rules.batch_shardings(token, mesh),
             rules.batch_shardings(pos, mesh), caches_sh)
    if img is not None:
        args = args + (img,)
        in_sh = in_sh + (rules.batch_shardings(img, mesh),)
    out_sh = (None, caches_sh, None)
    return Cell(arch, shape_name, "decode", decode_step, args, in_sh,
                out_sh, cfg, {"tokens_per_step": B})
