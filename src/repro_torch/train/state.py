"""Train state + construction helpers (port of ``repro/train/state.py``).

``TrainState`` has JAX's field names, so checkpoint leaf names match
JAX's (``.params_...``, ``.opt_state_mu_...``, ``.step``).  The port's
state holds its flat-layer parameters; :func:`state_to_jax` and
:func:`state_from_jax` carry a state across to JAX's stacked layout,
which is what a checkpoint stores.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.core.api import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.convert import from_jax_params, to_jax_layout
from repro_torch.train.optimizer import OptConfig, init_opt_state


@dataclasses.dataclass
class TrainState:
    params: Any
    opt_state: Any
    step: torch.Tensor


def init_train_state(cfg, opt_cfg: OptConfig, generator=None,
                     device="cuda") -> TrainState:
    """Random parameters drawn on ``device`` from ``generator``, zeroed
    moments, step 0."""
    dev = resolve_device(device)
    params = T.init_params(cfg, generator, dev)
    return TrainState(params=params,
                      opt_state=init_opt_state(params, opt_cfg),
                      step=torch.zeros((), dtype=torch.int32, device=dev))


def train_state_shape(cfg, opt_cfg: OptConfig) -> TrainState:
    """The state's shapes and dtypes on the meta device (no allocation)."""
    return init_train_state(cfg, opt_cfg, None, "meta")


def state_to_jax(state: TrainState, cfg) -> TrainState:
    """``state`` with its parameters and moments in JAX's stacked layout."""
    opt = state.opt_state
    return TrainState(
        params=to_jax_layout(state.params, cfg),
        opt_state={"count": opt["count"],
                   "mu": to_jax_layout(opt["mu"], cfg),
                   "nu": to_jax_layout(opt["nu"], cfg)},
        step=state.step)


def state_from_jax(state: TrainState, cfg, device="cuda") -> TrainState:
    """The inverse of :func:`state_to_jax`, its tensors moved to
    ``device``."""
    dev = resolve_device(device)
    opt = state.opt_state
    return TrainState(
        params=from_jax_params(state.params, cfg, dev),
        opt_state={"count": opt["count"].to(dev),
                   "mu": from_jax_params(opt["mu"], cfg, dev),
                   "nu": from_jax_params(opt["nu"], cfg, dev)},
        step=state.step.to(dev))
