"""Architecture registry: ``get_config(arch_id)`` / ``make_smoke(cfg)`` (a
copy of ``repro/configs/__init__.py``; the port builds all ten archs).

Every assigned architecture is selectable by id (``--arch <id>``); smoke
variants keep the family structure (segment patterns, GQA ratios, MoE
routing, SSD shapes) at toy width so one CPU forward/train step runs in
seconds.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import SHAPES, SMOKE_SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "gemma3-1b": "gemma3_1b",
    "gemma2-2b": "gemma2_2b",
    "qwen1.5-0.5b": "qwen15_05b",
    "phi4-mini-3.8b": "phi4_mini",
    "kimi-k2-1t-a32b": "kimi_k2",
    "qwen2-moe-a2.7b": "qwen2_moe",
    "mamba2-130m": "mamba2_130m",
    "zamba2-2.7b": "zamba2_27b",
    "llama-3.2-vision-11b": "llama32_vision",
    "seamless-m4t-medium": "seamless_m4t",
}

ARCHS = tuple(_MODULES)

# archs with only full-attention layers skip long_500k (needs sub-quadratic
# attention; see DESIGN.md §Arch-applicability).
LONG_CONTEXT_ARCHS = ("gemma3-1b", "gemma2-2b", "mamba2-130m", "zamba2-2.7b")


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; choose from {ARCHS}")
    import importlib

    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cells(include_skipped: bool = False):
    """All assigned (arch, shape) cells.  40 total; long_500k is only
    runnable for sub-quadratic archs."""
    out = []
    for arch in ARCHS:
        for shape in SHAPES.values():
            runnable = (shape.name != "long_500k"
                        or arch in LONG_CONTEXT_ARCHS)
            if runnable or include_skipped:
                out.append((arch, shape.name, runnable))
    return out


def make_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: tiny widths, same structure."""
    kv = max(1, 4 * cfg.num_kv_heads // max(cfg.num_heads, 1))
    seg = tuple((pat, min(rep, 2)) for pat, rep in cfg.segments)
    enc = tuple((pat, min(rep, 2)) for pat, rep in cfg.encoder_segments)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        d_model=64,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        segments=seg,
        encoder_segments=enc,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
        num_experts=min(cfg.num_experts, 8),
        num_shared_experts=min(cfg.num_shared_experts, 1),
        moe_top_k=min(cfg.moe_top_k, 2),
        moe_d_ff=64 if cfg.moe_d_ff else 0,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=16,
        num_image_tokens=32 if cfg.num_image_tokens else 0,
        loss_chunk=0,
        remat="none",
        # f32, as the JAX package's smoke configs (XLA:CPU cannot execute
        # bf16 grouped dots), so the port is held to them in f32.
        param_dtype="float32",
    )


__all__ = [
    "ARCHS", "LONG_CONTEXT_ARCHS", "SHAPES", "SMOKE_SHAPES",
    "ModelConfig", "ShapeConfig", "get_config", "make_smoke", "cells",
]
