"""Analytic per-device memory model for every LM cell (port of
``repro/launch/memory_model.py``).

Parameter, optimizer and cache bytes are exact: computed from the port's
meta-device trees and divided by each leaf's shard count from the rules
engine (``sharding.rules.shard_shape``: replicated-on-model leaves,
padded experts and fsdp fallbacks exact).  Activation carries use JAX's
block-remat formula (L x microbatch x S x d x 2 B bf16 + the f32 working
set of one layer).  The fit is judged against one card's memory: the
CUDA device's ``total_memory`` when there is one, else the NVIDIA H100
80GB HBM3's.

    PYTHONPATH=src python -m repro_torch.launch.memory_model [--mesh pod]
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.configs import ARCHS, LONG_CONTEXT_ARCHS, SHAPES, get_config
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.specs import default_grad_accum, default_opt_config
from repro_torch.models import transformer as T
from repro_torch.models.tree import leaves
from repro_torch.sharding import rules
from repro_torch.train.state import train_state_shape

#: memory of one NVIDIA H100 80GB HBM3 (the card the port targets), bytes
H100_80GB_HBM3_BYTES = 80e9


def card_memory() -> tuple[str, float]:
    """(name, bytes) of the card the fit is judged against."""
    if torch.cuda.is_available():
        return (torch.cuda.get_device_name(0),
                float(torch.cuda.get_device_properties(0).total_memory))
    return "NVIDIA H100 80GB HBM3", H100_80GB_HBM3_BYTES


def _sharded_bytes(shape_tree, specs, mesh) -> float:
    """Σ one device's shard bytes over the leaves of ``shape_tree``."""
    total = 0.0
    for leaf, spec in zip(leaves(shape_tree),
                          leaves(specs, is_leaf=lambda x: isinstance(
                              x, rules.Spec))):
        shard = rules.shard_shape(tuple(leaf.shape), spec, mesh)
        total += math.prod(shard) * leaf.dtype.itemsize
    return total


def cell_memory(arch: str, shape_name: str, mesh, *,
                card_bytes: float | None = None) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    B, S = shape.global_batch, shape.seq_len
    out = {"arch": arch, "shape": shape_name}

    params_shape = T.init_params(cfg, device="meta")
    p_sh = rules.port_param_specs(params_shape, cfg, mesh)
    out["params_gb"] = _sharded_bytes(params_shape, p_sh, mesh) / 1e9
    dp = max(rules._axis_size(mesh, rules.logical_map(mesh)["dp"]), 1)

    if shape.kind == "train":
        opt = default_opt_config(cfg)
        st = train_state_shape(cfg, opt)
        mu = st.opt_state["mu"]
        mu_sh = rules.port_param_specs(mu, cfg, mesh)
        out["moments_gb"] = 2 * _sharded_bytes(mu, mu_sh, mesh) / 1e9
        out["grads_gb"] = out["params_gb"] * 2   # f32 grads vs bf16 params
        accum = default_grad_accum(cfg, B)
        mb_tokens = B * S // accum // dp
        # block-remat carries (bf16) + one layer f32 working set
        carries = cfg.num_layers * mb_tokens * cfg.d_model * 2
        work = 6 * mb_tokens * max(cfg.d_model, cfg.moe_d_ff or 0,
                                   cfg.d_ff or 0) * 4
        out["activations_gb"] = (carries + work) / 1e9
        out["total_gb"] = sum(out[k] for k in
                              ("params_gb", "moments_gb", "grads_gb",
                               "activations_gb"))
    else:
        caches = T.init_cache(cfg, B, S, torch.bfloat16, device="meta")
        c_sh = rules.port_cache_specs(caches, mesh)
        out["cache_gb"] = _sharded_bytes(caches, c_sh, mesh) / 1e9
        tok = (B * S if shape.kind == "prefill" else B) // dp
        out["activations_gb"] = 8 * tok * cfg.d_model * 2 / 1e9
        out["total_gb"] = (out["params_gb"] + out["cache_gb"]
                           + out["activations_gb"])
    card = card_memory()[1] if card_bytes is None else card_bytes
    out["fits_card"] = out["total_gb"] <= card / 1e9
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod"])
    args = ap.parse_args(argv)
    mesh = make_production_mesh(multi_pod=args.mesh == "multipod")
    name, card = card_memory()
    print(f"analytic per-device memory, {args.mesh} ({mesh.size} "
          f"devices), {name} {card / 1e9:.1f} GB\n")
    hdr = (f"{'arch':24s} {'shape':12s} {'params':>8s} {'opt+grad':>9s} "
           f"{'cache':>7s} {'activ':>7s} {'total':>7s}  fits")
    print(hdr)
    rows = []
    for arch in ARCHS:
        for sh in SHAPES:
            if sh == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                continue
            m = cell_memory(arch, sh, mesh, card_bytes=card)
            rows.append(m)
            og = m.get("moments_gb", 0) + m.get("grads_gb", 0)
            print(f"{arch:24s} {sh:12s} {m['params_gb']:8.2f} "
                  f"{og:9.2f} {m.get('cache_gb', 0):7.2f} "
                  f"{m['activations_gb']:7.2f} {m['total_gb']:7.2f}  "
                  f"{'YES' if m['fits_card'] else 'NO'}")
    return rows


if __name__ == "__main__":
    main()
