"""The four mesh-tested smoke archs on a (data, model) = (1, 2) DTensor
mesh of two gloo ranks sharing one CUDA card, in f32 and bf16, against
the same model on one rank (under an abstract (1, 2) mesh, so the MoE
groups and the attention branch match), and both against the f32
gradients of the same parameter values.  A failing arch records its
traceback and the others still run.  One JSON line an (arch, dtype):
the losses; the largest gradient error relative to the leaf's largest
entry, mesh against one rank; and the worst leaf's ||g - r|| / ||r||,
each of the two against f32 (in bf16 the mesh and one rank round apart,
so the f32 gradient is the reference both are held to); or the error.

    python3 tools/mesh_cuda_check.py
"""
from __future__ import annotations

import dataclasses
import faulthandler
import json
import sys
import tempfile
import traceback
from pathlib import Path

ARCHS = ("gemma3-1b", "qwen1.5-0.5b", "qwen2-moe-a2.7b", "mamba2-130m")


def _rank(group):
    import torch
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.configs import get_config, make_smoke
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import transformer as T
    from repro_torch.models.tree import leaves, tree_map
    from repro_torch.sharding import rules
    from repro_torch.train.step import value_and_grad

    faulthandler.enable()
    dev = group.device
    mesh = make_host_mesh(1, 2, device_type=dev.type)
    rep = [Replicate()] * 2
    dt = lambda t: DTensor.from_local(t, mesh, rep, run_check=False)
    out = {}
    for arch in ARCHS:
        for dtype in ("float32", "bfloat16"):
            try:
                cfg = make_smoke(get_config(arch))
                cfg = dataclasses.replace(
                    cfg, param_dtype=dtype,
                    expert_pad_to=8 if cfg.num_experts else 0)
                p = T.init_params(cfg, torch.Generator(dev).manual_seed(0),
                                  dev)
                tok = torch.randint(0, cfg.vocab_size, (4, 32), device=dev,
                                    generator=torch.Generator(dev)
                                    .manual_seed(1))
                b = {"tokens": tok, "labels": tok.roll(-1, 1)}
                with rules.set_mesh(rules.AbstractMesh(
                        (1, 2), ("data", "model"))):
                    l0, _, g0 = value_and_grad(p, b, cfg)
                    lf, _, gf = value_and_grad(
                        tree_map(lambda t: t.float(), p), b,
                        dataclasses.replace(cfg, param_dtype="float32"))
                with rules.set_mesh(mesh):
                    l1, _, g1 = value_and_grad(
                        tree_map(dt, p), {k: dt(v) for k, v in b.items()},
                        cfg)
                g1 = [a.full_tensor().float() for a in leaves(g1)]
                g0 = [c.float() for c in leaves(g0)]
                gf = [c.float() for c in leaves(gf)]
                err = max(float((a - c).abs().max())
                          / (float(c.abs().max()) + 1e-30)
                          for a, c in zip(g1, g0))
                fro = lambda gs: max(float((a - c).norm())
                                     / (float(c.norm()) + 1e-30)
                                     for a, c in zip(gs, gf))
                out[f"{arch}/{dtype}"] = dict(
                    loss_one_rank=float(l0), loss_mesh=float(
                        l1.full_tensor()), loss_f32=float(lf),
                    grad_max_rel_err=err, one_rank_vs_f32_worst_leaf=fro(g0),
                    mesh_vs_f32_worst_leaf=fro(g1))
            except Exception:          # the finding: record and go on
                out[f"{arch}/{dtype}"] = dict(
                    error=traceback.format_exc()[-1500:])
    return out


def main() -> int:
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core._dist import spawn
    with tempfile.TemporaryDirectory() as tmp:
        res = spawn(_rank, 2, backend="gloo", store_dir=tmp, timeout=900,
                    shared_device="cuda:0")
    for k, v in res[0].items():
        print(json.dumps({k: v}), flush=True)
    return 0 if all("error" not in v for v in res[0].values()) else 1


if __name__ == "__main__":
    raise SystemExit(main())
