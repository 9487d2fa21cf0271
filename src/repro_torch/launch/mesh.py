"""Mesh construction (port of ``repro/launch/mesh.py``).

``make_production_mesh`` gives the abstract pod meshes that the specs and
the memory model reason about (no devices: a (16, 16) pod is 256 chips
the port never holds).  ``make_host_mesh`` gives a real
``DeviceMesh`` over the ranks of the default process group, which
``core._dist.spawn`` / ``open_group`` start: one rank a device.
"""
from __future__ import annotations

from repro_torch.sharding.rules import AbstractMesh


def make_production_mesh(*, multi_pod: bool = False) -> AbstractMesh:
    """16×16 = 256 chips a pod; multi-pod adds a leading pod=2 axis
    (512)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return AbstractMesh(shape, axes)


def make_host_mesh(data: int | None = None, model: int = 1, *,
                   device_type: str | None = None):
    """A ``(data, model)`` mesh over this process group's ranks
    (``data`` defaults to the world size over ``model``).  A world of one
    gives the abstract (1, 1) mesh: no DTensor, the models' plain path.
    ``device_type`` defaults to the type of the ranks' devices (CUDA when
    this rank has a current card, else the CPU).  A CUDA mesh over gloo
    ranks (sharing a card) routes DTensor's all-gathers through
    ``core._dist.install_gloo_cuda_gather``."""
    import torch
    import torch.distributed as dist

    world = dist.get_world_size() if dist.is_initialized() else 1
    if data is None:
        data = world // model
    if data * model != world:
        raise ValueError(f"a ({data}, {model}) mesh needs {data * model} "
                         f"ranks; the process group has {world}")
    if world == 1:
        return AbstractMesh((1, 1), ("data", "model"))
    from torch.distributed.device_mesh import DeviceMesh
    if device_type is None:
        device_type = ("cuda" if torch.cuda.is_available()
                       and dist.get_backend() == "nccl" else "cpu")
    if device_type == "cuda" and dist.get_backend() == "gloo":
        from repro_torch.core._dist import install_gloo_cuda_gather
        install_gloo_cuda_gather()
    ranks = torch.arange(world).reshape(data, model)
    return DeviceMesh(device_type, ranks, mesh_dim_names=("data", "model"))
