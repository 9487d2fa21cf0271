"""Fault-tolerant checkpointing: atomic commit, async writer (port of
``repro/checkpoint/manager.py``, its on-disk format file for file).

Format: one ``.npy`` a tree leaf, named by JAX's ``_leaf_name`` (the
leaf's ``jax.tree_util.keystr`` with every run of other characters than
``[A-Za-z0-9_.-]`` made one ``_``, ends stripped: ``.params_segments_0_0_
ssm_A_log``, ``.opt_state_mu_...``, ``.step``), plus ``manifest.json``
(step, extra, and each leaf's name, dtype and shape).  bfloat16 leaves
are stored as a uint16 view and read back with ``Tensor.view``.  A
checkpoint directory is written as ``tmp.step_<N>`` and renamed to
``step_<N>`` only after every leaf and the manifest are on disk, so a
killed writer never leaves a directory :func:`latest_step` would pick.

Trees are the port's (dicts, lists, tuples, dataclasses of tensors) in
whatever layout the caller gives; ``train.state.state_to_jax`` gives a
train state JAX's stacked layout, and then JAX's ``restore_checkpoint``
reads the port's files and the port reads JAX's.  Restore loads logical
tensors on the CPU, or with ``shardings=`` (a tree of
``sharding.rules.Spec``) distributes each leaf by its spec on a device
mesh (reshard-on-load: every rank reads the full leaf and keeps its
block).  A state that holds DTensors is saved as full logical arrays,
gathered on every rank and written by rank 0 alone, so a checkpoint
written on any mesh restores on any other, and in JAX.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.models.tree import (keystr, leaves, leaves_with_path,
                                     tree_map, unflatten)

_STEP_RE = re.compile(r"^step_(\d+)$")


def _leaf_name(path) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]+", "_", keystr(path)).strip("_")


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    t = t.detach().cpu()
    dt = _dtype_name(t.dtype)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), dt
    return t.numpy(), dt


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.astype(dtype) if str(arr.dtype) != dtype
                            else arr)


def _host_tree(state: Any) -> tuple[Any, bool]:
    """(``state`` as full CPU tensors, whether this rank writes).  A
    DTensor leaf is gathered whole on every rank (a collective: every
    rank calls this), and only rank 0 of the process group writes."""
    import torch.distributed as dist

    from repro_torch.sharding.rules import is_dtensor

    mesh_state = any(is_dtensor(t) for t in leaves(state))
    writer = not (mesh_state and dist.is_initialized()
                  and dist.get_rank() != 0)

    def host(t):
        if is_dtensor(t):
            t = t.full_tensor()           # a collective when sharded
        return t.detach().to("cpu", copy=True) if writer else None

    return tree_map(host, state), writer


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.match(d))]
    return max(steps) if steps else None


def save_checkpoint(ckpt_dir: str, state: Any, step: int,
                    extra: Optional[dict] = None) -> str:
    """Synchronous atomic save.  Returns the committed directory.  Every
    rank of a DTensor state calls it; rank 0 writes."""
    state, writer = _host_tree(state)
    final = os.path.join(ckpt_dir, f"step_{step}")
    if not writer:
        return final
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": []}
    for path, leaf in leaves_with_path(state):
        name = _leaf_name(path)
        arr, dt = _to_numpy(leaf)
        np.save(os.path.join(tmp, name + ".npy"), arr)
        manifest["leaves"].append(
            {"name": name, "dtype": dt, "shape": list(arr.shape)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)   # atomic commit
    return final


def restore_checkpoint(ckpt_dir: str, state_shape: Any, *,
                       step: Optional[int] = None,
                       shardings: Any = None) -> tuple[Any, dict]:
    """Load the latest (or given) step into the structure of
    ``state_shape`` (a tree of anything with ``.shape``: tensors, meta
    tensors).  Returns (state, manifest extra): CPU tensors, or with
    ``shardings`` (a tree of specs of the same structure) DTensors laid
    out by them on the ambient mesh (``sharding.rules.set_mesh``), which
    must be a ``DeviceMesh``."""
    spec_leaves = [None] * len(leaves(state_shape))
    if shardings is not None:
        from repro_torch.sharding import rules
        mesh = rules.get_mesh()
        if mesh is None or isinstance(mesh, rules.AbstractMesh):
            raise ValueError("restoring with shardings= needs an ambient "
                             f"device mesh; got {mesh!r}")
        spec_leaves = [s for _, s in leaves_with_path(
            shardings, is_leaf=lambda x: isinstance(x, rules.Spec))]
        if len(spec_leaves) != len(leaves(state_shape)):
            raise ValueError(f"{len(spec_leaves)} shardings for "
                             f"{len(leaves(state_shape))} leaves")
    s = step if step is not None else latest_step(ckpt_dir)
    if s is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{s}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    by_name = {m["name"]: m for m in manifest["leaves"]}
    out = []
    for (path, leaf), spec in zip(leaves_with_path(state_shape),
                                  spec_leaves):
        name = _leaf_name(path)
        meta = by_name[name]
        t = _from_numpy(np.load(os.path.join(d, name + ".npy")),
                        meta["dtype"])
        if tuple(t.shape) != tuple(leaf.shape):
            raise ValueError(
                f"shape mismatch for {name}: ckpt {tuple(t.shape)} vs "
                f"expected {tuple(leaf.shape)}")
        if spec is not None:
            t = _distribute(t, mesh, spec)
        out.append(t)
    return unflatten(state_shape, out), manifest.get("extra", {})


def _distribute(t: torch.Tensor, mesh, spec) -> torch.Tensor:
    """The full leaf ``t`` (every rank holds it) as a DTensor laid out by
    ``spec``: each rank keeps its block, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.sharding.rules import placements
    return distribute_tensor(t, mesh, placements(spec, mesh),
                             src_data_rank=None)


class CheckpointManager:
    """Async writer with bounded retention.

    ``save`` copies the state to host memory synchronously, then writes
    on a background thread; ``wait`` joins (and raises what the writer
    raised).  Keeps the newest ``keep`` checkpoints.
    """

    def __init__(self, ckpt_dir: str, *, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, state: Any, step: int, extra: Optional[dict] = None,
             block: bool = False):
        self.wait()
        host_state, writer = _host_tree(state)
        if not writer:
            return

        def _write():
            try:
                save_checkpoint(self.ckpt_dir, host_state, step, extra)
                self._gc()
            except BaseException as e:     # surfaced on the next wait()
                self.last_error = e

        if block:
            _write()
        else:
            self._thread = threading.Thread(target=_write, daemon=True)
            self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err

    def _gc(self):
        steps = sorted(
            int(m.group(1)) for d in os.listdir(self.ckpt_dir)
            if (m := _STEP_RE.match(d)))
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s}"),
                          ignore_errors=True)
