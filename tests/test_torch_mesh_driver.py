"""The port's training driver and checkpoints on DTensor meshes
(``launch.train --data-axis / --model-axis``, ``restore_checkpoint(
shardings=)``, a DTensor state's save), on the CPU over gloo.

Bounds, fixed before measuring:

- ``launch.train --device cpu`` on qwen1.5-0.5b smoke at ``--data-axis
  2`` and at ``--model-axis 2``: every step's loss within 1e-5 relative
  of the single device's;
- the port's ``test_elastic_restore_across_meshes``: mamba2-130m smoke
  trains 6 steps on one device with checkpoints every 3; resumed on a
  (2, 2) mesh it prints ``restored step 6`` and its steps 6-7 are within
  1e-5 relative of the same checkpoint resumed on one device (the
  learning-rate schedule is ``--steps``', so that is the uninterrupted
  run's schedule); the mesh's checkpoint of step 8 restores on one device
  to the single device's step-8 state within 1e-5 relative (its leaves
  written once, by rank 0, as full arrays);
- ``restore_checkpoint(shardings=)`` on a (1,) mesh equal to the saved
  state (JAX's ``test_restore_with_shardings``), and on a (2,) mesh with
  a sharded spec each rank's block equal to its slice of the saved leaf;
  with no device mesh it raises;
- more ranks than GPUs without ``--shared-card`` raises, as does
  ``--shared-card`` on the CPU.
"""
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
from repro_torch.core._dist import spawn
from repro_torch.launch import train as ptrain
from repro_torch.models.tree import leaves, tree_map
from repro_torch.sharding import rules
from repro_torch.sharding.rules import AbstractMesh, Spec

ROOT = Path(__file__).resolve().parents[1]
RTOL = 1e-5


def _train(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               REPRO_EMIT_LOSSES="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                        "--device", "cpu", "--smoke", *args],
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-4000:]
    losses = [json.loads(ln[len("LOSSES "):]) for ln in r.stdout.splitlines()
              if ln.startswith("LOSSES ")]
    assert len(losses) == 1, r.stdout[-2000:]
    return r, np.array(losses[0])


QWEN = ["--arch", "qwen1.5-0.5b", "--steps", "4", "--batch", "4", "--seq",
        "32"]


@pytest.fixture(scope="module")
def qwen_one_device():
    return _train(QWEN)[1]


@pytest.mark.parametrize("axes", [["--data-axis", "2"], ["--model-axis", "2"]],
                         ids=["data2", "model2"])
def test_train_on_a_mesh_matches_one_device(qwen_one_device, axes):
    r, losses = _train(QWEN + axes)
    assert len(losses) == len(qwen_one_device)
    np.testing.assert_allclose(losses, qwen_one_device, rtol=RTOL, atol=0)
    # rank 0 alone logs
    assert r.stdout.count("[train] done") == 1


MAMBA = ["--arch", "mamba2-130m", "--batch", "4", "--seq", "32"]


def test_elastic_restore_across_meshes(tmp_path):
    one, mesh = str(tmp_path / "one"), str(tmp_path / "mesh")
    _train(MAMBA + ["--steps", "6", "--ckpt-dir", one, "--ckpt-every", "3"])
    shutil.copytree(one, mesh)
    r1, want = _train(MAMBA + ["--steps", "8", "--ckpt-dir", one,
                               "--ckpt-every", "4"])
    r2, got = _train(MAMBA + ["--steps", "8", "--ckpt-dir", mesh,
                              "--ckpt-every", "4", "--data-axis", "2",
                              "--model-axis", "2"])
    for r in (r1, r2):
        assert re.search(r"restored step 6\b", r.stdout), r.stdout[-1000:]
    assert r2.stdout.count("restored step") == 1
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    # the mesh's step-8 checkpoint: full arrays, restorable on one device
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.state import state_to_jax, train_state_shape
    cfg = make_smoke(get_config("mamba2-130m"))
    shape = state_to_jax(train_state_shape(cfg, OptConfig()), cfg)
    a, _ = restore_checkpoint(one, shape, step=8)
    b, _ = restore_checkpoint(mesh, shape, step=8)
    for x, y in zip(leaves(a), leaves(b)):
        assert x.shape == y.shape and x.dtype == y.dtype
        tol = RTOL * max(float(x.float().abs().max()), 1e-30)
        assert float((x.float() - y.float()).abs().max()) <= tol
    with open(os.path.join(mesh, "step_8", "manifest.json")) as f:
        names = [m["name"] for m in json.load(f)["leaves"]]
    assert len(names) == len(set(names)) == len(leaves(shape))


def _state():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(4, 6, generator=g),
                       "b": torch.randn(6, generator=g).bfloat16()},
            "step": torch.tensor(3, dtype=torch.int32)}


def _restore_rank(group, ckpt, sharded):
    from torch.distributed.device_mesh import init_device_mesh
    mesh = init_device_mesh("cpu", (group.size,), mesh_dim_names=("data",))
    st = _state()
    spec = {"params": {"w": Spec("data", None) if sharded else Spec(),
                       "b": Spec()}, "step": Spec()}
    with rules.set_mesh(mesh):
        got, extra = restore_checkpoint(ckpt, st, shardings=spec)
    out = {}
    for name, t, want in (("w", got["params"]["w"], st["params"]["w"]),
                          ("b", got["params"]["b"], st["params"]["b"]),
                          ("step", got["step"], st["step"])):
        rows = want.shape[0] // group.size if (sharded and name == "w") \
            else None
        exp = want[group.rank * rows:(group.rank + 1) * rows] if rows \
            else want
        out[name] = (str(t.placements), torch.equal(t.to_local(), exp),
                     torch.equal(t.full_tensor(), want))
    # the restored state saved again: gathered whole, written by rank 0
    save_checkpoint(ckpt, got, 4)
    return out


@pytest.mark.parametrize("ranks,sharded", [(1, False), (2, True)],
                         ids=["mesh1", "mesh2_sharded"])
def test_restore_with_shardings(tmp_path, ranks, sharded):
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, _state(), 3)
    res = spawn(_restore_rank, ranks, backend="gloo",
                store_dir=tmp_path / "store", args=(ckpt, sharded))
    for out in res:
        for name, (pl, local_ok, full_ok) in out.items():
            assert local_ok and full_ok, (name, pl)
        assert ("Shard(dim=0)" in out["w"][0]) == sharded
    back, _ = restore_checkpoint(ckpt, _state(), step=4)
    for x, y in zip(leaves(back), leaves(_state())):
        assert torch.equal(x, y)


def test_restore_with_shardings_needs_a_device_mesh(tmp_path):
    ckpt = str(tmp_path / "ck")
    save_checkpoint(ckpt, _state(), 3)
    spec = tree_map(lambda _: Spec(), _state())
    with pytest.raises(ValueError, match="device mesh"):
        restore_checkpoint(ckpt, _state(), shardings=spec)
    with rules.set_mesh(AbstractMesh((1, 1), ("data", "model"))):
        with pytest.raises(ValueError, match="device mesh"):
            restore_checkpoint(ckpt, _state(), shardings=spec)


def test_mesh_needs_a_gpu_a_rank_or_shared_card():
    if torch.cuda.device_count() >= 2:
        pytest.skip("this machine has two GPUs")
    with pytest.raises(RuntimeError, match="GPUs"):
        ptrain.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cuda",
                     "--data-axis", "2", "--steps", "1"])
    with pytest.raises(ValueError, match="shared-card"):
        ptrain.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                     "--model-axis", "2", "--shared-card", "--steps", "1"])
    with pytest.raises(ValueError, match="shared-card"):
        ptrain.main(["--arch", "qwen1.5-0.5b", "--smoke", "--device", "cpu",
                     "--shared-card", "--steps", "1"])
