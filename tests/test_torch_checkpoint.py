"""The port's checkpoints (repro_torch.checkpoint) against the JAX
package's on-disk format, on the CPU.

- JAX's ``test_checkpoint.py`` cases on the port: roundtrip (bf16
  included), latest step and retention, the async manager, ``tmp.``
  directories never visible, a shape mismatch raises;
  ``test_restore_with_shardings`` needs a device mesh (it is
  ``tests/test_torch_mesh_driver.py``'s) and raises without one;
- a JAX ``save_checkpoint`` of a TrainState after 2 steps restores into
  the port bitwise, leaf by leaf, and the port's next step is within 1e-3
  relative of JAX's (the step bound of ``test_torch_train.py``);
- a port checkpoint restores into JAX's ``restore_checkpoint(
  train_state_shape(...))`` bitwise;
- the file names and the manifest of the same state are equal.
zamba2's smoke config (Mamba2 layers, the shared block) and qwen2-moe's
(experts) carry every kind of leaf a state has.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config, make_smoke
from repro.train.optimizer import OptConfig as JOpt
from repro.train.state import init_train_state as jax_init_state
from repro.train.state import train_state_shape as jax_state_shape
from repro.train.step import make_train_step as jax_train_step
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.models.tree import leaves, tree_map
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.state import (state_from_jax, state_to_jax,
                                     train_state_shape)
from repro_torch.train.step import make_train_step

KEY = jax.random.PRNGKey(0)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=100)
STEP_RTOL = 1e-3
ARCHS = ("zamba2-2.7b", "qwen2-moe-a2.7b")


def _state():
    return {
        "params": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
                   "b": torch.ones(4, dtype=torch.bfloat16) * 1.5},
        "opt": {"mu": torch.zeros(3, 4),
                "count": torch.tensor(7, dtype=torch.int32)},
    }


def _shape():
    return jax.tree.map(lambda t: t.to("meta"), _state())


def test_roundtrip(tmp_path):
    st = _state()
    save_checkpoint(str(tmp_path), st, 5)
    got, extra = restore_checkpoint(str(tmp_path), _shape())
    assert extra == {}
    for a, b in zip(leaves(st), leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_latest_step_and_gc(tmp_path):
    st = _state()
    for s in (1, 2, 3, 4):
        save_checkpoint(str(tmp_path), st, s)
    assert latest_step(str(tmp_path)) == 4
    mgr = CheckpointManager(str(tmp_path), keep=2)
    mgr.save(st, 5, block=True)
    steps = sorted(d for d in os.listdir(tmp_path) if d.startswith("step_"))
    assert steps == ["step_4", "step_5"]


def test_async_manager_waits(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    st = _state()
    mgr.save(st, 1)
    st["params"]["w"].add_(1.0)       # the host copy was taken at save()
    mgr.wait()
    assert latest_step(str(tmp_path)) == 1
    got, _ = restore_checkpoint(str(tmp_path), _shape())
    assert torch.equal(got["params"]["w"], _state()["params"]["w"])


def test_tmp_dirs_never_visible(tmp_path):
    os.makedirs(tmp_path / "tmp.step_9")
    save_checkpoint(str(tmp_path), _state(), 2)
    assert latest_step(str(tmp_path)) == 2
    restore_checkpoint(str(tmp_path), _shape())
    assert latest_step(str(tmp_path / "none")) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), _shape())


def test_shape_mismatch_raises(tmp_path):
    save_checkpoint(str(tmp_path), _state(), 1)
    bad = _shape()
    bad["params"]["w"] = torch.empty((5, 4), device="meta")
    with pytest.raises(ValueError, match="shape mismatch"):
        restore_checkpoint(str(tmp_path), bad)


def test_restore_with_shardings_is_the_mesh_side(tmp_path):
    """``shardings=`` lays leaves out on a device mesh (the mesh side,
    tests/test_torch_mesh_driver.py); with none it raises, and never
    returns plain tensors instead."""
    save_checkpoint(str(tmp_path), _state(), 3)
    with pytest.raises(ValueError, match="device mesh"):
        restore_checkpoint(str(tmp_path), _shape(), shardings=_shape())


def test_the_plain_state_is_jax_file_for_file(tmp_path):
    """The same plain state saved by JAX and by the port: equal names,
    equal manifests, equal arrays; each restores the other's."""
    st = _state()
    jst = jax.tree.map(lambda t: jnp.asarray(t.float().numpy()).astype(
        str(t.dtype).removeprefix("torch.")), st)
    jax_save(str(tmp_path / "j"), jst, 3, {"step": 3})
    save_checkpoint(str(tmp_path / "p"), st, 3, {"step": 3})
    _same_files(tmp_path / "j" / "step_3", tmp_path / "p" / "step_3")
    got, _ = restore_checkpoint(str(tmp_path / "j"), _shape())
    for a, b in zip(leaves(st), leaves(got)):
        assert torch.equal(a, b)
    back, _ = jax_restore(str(tmp_path / "p"), jax.eval_shape(lambda: jst))
    for a, b in zip(jax.tree.leaves(jst), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a),
                                                     np.asarray(b))


def _same_files(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    with open(a / "manifest.json") as f, open(b / "manifest.json") as g:
        assert json.load(f) == json.load(g)
    for n in names:
        if n.endswith(".npy"):
            x, y = np.load(a / n), np.load(b / n)
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), n


@functools.lru_cache(maxsize=None)
def _jax_two_steps(cfg):
    st = jax_init_state(KEY, cfg, JOpt(**OPT))
    step = jax.jit(jax_train_step(cfg, JOpt(**OPT)))
    rng = np.random.default_rng(0)
    batches = [{k: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
                for k in ("tokens", "labels")} for _ in range(3)]
    for b in batches[:2]:
        st, _ = step(st, {k: jnp.asarray(v) for k, v in b.items()})
    st3, m = step(st, {k: jnp.asarray(v) for k, v in batches[2].items()})
    return st, batches[2], float(m["loss"])


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_into_the_port(arch, tmp_path):
    cfg = make_smoke(get_config(arch))
    st, batch, want_loss = _jax_two_steps(cfg)
    jax_save(str(tmp_path), st, 2, {"step": 2})
    opt = OptConfig(**OPT)
    shape = state_to_jax(train_state_shape(cfg, opt), cfg)
    tree, extra = restore_checkpoint(str(tmp_path), shape)
    assert extra == {"step": 2}
    state = state_from_jax(tree, cfg, "cpu")
    assert int(state.step) == 2 and int(state.opt_state["count"]) == 2
    want = jax.tree_util.tree_leaves_with_path(st)
    got = leaves(state_to_jax(state, cfg))
    assert len(want) == len(got)
    for (path, w), g in zip(want, got):
        w = np.asarray(w)
        assert str(w.dtype) == str(g.dtype).removeprefix("torch.")
        assert w.tobytes() == g.numpy().tobytes(), jax.tree_util.keystr(path)
    _, m = make_train_step(cfg, opt)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(m["loss"]) - want_loss) <= STEP_RTOL * abs(want_loss)


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_into_jax(arch, tmp_path):
    cfg = make_smoke(get_config(arch))
    st, _, _ = _jax_two_steps(cfg)
    jax_save(str(tmp_path / "j"), st, 2, {"step": 2})
    tree, _ = restore_checkpoint(
        str(tmp_path / "j"),
        state_to_jax(train_state_shape(cfg, OptConfig(**OPT)), cfg))
    state = state_from_jax(tree, cfg, "cpu")
    mgr = CheckpointManager(str(tmp_path / "p"))
    mgr.save(state_to_jax(state, cfg), 2, {"step": 2})
    mgr.wait()
    _same_files(tmp_path / "j" / "step_2", tmp_path / "p" / "step_2")
    back, extra = jax_restore(str(tmp_path / "p"),
                              jax_state_shape(cfg, JOpt(**OPT)))
    assert extra == {"step": 2}
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(st),
                            jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes(), \
            jax.tree_util.keystr(path)


def test_bf16_state_crosses_both_ways(tmp_path):
    """A bf16 state (uint16 views on disk) JAX -> port -> JAX bitwise."""
    cfg = make_smoke(get_config("zamba2-2.7b"))
    st = jax_init_state(KEY, cfg, JOpt(**OPT))
    st = jax.tree.map(lambda a: a.astype(jnp.bfloat16)
                      if a.dtype == jnp.float32 else a, st)
    jax_save(str(tmp_path / "j"), st, 0)
    shape = tree_map(lambda t: t.to(torch.bfloat16)
                     if t.dtype == torch.float32 else t,
                     state_to_jax(train_state_shape(cfg, OptConfig(**OPT)),
                                  cfg))
    tree, _ = restore_checkpoint(str(tmp_path / "j"), shape)
    assert {t.dtype for t in leaves(tree.params)} == {torch.bfloat16}
    save_checkpoint(str(tmp_path / "p"), tree, 0)
    _same_files(tmp_path / "j" / "step_0", tmp_path / "p" / "step_0")
    back, _ = jax_restore(str(tmp_path / "p"), jax.eval_shape(lambda: st))
    for a, b in zip(jax.tree.leaves(st), jax.tree.leaves(back)):
        assert a.dtype == b.dtype
        assert np.asarray(a).tobytes() == np.asarray(b).tobytes()
