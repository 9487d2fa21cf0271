"""End-to-end driver: train an LM for a few hundred steps with
checkpointing, then resume once from the checkpoint (port of
``examples/train_lm.py``, plus ``--device``).

    PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200] \
        [--tiny] [--device cuda|cpu]

The model is ~100M parameters (``--tiny``: ~8M, a fast CPU-scale run),
f32, random init from a seeded ``torch.Generator``.  The first half of
the steps is checkpointed in JAX's format, restored into a fresh state,
and the second half continues from it.
"""
import argparse
import shutil
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
from repro_torch.configs.base import ModelConfig
from repro_torch.core.api import resolve_device
from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.state import (init_train_state, state_from_jax,
                                     state_to_jax, train_state_shape)
from repro_torch.train.step import make_train_step


def config_100m(tiny: bool) -> ModelConfig:
    if tiny:
        return ModelConfig(
            name="demo-8m", family="dense", d_model=128, num_heads=4,
            num_kv_heads=2, head_dim=32, d_ff=512, vocab_size=2048,
            segments=(("G", 4),), param_dtype="float32", loss_chunk=0,
            remat="none")
    # ~100M params: 12L, d=640, vocab 32k
    return ModelConfig(
        name="demo-100m", family="dense", d_model=640, num_heads=10,
        num_kv_heads=5, head_dim=64, d_ff=1792, vocab_size=32_768,
        segments=(("G", 12),), param_dtype="float32", loss_chunk=0,
        remat="none")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--tiny", action="store_true",
                    help="8M params (fast CPU-scale run)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config_100m(args.tiny)
    print(f"model {cfg.name}: {cfg.param_count()/1e6:.1f}M params")
    opt = OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    pipe = SyntheticPipeline(DataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))
    batch_at = lambda i: {k: torch.from_numpy(v).to(dev)
                          for k, v in pipe.batch_at(i).items()}

    ckdir = tempfile.mkdtemp(prefix="train_lm_ck_")
    losses = []
    try:
        state = init_train_state(cfg, opt, torch.Generator(dev).manual_seed(0),
                                 dev)
        step_fn = make_train_step(cfg, opt)
        mgr = CheckpointManager(ckdir)
        half = args.steps // 2
        for i in range(half):
            state, m = step_fn(state, batch_at(i))
            losses.append(float(m["loss"]))
            if i % 20 == 0:
                print(f"step {i:4d} loss {losses[-1]:.4f} "
                      f"lr {float(m['lr']):.2e}")
        mgr.save(state_to_jax(state, cfg), half, block=True)
        print(f"--- checkpointed at step {half}; simulating restart ---")

        shape = state_to_jax(train_state_shape(cfg, opt), cfg)
        tree, _ = restore_checkpoint(ckdir, shape)
        state2 = state_from_jax(tree, cfg, dev)
        for i in range(half, args.steps):
            state2, m = step_fn(state2, batch_at(i))
            losses.append(float(m["loss"]))
            if i % 20 == 0:
                print(f"step {i:4d} loss {losses[-1]:.4f}")
        print(f"final loss {losses[-1]:.4f}")
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    return losses


if __name__ == "__main__":
    main()
