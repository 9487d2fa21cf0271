"""Fault-tolerant training driver (port of ``repro/launch/train.py``, with
the same flags plus ``--device``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \
        --smoke --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 10 [--device cpu]

What it does, as JAX's driver does:
  * checkpoint/restart: atomic async checkpoints in JAX's on-disk format;
    on start the driver resumes from the newest checkpoint and replays the
    data pipeline from the restored step (a batch is a function of its
    step);
  * failure injection: ``--simulate-failure-at N`` raises at step N (after
    draining the in-flight checkpoint write); rerun the same command and
    training continues from the last checkpoint;
  * preemption: SIGTERM triggers a final synchronous checkpoint, then
    exit 143;
  * straggler watchdog: a step slower than ``--straggler-factor`` x the
    EWMA of step walls is logged with its index;
  * ``REPRO_EMIT_LOSSES=1`` prints every step's loss as one JSON line.

``main`` returns the losses and restores the SIGTERM handler it replaced.

Parameters are drawn on the device from a ``torch.Generator`` seeded with
``--seed``.  One device: ``--data-axis`` / ``--model-axis`` other than
None / 1 need the mesh side of the port (ROADMAP A.13c).  ``--ddp-compress``
is parsed and not read, as in JAX's driver.
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--data-axis", type=int, default=None)
    ap.add_argument("--model-axis", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--simulate-failure-at", type=int, default=None)
    ap.add_argument("--straggler-factor", type=float, default=3.0)
    ap.add_argument("--ddp-compress", action="store_true",
                    help="parsed for JAX's flag set; not read (as in "
                         "JAX's driver)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs on the host")
    args = ap.parse_args(argv)
    if args.data_axis not in (None, 1) or args.model_axis != 1:
        raise NotImplementedError(
            "--data-axis / --model-axis beyond one device come with the "
            "mesh side of the port (ROADMAP A.13c)")

    import torch

    from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                        restore_checkpoint)
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.api import resolve_device
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.state import (init_train_state, state_from_jax,
                                         state_to_jax, train_state_shape)
    from repro_torch.train.step import make_train_step

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = make_smoke(cfg)
    opt_cfg = OptConfig(lr=args.lr, warmup_steps=min(20, args.steps // 5 + 1),
                        total_steps=args.steps)

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, seed=args.seed,
                    image_tokens=cfg.num_image_tokens,
                    frame_len=(args.seq // cfg.audio_downsample
                               if cfg.encoder_segments else 0),
                    d_model=cfg.d_model)
    pipe = SyntheticPipeline(dc)

    # ---- init or restore -------------------------------------------------
    start_step = 0
    if args.ckpt_dir and latest_step(args.ckpt_dir) is not None:
        shape = state_to_jax(train_state_shape(cfg, opt_cfg), cfg)
        tree, extra = restore_checkpoint(args.ckpt_dir, shape)
        state = state_from_jax(tree, cfg, dev)
        start_step = int(extra.get("step", int(state.step)))
        print(f"[train] restored step {start_step} from {args.ckpt_dir}",
              flush=True)
    else:
        state = init_train_state(
            cfg, opt_cfg, torch.Generator(dev).manual_seed(args.seed), dev)

    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    # ---- SIGTERM preemption hook --------------------------------------
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True
    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        return _loop(args, cfg, state, start_step, pipe, step_fn, ckpt,
                     preempted, dev)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


def _loop(args, cfg, state, start_step, pipe, step_fn, ckpt, preempted,
          dev):
    """The driver's step loop (see the module); returns the losses."""
    import torch

    from repro_torch.train.state import state_to_jax

    def save(step, block=False):
        ckpt.save(state_to_jax(state, cfg), step, {"step": step},
                  block=block)

    # ---- loop -----------------------------------------------------------
    ewma = None
    losses = []
    for step_idx in range(start_step, args.steps):
        if (args.simulate_failure_at is not None
                and step_idx == args.simulate_failure_at):
            # nothing new is saved: the point is recovering from the last
            # periodic checkpoint; the in-flight write is drained first,
            # so whether it landed does not race the step time
            if ckpt:
                ckpt.wait()
            raise RuntimeError(
                f"[train] simulated node failure at step {step_idx}")
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in pipe.batch_at(step_idx).items()}
        t0 = time.time()
        state, metrics = step_fn(state, batch)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma and step_idx > start_step + 3:
            print(f"[watchdog] straggler step {step_idx}: "
                  f"{dt:.3f}s vs ewma {ewma:.3f}s", flush=True)
        losses.append(loss)
        if step_idx % args.log_every == 0:
            print(f"[train] step {step_idx} loss {loss:.4f} "
                  f"({dt*1e3:.0f} ms)", flush=True)
        if ckpt and (step_idx + 1) % args.ckpt_every == 0:
            save(step_idx + 1)
        if preempted["flag"]:
            print("[train] SIGTERM: checkpointing and exiting", flush=True)
            if ckpt:
                save(step_idx + 1, block=True)
            sys.exit(143)

    if ckpt:
        save(args.steps, block=True)
    print(f"[train] done: final loss {losses[-1]:.4f} "
          f"(first {losses[0]:.4f})", flush=True)
    if os.environ.get("REPRO_EMIT_LOSSES"):
        print("LOSSES " + json.dumps(losses), flush=True)
    return losses


if __name__ == "__main__":
    main()
