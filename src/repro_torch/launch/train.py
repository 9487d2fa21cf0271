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
``--seed``.  ``--ddp-compress`` is parsed and not read, as in JAX's
driver.

**On a mesh.**  ``--data-axis D --model-axis M`` with ``D * M > 1``
trains on a ``(data, model)`` ``DeviceMesh`` of ``D * M`` ranks started
by ``core._dist.spawn``: gloo ranks on ``--device cpu``; on CUDA, NCCL
with one GPU a rank, or with ``--shared-card`` gloo ranks that all use
one card.  Fewer GPUs than ranks without ``--shared-card`` raises;
nothing runs on fewer ranks or on the CPU instead.  As in JAX's driver
the state is replicated over the mesh (DTensors), every rank builds the
same batch from the seed and the models' ``constrain`` calls lay the
activations out; a restore reads the full leaves with replicated specs
(reshard-on-load), so a checkpoint from any mesh resumes on any other.
Rank 0 alone logs and writes checkpoints.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import signal
import sys
import time

#: seconds a mesh run may take before its group fails (its collectives
#: wait on checkpoint writes and restores too)
MESH_TIMEOUT = 3600.0


def main(argv=None, *, fork_cpu_ranks: bool = False):
    """Parse ``argv`` and train; returns the losses.  ``fork_cpu_ranks``
    forks a mesh's gloo CPU ranks instead of spawning them (for a process
    that has run no torch operation, as this module run as a program)."""
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
    ap.add_argument("--shared-card", action="store_true",
                    help="a mesh's ranks all use one CUDA card over gloo")
    args = ap.parse_args(argv)
    data = args.data_axis if args.data_axis is not None else 1
    if data < 1 or args.model_axis < 1:
        raise ValueError(f"mesh axes must be positive; got ({data}, "
                         f"{args.model_axis})")
    if data * args.model_axis > 1:
        return _spawn_mesh(args, data, fork_cpu_ranks)
    if args.shared_card:
        raise ValueError("--shared-card is for a mesh of more than one "
                         "rank")
    return _train(args, None)


def _spawn_mesh(args, data: int, fork_cpu_ranks: bool):
    """Train on a (data, model) mesh of spawned ranks; rank 0's losses."""
    import tempfile

    import torch

    from repro_torch.core._dist import check_gpus, spawn

    n = data * args.model_axis
    dev = torch.device(args.device)
    kw = {}
    if dev.type == "cpu":
        if args.shared_card:
            raise ValueError("--shared-card shares a CUDA card; the device "
                             "is the CPU")
        backend = "gloo"
        if fork_cpu_ranks:
            kw["start_method"] = "fork"
    elif args.shared_card:
        backend, kw["shared_device"] = "gloo", args.device
    else:
        backend = "nccl"
        check_gpus(n)           # one GPU a rank, or --shared-card
    with tempfile.TemporaryDirectory(prefix="train-mesh-") as store:
        return spawn(_mesh_rank, n, backend=backend, store_dir=store,
                     args=(args, data), timeout=MESH_TIMEOUT, **kw)[0]


def _mesh_rank(group, args, data: int):
    """One rank of a mesh run: the mesh over the group, then the loop."""
    from repro_torch.launch.mesh import make_host_mesh

    mesh = make_host_mesh(data, args.model_axis,
                          device_type=group.device.type)
    if group.device.type == "cuda":
        args.device = str(group.device)
    return _train(args, mesh, rank=group.rank)


def _train(args, mesh, rank: int = 0):
    """Init or restore, then the loop; ``mesh`` a ``DeviceMesh`` or None
    (one device)."""
    import torch

    from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                        restore_checkpoint)
    from repro_torch.configs import get_config, make_smoke
    from repro_torch.core.api import resolve_device
    from repro_torch.data.pipeline import DataConfig, SyntheticPipeline
    from repro_torch.models.tree import tree_map
    from repro_torch.sharding import rules
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
        if mesh is None:
            tree, extra = restore_checkpoint(args.ckpt_dir, shape)
        else:
            with rules.set_mesh(mesh):
                tree, extra = restore_checkpoint(
                    args.ckpt_dir, shape, shardings=tree_map(
                        lambda _: rules.replicated(mesh), shape))
        state = state_from_jax(tree, cfg, dev)
        start_step = int(extra.get("step", int(_value(state.step))))
        if rank == 0:
            print(f"[train] restored step {start_step} from "
                  f"{args.ckpt_dir}", flush=True)
    else:
        state = init_train_state(
            cfg, opt_cfg, torch.Generator(dev).manual_seed(args.seed), dev)
        if mesh is not None:
            state = tree_map(lambda t: _replicate(t, mesh), state)

    step_fn = make_train_step(cfg, opt_cfg, grad_accum=args.grad_accum)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    # ---- SIGTERM preemption hook --------------------------------------
    preempted = {"flag": False}

    def _on_sigterm(signum, frame):
        preempted["flag"] = True
    prev_handler = signal.signal(signal.SIGTERM, _on_sigterm)
    try:
        if mesh is None:
            return _loop(args, cfg, state, start_step, pipe, step_fn, ckpt,
                         preempted, dev)
        with rules.set_mesh(mesh):
            return _loop(args, cfg, state, start_step, pipe, step_fn, ckpt,
                         preempted, dev, mesh, rank)
    finally:
        signal.signal(signal.SIGTERM, prev_handler)


def _replicate(t, mesh):
    """``t`` (the same on every rank) as a DTensor replicated on
    ``mesh``."""
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _value(t):
    """A (replicated) scalar's value on this rank."""
    from repro_torch.sharding.rules import is_dtensor
    return (t.full_tensor() if is_dtensor(t) else t).item()


def _loop(args, cfg, state, start_step, pipe, step_fn, ckpt, preempted,
          dev, mesh=None, rank=0):
    """The driver's step loop (see the module); returns the losses.  On a
    mesh every rank runs it; rank 0 alone prints, and the checkpoint
    manager writes from rank 0."""
    import torch

    from repro_torch.train.state import state_to_jax

    log = print if rank == 0 else (lambda *a, **k: None)
    stats = _StepStats(os.environ.get("REPRO_STEP_STATS"), dev, mesh)

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
        if mesh is not None:
            batch = {k: _replicate(v, mesh) for k, v in batch.items()}
        t0 = time.time()
        with stats.step(step_idx == args.steps - 1):
            state, metrics = step_fn(state, batch)
            loss = _value(metrics["loss"])
        dt = time.time() - t0
        ewma = dt if ewma is None else 0.9 * ewma + 0.1 * dt
        if dt > args.straggler_factor * ewma and step_idx > start_step + 3:
            log(f"[watchdog] straggler step {step_idx}: "
                f"{dt:.3f}s vs ewma {ewma:.3f}s", flush=True)
        losses.append(loss)
        if step_idx % args.log_every == 0:
            log(f"[train] step {step_idx} loss {loss:.4f} "
                f"({dt*1e3:.0f} ms)", flush=True)
        if ckpt and (step_idx + 1) % args.ckpt_every == 0:
            save(step_idx + 1)
        if preempted["flag"]:
            log("[train] SIGTERM: checkpointing and exiting", flush=True)
            if ckpt:
                save(step_idx + 1, block=True)
            sys.exit(143)

    if ckpt:
        if start_step < args.steps and args.steps % args.ckpt_every == 0:
            ckpt.wait()         # the loop's last save was this step's
        else:
            save(args.steps, block=True)
    log(f"[train] done: final loss {losses[-1]:.4f} "
        f"(first {losses[0]:.4f})", flush=True)
    if os.environ.get("REPRO_EMIT_LOSSES"):
        log("LOSSES " + json.dumps(losses), flush=True)
    if stats.on:
        log("STEPSTATS " + json.dumps(stats.summary()), flush=True)
    return losses


class _StepStats:
    """``REPRO_STEP_STATS=1``: each step's device time (CUDA events on a
    card, the host clock elsewhere), the collectives of the last step by
    kind (``CommDebugMode``, on a mesh) and every rank's peak memory;
    rank 0 prints them as one ``STEPSTATS`` JSON line.  Off, it times
    nothing and adds no synchronization."""

    def __init__(self, on, dev, mesh):
        self.on, self.dev, self.mesh = bool(on), dev, mesh
        self.ms: list = []
        self.comm: dict = {}

    def step(self, count_comm: bool):
        if not self.on:
            return contextlib.nullcontext()
        return self._step(count_comm)

    @contextlib.contextmanager
    def _step(self, count_comm: bool):
        import torch
        from torch.distributed.tensor.debug import CommDebugMode

        cuda = self.dev.type == "cuda"
        if cuda:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        t0 = time.perf_counter()
        mode = CommDebugMode() if count_comm and self.mesh else None
        if mode is not None:
            with mode:
                yield
            self.comm = {str(k).rsplit(".", 1)[-1]: int(v) for k, v in
                         mode.get_comm_counts().items()}
        else:
            yield
        if cuda:
            ev[1].record()
            ev[1].synchronize()
            self.ms.append(ev[0].elapsed_time(ev[1]))
        else:
            self.ms.append((time.perf_counter() - t0) * 1e3)

    def summary(self) -> dict:
        import torch
        import torch.distributed as dist

        peak = (torch.cuda.max_memory_allocated(self.dev)
                if self.dev.type == "cuda" else None)
        peaks = [peak]
        if self.mesh is not None:
            peaks = [None] * dist.get_world_size()
            dist.all_gather_object(peaks, peak)
        return {"step_ms": self.ms, "timer": ("cuda_events" if
                                              self.dev.type == "cuda"
                                              else "host"),
                "collectives_last_step": self.comm,
                "peak_bytes_by_rank": peaks}


if __name__ == "__main__":
    main(fork_cpu_ranks=True)
