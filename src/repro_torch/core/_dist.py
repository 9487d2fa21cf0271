"""Process groups for the sharded engines — the port's stand-in for the JAX
package's mesh axis (repro/core/_axes.py, repro/core/_compat.py).

In JAX one process drives P devices through ``shard_map`` and a mesh axis
names them.  With ``torch.distributed`` there are P processes, one rank
each, and every sharded engine runs on every rank with the same arguments
(SPMD, as MPI runs the paper's Alg. 2).  A :class:`ShardGroup` is one rank's
view of the group: its ``rank``, the group's ``size``, the ``device`` its
blocks live on, and the collectives the engines need — a tiled all-gather
of equal-sized blocks, all-reduce MIN / MAX / SUM and broadcast.  It counts
the collectives it issues (``collectives``), so a caller can report them per
solve.

The backend follows the device and is named by the caller: NCCL for CUDA
tensors, gloo for CPU tensors.  Any other pairing raises; nothing falls
back from one to the other.  Groups start from a file store in a directory
(no TCP port, so concurrent test workers cannot collide).  One H100 means
P = 1 on the card: NCCL refuses two ranks on one GPU.

    with open_group(0, 1, backend="nccl", device="cuda:0",
                    store_dir=tmp) as group:
        shortest_paths(cg, 0, engine="frontier_sharded", group=group)

    results = spawn(fn, 4, backend="gloo", store_dir=tmp, args=(cg,))

:func:`spawn` runs ``fn(group, *args)`` on P fresh processes and returns
their results by rank.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

#: the backend a device type takes
BACKEND_OF = {"cuda": "nccl", "cpu": "gloo"}
#: seconds a collective or a spawned group may take before it fails
DEFAULT_TIMEOUT = 120.0

_OPS = {"min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX,
        "sum": dist.ReduceOp.SUM}
# torch 2.13 renamed all_gather_into_tensor (the old name warns)
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


@dataclasses.dataclass
class ShardGroup:
    """One rank of a process group of ``size`` ranks, its blocks on
    ``device``.  Use :func:`open_group` (or :func:`spawn`) to make one, and
    close it (or leave its ``with`` block) when done."""

    rank: int
    size: int
    device: torch.device
    backend: str
    collectives: int = 0

    def all_gather(self, t: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """Tiled all-gather: every rank's equal-shaped block of ``t``,
        concatenated along ``dim`` in rank order."""
        self.collectives += 1
        blk = t.movedim(dim, 0).contiguous()
        out = torch.empty((self.size * blk.shape[0],) + tuple(blk.shape[1:]),
                          dtype=blk.dtype, device=blk.device)
        _all_gather(out, blk)
        return out.movedim(0, dim)

    def all_reduce(self, t: torch.Tensor, op: str) -> torch.Tensor:
        """``t`` reduced over the group in place (``op`` min, max or sum);
        returns ``t``."""
        self.collectives += 1
        dist.all_reduce(t, op=_OPS[op])
        return t

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` onto every rank, in place; returns ``t``."""
        self.collectives += 1
        dist.broadcast(t, src)
        return t

    def close(self, *, wait: bool = True) -> None:
        """Leave the group.  With ``wait`` (the default) first wait for
        every rank to get here, so no rank tears down its connections
        while another is still joining or working."""
        if not dist.is_initialized():
            return
        if wait:
            ids = [self.device.index] if self.device.type == "cuda" else None
            dist.barrier(device_ids=ids)
        dist.destroy_process_group()

    def __enter__(self) -> "ShardGroup":
        return self

    def __exit__(self, exc_type, *rest) -> None:
        # after a failure the other ranks may never reach the barrier
        self.close(wait=exc_type is None)


def check_backend(backend: str, device) -> torch.device:
    """``torch.device(device)``, refusing a backend that does not carry
    that device's tensors (gloo for CUDA, NCCL for the CPU)."""
    dev = torch.device(device)
    if BACKEND_OF.get(dev.type) != backend:
        raise ValueError(
            f"backend {backend!r} does not carry {dev.type} tensors; "
            f"a {dev.type} group uses {BACKEND_OF.get(dev.type)!r}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("an NCCL group needs a CUDA GPU and none is "
                               "available")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL backend")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def open_group(rank: int, size: int, *, backend: str, device, store_dir,
               timeout: float = DEFAULT_TIMEOUT) -> ShardGroup:
    """Join rank ``rank`` of a group of ``size`` through the file store in
    ``store_dir`` (every rank passes the same directory, which holds no
    store of an earlier group) and return its :class:`ShardGroup`.  Makes
    the process's default ``torch.distributed`` group, so a process holds
    one group at a time."""
    dev = check_backend(backend, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(os.fspath(store_dir), "store"), size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout))
    return ShardGroup(rank=rank, size=size, device=dev, backend=backend)


def _rank_main(fn, rank, size, backend, store_dir, args, results, timeout):
    """One spawned rank: join the group, run ``fn``, report its result or
    its traceback on ``results``."""
    try:
        if backend == "gloo":
            # P ranks share the host's cores: one intra-op thread each
            torch.set_num_threads(1)
        device = "cpu" if backend == "gloo" else f"cuda:{rank}"
        with open_group(rank, size, backend=backend, device=device,
                        store_dir=store_dir, timeout=timeout) as group:
            out = fn(group, *args)
        results.put((rank, True, out))
    except Exception:             # the boundary: report, the parent raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs: int, *, backend: str, store_dir, args=(),
          timeout: float = DEFAULT_TIMEOUT) -> list:
    """Run ``fn(group, *args)`` on ``nprocs`` fresh processes (the spawn
    start method), rank r on ``cuda:r`` for NCCL or on the CPU for gloo,
    and return the results by rank.  ``fn``, ``args`` and the results are
    pickled, so ``fn`` is a module-level function.  Raises
    ``RuntimeError`` with the traceback if a rank raises or exits without a
    result, or if the group is not done within ``timeout`` seconds; every
    rank is stopped before it returns or raises."""
    if backend == "nccl" and torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"an NCCL group of {nprocs} needs {nprocs} GPUs, "
                           f"{torch.cuda.device_count()} present")
    check_backend(backend, "cpu" if backend == "gloo" else "cuda:0")
    os.makedirs(store_dir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="group-", dir=store_dir)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, backend, run_dir, args, results,
                               timeout))
             for r in range(nprocs)]
    for p in procs:
        p.start()
    got, failed, deadline = {}, {}, time.monotonic() + timeout
    try:
        while len(got) + len(failed) < nprocs:
            try:
                rank, ok, out = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode
                        is not None and r not in got and r not in failed]
                if dead and not failed:
                    raise RuntimeError(f"rank {dead[0]} exited with code "
                                       f"{procs[dead[0]].exitcode} and no "
                                       f"result") from None
                if dead or time.monotonic() > deadline:
                    break
                continue
            if ok:
                got[rank] = out
            else:
                # a failure makes the other ranks fail soon after: give
                # them a moment, so the first cause is reported with them
                failed[rank] = out
                deadline = min(deadline, time.monotonic() + 5.0)
        if failed:
            raise RuntimeError("".join(f"rank {r} failed:\n{tb}"
                                       for r, tb in sorted(failed.items())))
        if len(got) < nprocs:
            raise RuntimeError(f"the group of {nprocs} did not finish within "
                               f"{timeout} s")
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(nprocs)]
