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

:func:`spawn` runs ``fn(group, *args)`` on P new processes (spawned, or
forked for gloo ranks of a process that has run no torch operation) and
returns their results by rank.

**The serving group** (:func:`open_serving_group`) serves a graph at or
above the dispatch policy's shard threshold from the vertex-partitioned
engines, which JAX drives from one process over a P-device mesh.  Here it
is P processes: rank 0, the *leader*, runs in the caller's process (the
registry, the scheduler and the cache stay there) and ranks 1..P-1, the
*followers*, are spawned once when the group opens (spawned, not forked:
the leader has run torch operations).  A follower loops on commands: an
int64 header of ``HEADER`` words (opcode, graph slot, arity P, engine, S,
sweep cap, two operands) sent by the leader down one pipe a follower,
then the command's payload by broadcast on the group (the CSR arrays of a
graph being staged, the sources of a batch).  The header travels by pipe
because a collective has the group's timeout and a follower may wait for
its next command far longer; the pipe also ends when the leader does.
Then every rank acts alike (``STAGE`` a block with ``partition_operands``
of ``CsrGraph.partitioned(P)``, byte-identical to JAX's; ``SOLVE_BATCH`` /
``SOLVE_P2P`` one sharded engine; ``DROP`` a block; ``STATS`` each rank's
staged bytes and kernel launches; ``STOP``).  The engines return
replicated rows, so the leader holds the answer when its own call
returns.

The leader checks a command (slot, sources, engine, cap) before it sends
it, so a refusal never leaves followers inside a collective.  A follower
that raises reports its traceback and exits; the leader's pending
collective then fails, and the group is marked broken: this and every
later command raise :class:`~repro_torch.serve.errors.GroupBroken` naming
the rank, at once.  ``close()`` sends ``STOP``, joins the followers and
destroys the leader's process group, so the process can open another.

    with open_serving_group(4, device="cpu") as sg:
        slot, ops, rank_bytes = sg.stage(cg.partitioned(4), cg)
        D, sweeps, edges, converged = sg.solve_batch(slot, [0, 7])

One card can carry P ranks only over gloo (NCCL refuses two ranks on one
GPU): ``shared=True`` with a CUDA device puts every rank on that card
over gloo, which moves their CUDA tensors.  Only a caller who asks for it
by name gets this pairing.
"""
from __future__ import annotations

import dataclasses
import datetime
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback

import numpy as np
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
            ids = [self.device.index] if self.backend == "nccl" else None
            dist.barrier(device_ids=ids)
        dist.destroy_process_group()

    def __enter__(self) -> "ShardGroup":
        return self

    def __exit__(self, exc_type, *rest) -> None:
        # after a failure the other ranks may never reach the barrier
        self.close(wait=exc_type is None)


_GATHER_SHIM: list = []


def _group_of(group):
    """The ProcessGroup a functional collective's ``group`` argument
    names, or None for a form this does not read."""
    from torch.distributed import distributed_c10d as c10d
    from torch.distributed.device_mesh import DeviceMesh
    if isinstance(group, dist.ProcessGroup):
        return group
    if (isinstance(group, tuple) and len(group) == 2
            and isinstance(group[0], DeviceMesh)):
        return group[0].get_group(group[1])
    if isinstance(group, DeviceMesh) and group.ndim == 1:
        return group.get_group()
    if isinstance(group, str):
        return c10d._resolve_process_group(group)
    return None


def _gathers_direct(t: torch.Tensor) -> bool:
    """Whether the gather shim takes ``t`` (a CUDA tensor)."""
    return t.is_cuda


def install_gloo_cuda_gather() -> None:
    """Route the functional all-gather of a CUDA tensor on a gloo group
    through ``dist.all_gather_into_tensor``.  DTensor's Shard -> Replicate
    issues ``_c10d_functional.all_gather_into_tensor``, which crashes
    (SIGSEGV in its wait) on CUDA tensors under gloo in torch 2.11, while
    the direct collective carries them (``tools/gloo_cuda_probe.py``).
    Other tensors and backends keep torch's own path.  Once a process;
    :func:`repro_torch.launch.mesh.make_host_mesh` installs it for a
    CUDA mesh over gloo."""
    if _GATHER_SHIM:
        return
    import torch.distributed._functional_collectives as funcol

    def shim(orig):
        def gather(self, gather_dim, group, tag=""):
            pg = _group_of(group) if _gathers_direct(self) else None
            if pg is None or dist.get_backend(pg) != "gloo":
                return orig(self, gather_dim, group, tag)
            n = pg.size()
            x = self.contiguous()
            out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            _all_gather(out, x, group=pg)
            if gather_dim != 0:
                out = torch.cat(torch.chunk(out, n, dim=0), dim=gather_dim)
            return out
        return gather

    # DTensor gathers through all_gather_tensor in torch 2.11 and through
    # all_gather_single, its new name, in 2.13 (which 2.11 lacks)
    for name in ("all_gather_tensor", "all_gather_single"):
        if hasattr(funcol, name):
            setattr(funcol, name, shim(getattr(funcol, name)))
    _GATHER_SHIM.append(True)


def check_backend(backend: str, device, *,
                  shared: bool = False) -> torch.device:
    """``torch.device(device)``, refusing a backend that does not carry
    that device's tensors (gloo for CUDA, NCCL for the CPU).  ``shared``
    asks for the one other pairing: gloo ranks that all use one CUDA card
    (``device``, named by index; "cuda" names the current one)."""
    dev = torch.device(device)
    if shared:
        if backend != "gloo" or dev.type != "cuda":
            raise ValueError(f"ranks sharing a card run gloo on a CUDA "
                             f"device; got {backend!r} on {dev}")
        if not torch.cuda.is_available():
            raise RuntimeError("ranks sharing a card need a CUDA GPU and "
                               "none is available")
        if dev.index is None:         # every rank must name the same card
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
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


def check_gpus(nprocs: int) -> None:
    """Raise ``RuntimeError`` unless there is a GPU for each of ``nprocs``
    NCCL ranks (one GPU a rank; nothing moves to the CPU instead)."""
    if torch.cuda.device_count() < nprocs:
        raise RuntimeError(f"an NCCL group of {nprocs} needs {nprocs} GPUs, "
                           f"{torch.cuda.device_count()} present")


def open_group(rank: int, size: int, *, backend: str, device, store_dir,
               timeout: float = DEFAULT_TIMEOUT,
               shared: bool = False) -> ShardGroup:
    """Join rank ``rank`` of a group of ``size`` through the file store in
    ``store_dir`` (every rank passes the same directory, which holds no
    store of an earlier group) and return its :class:`ShardGroup`.  Makes
    the process's default ``torch.distributed`` group, so a process holds
    one group at a time.  ``shared``: see :func:`check_backend`."""
    dev = check_backend(backend, device, shared=shared)
    if dist.is_initialized():
        raise RuntimeError("this process already holds a process group; "
                           "close it first")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    store = dist.FileStore(os.path.join(os.fspath(store_dir), "store"), size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=timeout))
    return ShardGroup(rank=rank, size=size, device=dev, backend=backend)


def _rank_main(fn, rank, size, backend, store_dir, args, results, timeout,
               device=None, shared=False):
    """One spawned rank: join the group, run ``fn``, report its result or
    its traceback on ``results``."""
    try:
        if backend == "gloo":
            # P ranks share the host's cores: one intra-op thread each
            torch.set_num_threads(1)
        if device is None:
            device = "cpu" if backend == "gloo" else f"cuda:{rank}"
        with open_group(rank, size, backend=backend, device=device,
                        store_dir=store_dir, timeout=timeout,
                        shared=shared) as group:
            out = fn(group, *args)
        results.put((rank, True, out))
    except Exception:             # the boundary: report, the parent raises
        results.put((rank, False, traceback.format_exc()))


def spawn(fn, nprocs: int, *, backend: str, store_dir, args=(),
          timeout: float = DEFAULT_TIMEOUT,
          start_method: str = "spawn", shared_device=None) -> list:
    """Run ``fn(group, *args)`` on ``nprocs`` new processes, rank r on
    ``cuda:r`` for NCCL or on the CPU for gloo (or, with
    ``shared_device``, gloo ranks all on that one CUDA card: see
    :func:`check_backend`), and return the results by rank.  ``fn``,
    ``args`` (when spawned) and the results are pickled, so ``fn`` is a
    module-level function.  ``start_method`` "fork" skips
    each rank's import of torch; it is for gloo ranks of a process that
    has run no torch operation yet (a forked child inherits the parent's
    thread pools half-made), and NCCL ranks always spawn.  Raises
    ``RuntimeError`` with the traceback if a rank raises or exits without a
    result, or if the group is not done within ``timeout`` seconds; every
    rank is stopped before it returns or raises."""
    if start_method not in ("spawn", "fork") or (
            backend == "nccl" and start_method != "spawn"):
        raise ValueError(f"start method {start_method!r} for {backend} "
                         f"ranks; NCCL ranks spawn, gloo ranks spawn or fork")
    if backend == "nccl":
        check_gpus(nprocs)
    if shared_device is not None:
        if start_method != "spawn":
            raise ValueError("ranks on a CUDA card spawn; they cannot fork")
        shared_device = str(check_backend(backend, shared_device,
                                          shared=True))
    else:
        check_backend(backend, "cpu" if backend == "gloo" else "cuda:0")
    os.makedirs(store_dir, exist_ok=True)
    run_dir = tempfile.mkdtemp(prefix="group-", dir=store_dir)
    ctx = mp.get_context(start_method)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, nprocs, backend, run_dir, args, results,
                               timeout, shared_device,
                               shared_device is not None))
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


# -- the serving group: a leader rank here, P - 1 spawned followers --------

#: opcodes of a serving group's commands
STAGE, SOLVE_BATCH, SOLVE_P2P, DROP, STATS, STOP = range(6)
#: int64 words of a command header: opcode, graph slot, arity P, engine
#: (an index into SERVE_ENGINES), S (sources of a batch), sweep cap (-1:
#: none), and two operands (STAGE: n and nnz; SOLVE_P2P: the source)
HEADER = 8
#: the engine of each solve command: SOLVE_P2P, SOLVE_BATCH
SERVE_ENGINES = ("frontier_sharded", "multisource_csr_sharded")


def _wire(group: ShardGroup) -> torch.device:
    """Where command payloads travel: the host for gloo (which carries CPU
    tensors whatever the ranks' device), the ranks' card for NCCL."""
    return torch.device("cpu") if group.backend == "gloo" else group.device


def _staged_bytes(ops: dict) -> int:
    """Bytes of the distinct tensors of one staged block."""
    return sum(size for _, size in {(t.data_ptr(), t.nbytes)
                                    for t in ops.values()})


def _act(group: ShardGroup, blocks: dict, hdr, *, parts=None, payload=None):
    """Carry out one command on this rank.  ``blocks`` maps a slot to its
    (partition, staged block).  The leader passes the partition it
    already holds and the payload it sends; a follower receives both."""
    from repro_torch.core.csr import CsrGraph
    from repro_torch.core.sharded_csr import (partition_operands,
                                              sssp_frontier_sharded,
                                              sssp_multisource_csr_sharded)

    op, slot, nprocs, engine, S, cap, a, b = (int(x) for x in hdr)
    cap = None if cap < 0 else cap
    wire = _wire(group)
    if op == STAGE:
        arrays = payload or (torch.empty(a + 1, dtype=torch.int64,
                                         device=wire),
                             torch.empty(b, dtype=torch.int32, device=wire),
                             torch.empty(b, dtype=torch.float32,
                                         device=wire))
        for t in arrays:
            group.broadcast(t)
        if parts is None:
            indptr, indices, weights = (t.cpu().numpy() for t in arrays)
            parts = CsrGraph(indptr=indptr, indices=indices, weights=weights,
                             n=a).partitioned(nprocs)
        ops = partition_operands(parts, group.rank, device=group.device)
        blocks[slot] = (parts, ops)
        sizes = group.all_gather(torch.tensor([_staged_bytes(ops)],
                                              device=wire))
        return [int(x) for x in sizes.tolist()]
    if op == SOLVE_BATCH:
        srcs = payload if payload is not None else torch.empty(
            S, dtype=torch.int64, device=wire)
        group.broadcast(srcs)
        parts, ops = blocks[slot]
        return sssp_multisource_csr_sharded(parts, srcs.to(group.device),
                                            group, ops=ops, max_sweeps=cap)
    if op == SOLVE_P2P:
        parts, ops = blocks[slot]
        return sssp_frontier_sharded(parts, a, group, ops=ops,
                                     max_sweeps=cap)
    if op == DROP:
        blocks.pop(slot, None)
        return None
    if op == STATS:
        from repro_torch.kernels import wrappers

        kernels = wrappers()
        names = sorted(kernels)
        row = [len(blocks), sum(_staged_bytes(o) for _, o in blocks.values()),
               group.collectives] + [kernels[k].launches for k in names]
        got = group.all_gather(torch.tensor(row, device=wire)).view(
            group.size, -1).tolist()
        return [{"rank": r, "slots": v[0], "staged_bytes": v[1],
                 "collectives": v[2], "launches": dict(zip(names, v[3:]))}
                for r, v in enumerate(got)]
    raise ValueError(f"unknown opcode {op}")


def _follower_main(rank, size, backend, device, shared, store_dir, timeout,
                   conn, errors):
    """One follower: join the group, then carry out commands until
    ``STOP`` or until the leader's end of the pipe closes.  On a failure
    it reports its traceback on ``errors`` and exits at once, which ends
    the leader's pending collective."""
    try:
        if device == "cpu":
            # P ranks share the host's cores: one intra-op thread each
            torch.set_num_threads(1)
        errors.put((rank, None))      # started: about to join
        group = open_group(rank, size, backend=backend, device=device,
                           store_dir=store_dir, timeout=timeout,
                           shared=shared)
        blocks: dict = {}
        while True:
            try:
                hdr = np.frombuffer(conn.recv_bytes(), np.int64)
            except EOFError:          # the leader is gone: nothing to wait
                os._exit(0)
            if hdr[0] == STOP:
                break
            _act(group, blocks, hdr)
        group.close()
    except BaseException:             # the boundary: report, then go
        errors.put((rank, traceback.format_exc()))
        errors.close()
        errors.join_thread()
        os._exit(1)


class ServingGroup:
    """The leader's side of a serving group (see the module docstring):
    rank 0 in this process, ranks 1..P-1 spawned followers.  Made by
    :func:`open_serving_group`; close it (or leave its ``with`` block)
    when done.

    ``commands`` counts the commands sent; ``broken`` holds the
    :class:`~repro_torch.serve.errors.GroupBroken` error once a command
    failed, and every later command raises it before sending anything;
    ``start_s`` is the seconds the group took to open."""

    def __init__(self, group: ShardGroup, procs, conns, errors,
                 timeout: float, start_s: float, store_dir: str):
        self.group = group
        self.procs = procs
        self.conns = conns
        self.errors = errors
        self.timeout = timeout
        self.start_s = start_s
        self.commands = 0
        self.broken = None
        self.closed = False
        self.store_dir = store_dir      # the file store's, removed at close
        self._blocks: dict = {}
        self._next_slot = 0

    @property
    def size(self) -> int:
        return self.group.size

    @property
    def device(self) -> torch.device:
        return self.group.device

    @property
    def backend(self) -> str:
        return self.group.backend

    # -- commands -----------------------------------------------------------

    def _send(self, hdr, **kw):
        if self.closed:
            raise RuntimeError("the serving group is closed")
        if self.broken is not None:
            raise self.broken
        words = np.asarray(hdr, np.int64)
        try:
            for conn in self.conns:
                conn.send_bytes(words.tobytes())
            self.commands += 1
            return _act(self.group, self._blocks, words, **kw)
        except Exception as e:
            raise self._break(e) from e

    def _block(self, slot: int):
        if slot not in self._blocks:
            raise ValueError(f"slot {slot} holds no staged graph")
        return self._blocks[slot][0]

    @staticmethod
    def _cap(max_sweeps) -> int:
        if max_sweeps is None:
            return -1
        if int(max_sweeps) < 0:
            raise ValueError(f"max_sweeps must be >= 0, got {max_sweeps}")
        return int(max_sweeps)

    def stage(self, parts, cg) -> tuple:
        """Stage ``cg``'s partition ``parts`` (``cg.partitioned(P)``) on
        every rank.  Returns ``(slot, the leader's block, each rank's
        staged bytes)``."""
        if parts.nprocs != self.size or parts.n != cg.n:
            raise ValueError(f"a partition of n={parts.n} for "
                             f"{parts.nprocs} owners, graph n={cg.n}, "
                             f"group of {self.size}")
        slot = self._next_slot
        self._next_slot += 1
        wire = _wire(self.group)
        payload = tuple(torch.tensor(a, device=wire)
                        for a in (cg.indptr, cg.indices, cg.weights))
        sizes = self._send([STAGE, slot, self.size, 0, 0, -1, cg.n, cg.nnz],
                           parts=parts, payload=payload)
        return slot, self._blocks[slot][1], sizes

    def solve_batch(self, slot: int, sources, *, max_sweeps=None):
        """``sssp_multisource_csr_sharded`` from ``sources`` on the graph
        in ``slot``: ``(D (S, n_pad), sweeps, edges_relaxed,
        converged)``."""
        parts = self._block(slot)
        srcs = np.asarray(sources, np.int64).reshape(-1)
        if srcs.size == 0 or srcs.min() < 0 or srcs.max() >= parts.n:
            raise ValueError(f"sources must be in [0, {parts.n}), got "
                             f"{srcs.tolist()}")
        cap = self._cap(max_sweeps)
        return self._send(
            [SOLVE_BATCH, slot, self.size,
             SERVE_ENGINES.index("multisource_csr_sharded"), srcs.size, cap,
             0, 0],
            payload=torch.tensor(srcs, device=_wire(self.group)))

    def solve(self, slot: int, source: int, *, max_sweeps=None):
        """``sssp_frontier_sharded`` from ``source`` to its fixpoint on the
        graph in ``slot``: ``(dist (n_pad,), pred (n_pad,), sweeps,
        edges_relaxed, converged)``."""
        parts = self._block(slot)
        if not 0 <= int(source) < parts.n:
            raise ValueError(f"source must be in [0, {parts.n}), got "
                             f"{source}")
        cap = self._cap(max_sweeps)
        return self._send([SOLVE_P2P, slot, self.size,
                           SERVE_ENGINES.index("frontier_sharded"), 1, cap,
                           int(source), 0])

    def drop(self, slot: int) -> None:
        """Free the graph in ``slot`` on every rank (a no-op on a broken
        or closed group: its followers are gone)."""
        if self.broken is None and not self.closed and slot in self._blocks:
            try:
                self._send([DROP, slot, self.size, 0, 0, -1, 0, 0])
            except Exception:
                if self.broken is None:
                    raise             # not a failure of the group
        self._blocks.pop(slot, None)

    def stats(self) -> list:
        """Each rank's staged slots and bytes, collectives and kernel
        launch counts, by rank."""
        return self._send([STATS, 0, self.size, 0, 0, -1, 0, 0])

    # -- failure and close ---------------------------------------------------

    def _culprit(self, exc) -> tuple:
        """(rank, what happened) for a failed command: a follower's
        reported traceback, else a follower that exited, else the
        leader's own error."""
        deadline = time.monotonic() + 2.0
        while True:
            try:
                rank, tb = self.errors.get(timeout=0.1)
                if tb is not None:
                    return rank, f"raised:\n{tb}"
                continue
            except queue.Empty:
                pass
            for r, p in enumerate(self.procs, 1):
                if p.exitcode is not None:
                    return r, f"exited with code {p.exitcode}"
            if time.monotonic() > deadline:
                return 0, f"(the leader) raised {type(exc).__name__}: {exc}"

    def _break(self, exc) -> Exception:
        from repro_torch.serve.errors import GroupBroken

        rank, what = self._culprit(exc)
        self.broken = GroupBroken(
            f"serving group of {self.size} broken: rank {rank} {what}",
            rank=rank)
        for p in self.procs:          # they cannot serve without it
            if p.is_alive():
                p.kill()
        return self.broken

    def close(self) -> None:
        """Stop the followers, join them and destroy this process's group
        (idempotent).  A broken group's followers are killed instead."""
        if self.closed:
            return
        self.closed = True
        ok = self.broken is None
        if ok:
            try:
                stop = np.asarray([STOP] + [0] * (HEADER - 1), np.int64)
                for conn in self.conns:
                    conn.send_bytes(stop.tobytes())
            except OSError:
                ok = False
        try:
            self.group.close(wait=ok)
        finally:
            for conn in self.conns:
                conn.close()
            for p in self.procs:
                p.join(timeout=self.timeout if ok else 1.0)
                if p.is_alive():
                    p.kill()
                    p.join()
            self.errors.close()
            self.errors.join_thread()
            shutil.rmtree(self.store_dir, ignore_errors=True)

    def __enter__(self) -> "ServingGroup":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _await_start(procs, errors, timeout: float) -> None:
    """Wait until every follower has started (imported its modules and is
    about to join); raise at once if one raises or exits first."""
    started, deadline = set(), time.monotonic() + timeout
    while len(started) < len(procs):
        try:
            rank, tb = errors.get(timeout=0.2)
        except queue.Empty:
            dead = [r for r, p in enumerate(procs, 1)
                    if p.exitcode is not None]
            if dead:
                raise RuntimeError(f"follower rank {dead[0]} exited with "
                                   f"code {procs[dead[0] - 1].exitcode} "
                                   f"before joining") from None
            if time.monotonic() > deadline:
                raise RuntimeError(f"followers did not start within "
                                   f"{timeout} s") from None
            continue
        if tb is not None:
            raise RuntimeError(f"follower rank {rank} failed to start:\n"
                               f"{tb}")
        started.add(rank)


def open_serving_group(nprocs: int, *, device,
                       timeout: float = DEFAULT_TIMEOUT,
                       shared: bool = False) -> ServingGroup:
    """Open a serving group of ``nprocs`` ranks: this process joins as
    rank 0 (the leader) on ``device`` and ``nprocs - 1`` followers are
    spawned, NCCL rank r on ``cuda:r``, gloo ranks on the CPU, or with
    ``shared`` gloo ranks all on the card ``device``.  The ranks meet on a
    file store in a temporary directory, removed at close.  ``timeout``
    bounds the group's start and each collective.  Raises (and leaves no
    process behind) when the ranks or cards are missing."""
    if nprocs < 2:
        raise ValueError(f"a serving group has >= 2 ranks, got {nprocs}")
    backend = "gloo" if shared else BACKEND_OF.get(torch.device(device).type)
    dev = check_backend(backend, device, shared=shared)
    if backend == "nccl":
        check_gpus(nprocs)
    if dist.is_initialized():
        raise RuntimeError("this process already holds a process group; "
                           "close it first")
    t0 = time.perf_counter()
    store_dir = tempfile.mkdtemp(prefix="serving-group-")
    ctx = mp.get_context("spawn")
    errors = ctx.Queue()
    procs, conns = [], []
    try:
        for r in range(1, nprocs):
            recv, send = ctx.Pipe(duplex=False)
            rank_dev = (f"cuda:{r}" if backend == "nccl"
                        else "cpu" if dev.type == "cpu" else str(dev))
            p = ctx.Process(target=_follower_main, daemon=True,
                            args=(r, nprocs, backend, rank_dev, shared,
                                  store_dir, timeout, recv, errors))
            p.start()
            recv.close()              # the follower holds the read end
            procs.append(p)
            conns.append(send)
        _await_start(procs, errors, timeout)
        group = open_group(0, nprocs, backend=backend, device=dev,
                           store_dir=store_dir, timeout=timeout,
                           shared=shared)
    except BaseException:
        for p in procs:
            p.kill()
            p.join()
        shutil.rmtree(store_dir, ignore_errors=True)
        raise
    return ServingGroup(group, procs, conns, errors, timeout,
                        time.perf_counter() - t0, store_dir)
