"""Engine-selection seam (port of repro/serve/dispatch.py): one place that
decides which engine serves a solve.

Both entry points into the engine stack route through here instead of
hard-coding engine names: ``core.api.shortest_paths(engine="auto")`` for
one-shot callers, and ``MicroBatchScheduler`` for every served batch /
point-to-point solve (serve/scheduler.py takes a ``dispatch=`` policy).
Centralizing the choice keeps the two paths answering identically and
gives operators a single knob set.

The thresholds are the JAX package's.  Graphs with ``n >=
shard_threshold`` route to the vertex-partitioned engines only when the
device has peers to partition across (``nprocs`` is
``torch.cuda.device_count()`` for a CUDA policy, 1 for the CPU), so on one
card nothing shards; the sharded engines belong to a later slice of the
port and raise ``NotImplementedError`` where they would run.  Below the
shard crossover, large single-source solves on static CSR graphs route to
the Δ-stepping engine when the graph's weight profile keeps its light
in-degree narrow (``would_delta``).  Dynamic graphs never shard and stay
on the plain engines: their serving path runs the overlay sweeps
(dynamic/repair.py) on the overlay operands.

**The device picks the twin.**  A policy built for the CPU uses the JAX
package's tables verbatim.  A policy built for a CUDA device names the
kernel twin of each single-device engine — ``frontier_kernel`` for
single-source and point-to-point solves, ``delta_stepping_kernel`` for
the Δ route — whose dist, pred and counters are bitwise those of the
plain engine; ``multisource_csr`` has no kernel in either package and
stays.  The choice is the same; the port implements it with its kernels.

``EngineChoice`` keeps the JAX fields; ``mesh`` is always None here.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

# crossover at which graphs route to the sharded engines (JAX's value)
DEFAULT_SHARD_THRESHOLD = 20000

# vertex count from which single-device single-source solves try the
# Δ-stepping engine; routing also needs a routable delta_profile.
DEFAULT_DELTA_THRESHOLD = 4096

# query kinds the scheduler distinguishes (scheduler.tick's two solve
# paths plus api's one-shot single-source case).
KINDS = ("single", "batch", "p2p")

# the kernel twin of each single-device engine that has one: the same
# dist, pred and counters through the port's CUDA kernel
KERNEL_TWINS = {"frontier": "frontier_kernel",
                "bellman_csr": "bellman_csr_kernel",
                "delta_stepping": "delta_stepping_kernel"}


def engine_for(engine: str, device) -> str:
    """``engine`` as ``device`` runs it: its kernel twin on a CUDA device,
    itself on the CPU or where it has no twin."""
    if torch.device(device).type == "cuda":
        return KERNEL_TWINS.get(engine, engine)
    return engine


@dataclasses.dataclass(frozen=True)
class EngineChoice:
    """One routing decision: which engine, and the shard arity cache keys
    must carry.

    The optional statics fields let a policy return the engine's tuning
    parameters too: ``delta`` is the Δ-bucket width for the engines that
    consume one, ``chunk`` the JAX frontier engines' scatter chunk (the
    port's frontier engine has no chunks and ignores it), ``batch_cap``
    the padded multisource bucket ceiling the scheduler should admit per
    tick.  ``None`` means "caller keeps its default".  ``via`` names which
    arm decided: ``"threshold"`` for the size rules.  ``mesh`` and
    ``axis`` keep the JAX fields for the sharded slice; ``mesh`` is None.
    """
    engine: str
    mesh: Optional[object]
    axis: str = "data"
    nprocs: int = 1
    delta: Optional[float] = None
    chunk: Optional[int] = None
    batch_cap: Optional[int] = None
    via: str = "threshold"

    @property
    def sharded(self) -> bool:
        return self.nprocs > 1


class DispatchPolicy:
    """Size-threshold routing for solves on ``device``.

    shard_threshold: vertex count at which graphs route sharded
        (inclusive).  ``None`` disables sharding outright.
    nprocs: devices to partition across; default = every device of
        ``device``'s type (``torch.cuda.device_count()``, or 1 on the
        CPU), clamped to it; 1 also disables sharding.
    axis: mesh axis name (the JAX field, for the sharded slice).
    delta_threshold: vertex count at which non-sharded single-source
        solves on static CsrGraphs route to the Δ-stepping engine
        (inclusive), when the graph's weight profile supports it.
        ``None`` disables Δ routing.
    device: the device the routed solves run on; ``"cuda"`` needs a GPU
        and raises without one.
    """

    def __init__(self, *,
                 shard_threshold: int | None = DEFAULT_SHARD_THRESHOLD,
                 nprocs: int | None = None, axis: str = "data",
                 delta_threshold: int | None = DEFAULT_DELTA_THRESHOLD,
                 device="cuda"):
        from repro_torch.core.api import resolve_device

        self.device = resolve_device(device)
        avail = (torch.cuda.device_count() if self.device.type == "cuda"
                 else 1)
        self.nprocs = avail if nprocs is None else min(int(nprocs), avail)
        self.shard_threshold = shard_threshold
        self.delta_threshold = delta_threshold
        self.axis = axis
        # static graphs run each engine as the device does (engine_for);
        # dynamic graphs take _SINGLE on every device (the overlay sweeps
        # are plain)
        self._static = {kind: engine_for(e, self.device)
                        for kind, e in self._SINGLE.items()}
        self._delta = engine_for("delta_stepping", self.device)

    # JAX's engine per (family, kind): p2p stays on frontier single-device
    # for the target= early exit.
    _SINGLE = {"single": "frontier", "batch": "multisource_csr",
               "p2p": "frontier"}
    _SHARDED = {"single": "frontier_sharded",
                "batch": "multisource_csr_sharded",
                "p2p": "frontier_sharded"}

    def would_shard(self, n: int, *, dynamic: bool = False) -> bool:
        """Pure size check — no staging side effects, so callers
        (scheduler, registry) can compute deterministic cache-key shapes
        before anything is staged."""
        return (not dynamic
                and self.shard_threshold is not None
                and self.nprocs > 1
                and n >= self.shard_threshold)

    def would_delta(self, g, n: int, *, dynamic: bool = False) -> bool:
        """Whether a non-sharded single-source solve of ``g`` should use
        the Δ-stepping engine: a static CsrGraph at or above
        ``delta_threshold`` whose ``delta_profile(g)["routable"]`` holds
        (memoized on the graph).  Only graphs that carry CSR arrays
        qualify."""
        if (dynamic or self.delta_threshold is None
                or n < self.delta_threshold):
            return False
        if getattr(g, "indptr", None) is None:      # not CSR-backed
            return False
        from repro_torch.core.delta_stepping import delta_profile

        return bool(delta_profile(g)["routable"])

    def batch_cap(self, g) -> Optional[int]:
        """Per-tick distinct-source admission ceiling for batched solves
        of ``g``, or ``None`` for "scheduler keeps its ``max_batch``" —
        the threshold policy has no opinion."""
        return None

    def choose(self, g, *, kind: str = "single") -> EngineChoice:
        """Route one solve.  ``g`` is anything with an ``n`` (CsrGraph,
        Graph, DynamicGraph, GraphHandle-like) or a dense square array;
        dynamic graphs are detected and pinned to the plain single-device
        family (see module docstring)."""
        if kind not in KINDS:
            raise ValueError(f"unknown kind {kind!r}; choose from {KINDS}")
        from repro_torch.dynamic.overlay import DynamicGraph

        dynamic = isinstance(g, DynamicGraph) or getattr(g, "dyn", None) is not None
        n = getattr(g, "n", None)
        if n is None:
            n = int(np.asarray(g).shape[0])
        if self.would_shard(int(n), dynamic=dynamic):
            return EngineChoice(self._SHARDED[kind], None, self.axis,
                                self.nprocs)
        if dynamic:
            return EngineChoice(self._SINGLE[kind], None, self.axis, 1)
        # kind="single" only (batch wants the shared-gather multisource
        # engine, p2p the target= early exit the Δ engine doesn't have).
        if kind == "single" and self.would_delta(g, int(n)):
            return EngineChoice(self._delta, None, self.axis, 1)
        return EngineChoice(self._static[kind], None, self.axis, 1)


_DEFAULT: Optional[DispatchPolicy] = None
_BY_DEVICE: dict = {}


def default_policy(device="cuda") -> DispatchPolicy:
    """Process-wide policy used by ``shortest_paths(engine="auto")`` and by
    schedulers constructed without an explicit ``dispatch=``: the policy
    installed by :func:`set_default_policy` if any, else the threshold
    policy for ``device``'s type, built on first use."""
    if _DEFAULT is not None:
        return _DEFAULT
    key = torch.device(device).type
    if key not in _BY_DEVICE:
        _BY_DEVICE[key] = DispatchPolicy(device=device)
    return _BY_DEVICE[key]


def set_default_policy(
        policy: Optional[DispatchPolicy]) -> Optional[DispatchPolicy]:
    """Install (or with ``None`` reset) the process-wide policy.  Returns
    the PREVIOUS installed policy (``None`` if there was none) so callers
    can restore it; prefer :func:`policy_override` for scoped swaps."""
    global _DEFAULT
    prev = _DEFAULT
    _DEFAULT = policy
    return prev


@contextlib.contextmanager
def policy_override(policy: Optional[DispatchPolicy]):
    """Scoped :func:`set_default_policy`: installs ``policy`` for the
    ``with`` body and restores the previous one on exit (exception
    included).  Yields the installed policy."""
    prev = set_default_policy(policy)
    try:
        yield policy
    finally:
        set_default_policy(prev)
