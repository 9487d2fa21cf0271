"""Frontier-compacted SSSP over outgoing CSR edges — O(frontier out-degree)
per sweep (port of repro/core/frontier.py).

Each sweep relaxes only the out-edges of the *active* vertices, those whose
label improved last sweep:

1. **Compact** the active mask with ``torch.nonzero`` (one host sync: the
   frontier's size decides the shapes that follow) and take each frontier
   vertex's out-window from the outgoing CSR (``CsrGraph.out_csr()``).
2. **Relax** every slot of those windows in one pass — PyTorch has no
   static shapes to keep, so the JAX version's fixed-size slot chunks are
   gone — scatter-min'ing into ``dist`` in place from the frontier rows'
   labels as they were before the sweep (a Jacobi sweep, as every other
   engine, with a snapshot of F labels, not n), and setting the labels
   that fell in the loop's ``pending`` mask, cleared of the active rows
   first.  No sweep copies or compares all n labels.

Distances are bitwise equal to every other engine's (min over the same f32
path sums).  The optional **Δ-bucket throttle** (``delta=``) expands only
pending vertices with ``dist <= limit`` and moves the limit up by Δ when
the bucket drains.  The optional **target early exit** (``target=``) stops
once no pending label is below ``dist[target]`` (or, with an admissible
``target_lb=``, once ``dist[target] <= target_lb``): ``dist[target]`` is
then final and bitwise equal to the full solve's, and ``pred`` is None.

``edges_relaxed`` sums the frontier out-degrees over all sweeps (int64),
read from the flat out-indptr whichever sweep runs.  ``frontier_fixpoint``
also takes a warm start and an ``edges0`` to count on from: the dynamic
repair (dynamic/repair.py) seeds it after rebuilding its invalidated cone
with :func:`pull_edge_slots`, the pull form of the slot walk.

The kernel path (engine ``frontier_kernel``) swaps the sweep for the
in-place CUDA push kernel in kernels/frontier_relax, which flags the
fallen labels from its atomics.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.bellman_csr import (_start, csr_operands,
                                          predecessors_from_dist_csr)


def frontier_operands(cg, *, device, base_ops: Optional[dict] = None) -> dict:
    """Stage a core.csr.CsrGraph for the frontier engines: the incoming
    arrays of :func:`csr_operands` (for the pred recovery) plus the outgoing
    CSR.  The out-indptr (int32) gets one extra trailing entry, so the
    sentinel id n indexes an empty row.  ``base_ops`` reuses already-staged
    :func:`csr_operands` tensors instead of staging src / dst / w again
    (serve/registry.py holds both views on one handle)."""
    ops = (dict(base_ops) if base_ops is not None
           else csr_operands(cg, device=device))
    indptr, out_dst, out_w = cg.out_csr()
    indptr_s = np.concatenate([indptr, indptr[-1:]]).astype(np.int32)
    ops["out_indptr"] = torch.tensor(indptr_s, device=device)
    ops["out_dst"] = torch.tensor(out_dst, device=device)
    ops["out_w"] = torch.tensor(out_w, device=device)
    return ops


def relax_edge_slots(dist, row_dist, starts, off, E, out_dst, out_w, fell):
    """Scatter-min ``row_dist[row] + w`` over the E edge slots of a
    compacted frontier into ``dist`` in place, and set ``fell[v]`` for every
    target label that fell.

    row_dist: (F,) source label of each frontier row; starts: each row's
    window start in (out_dst, out_w); off: the exclusive cumsum of the
    window lengths; E: total slots.  A slot's row is the last row whose
    window starts at or before it (``searchsorted(off, slot, right) - 1``,
    landing past empty rows), its arc ``starts[row] + slot - off[row]``.
    """
    E = int(E)
    if E == 0:
        return
    slots = torch.arange(E, device=dist.device)
    row = torch.searchsorted(off, slots, right=True) - 1
    pos = starts[row] + (slots - off[row])
    cand = row_dist[row] + out_w[pos]
    tgt = out_dst[pos].long()
    old = dist[tgt]
    dist.scatter_reduce_(0, tgt, cand, "amin")
    # the same value for every slot of one target, so duplicates agree
    fell[tgt] |= dist[tgt] < old


def pull_edge_slots(nd, fids, src_dist, starts, off, E, in_src, in_w):
    """The pull form of :func:`relax_edge_slots`: scatter-min
    ``src_dist[in_src[pos]] + in_w[pos]`` over the E slots of the compacted
    rows' incoming windows into each row's own vertex ``fids[row]``, in one
    pass.  Returns a new tensor; ``nd`` is not written.

    dynamic/repair.py rebuilds the invalidated cone's labels from its
    boundary with it, in O(cone in-degree): the rows are the cone's
    vertices, the windows come from the incoming CSR, and cone sources
    carry INF so only live support lands.  Slot arithmetic as in
    :func:`relax_edge_slots`; a row with an empty window (such as the id n
    on the sentinel row of the offsets) owns no slot.
    """
    E = int(E)
    if E == 0:
        return nd.clone()
    slots = torch.arange(E, device=nd.device)
    row = torch.searchsorted(off, slots, right=True) - 1
    pos = starts[row] + (slots - off[row])
    cand = src_dist[in_src[pos]] + in_w[pos]
    return nd.scatter_reduce(0, fids[row], cand, "amin")


def make_flat_sweep_fn() -> Callable:
    """The default frontier sweep over flat-CSR edge windows.

    The sweep contract (shared with kernels/frontier_relax/ops.py):
    ``sweep(dist, fids, starts, off, E, fcount, ops, fell)`` with fids the
    compacted frontier ids, starts their out-window starts, off the
    exclusive cumsum of their out-degrees, E the total out-degree and fcount
    the frontier size.  It lowers ``dist`` in place, reading each source
    label as it was before the sweep, and sets ``fell[v]`` for every label
    that fell, clearing none.
    """
    def sweep(dist, fids, starts, off, E, fcount, ops, fell):
        relax_edge_slots(dist, dist[fids], starts, off, E, ops["out_dst"],
                         ops["out_w"], fell)
    return sweep


def relax_active(ops: dict, dist, active, pending, *, sweep: Callable):
    """Compact the ``active`` mask and relax its out-edge windows once —
    shared by :func:`frontier_fixpoint` and the Δ-stepping heavy phase.
    In place: ``pending`` loses the active rows, ``dist`` is lowered, and
    every label that fell joins ``pending`` — so ``pending`` ends as
    ``(pending & ~active) | (new < old)``.  ``active`` may be ``pending``
    itself.  ``ops`` needs out_indptr (with the trailing sentinel entry),
    out_dst and out_w.  Returns E, the active set's total out-degree, as a
    0-dim int64 tensor on the device."""
    fids = torch.nonzero(active).flatten()           # host sync
    ip = ops["out_indptr"]
    starts = ip[fids]
    degs = ip[fids + 1] - starts
    csum = torch.cumsum(degs, 0)
    E = csum[-1] if fids.numel() else csum.new_zeros(())
    pending &= ~active
    sweep(dist, fids, starts, csum - degs, E, fids.numel(), ops, pending)
    return E


def sweep_cap(n: int, delta, max_sweeps: int | None, max_dist=None) -> int:
    """Fixpoint sweep bound shared by the frontier-family engines: n for
    the plain schedule; under Δ-bucketing ``n + ceil(max_dist / Δ) + 1``
    (the bucket limit advances at most that often before clearing every
    finite label), floored at the constant ``4·n``, which is also the
    bound when no ``max_dist`` is known.  ``max_dist`` and ``delta`` may be
    float32 tensors; the bucket count is taken in float32 as in the JAX
    engine and clamped to 2**30 when it is not finite."""
    if max_sweeps is not None:
        return max_sweeps
    if delta is None:
        return n
    if max_dist is None:
        return 4 * n
    f32 = torch.float32
    max_dist = torch.as_tensor(max_dist, dtype=f32)
    delta = torch.as_tensor(delta, dtype=f32, device=max_dist.device)
    buckets = torch.ceil(max_dist / delta) + 1.0
    buckets = torch.where(torch.isfinite(buckets), buckets, 2.0 ** 30)
    buckets = int(torch.clamp(buckets, 0.0, 2.0 ** 30))
    return max(4 * n, n + buckets)


def frontier_fixpoint(
    ops: dict,
    dist0,
    pending0,
    *,
    n: int,
    sweep: Callable,
    cap: int,
    delta: float | None = None,
    target: int | None = None,
    target_lb: float | None = None,
    edges0=0,
):
    """The frontier relax loop on an arbitrary initial state.  Returns
    ``(dist, sweeps, edges_relaxed, converged)``: ``edges_relaxed`` counts
    on from ``edges0`` (an int or a 0-dim tensor: the repair's pull), and
    ``converged`` is True iff the loop stopped because the pending set
    drained (or the target settled) rather than because ``cap`` ran out.
    Each sweep reads two values back to the host: the stop test and the
    frontier's size.

    A warm start (dynamic/repair.py) must have ``dist0`` pointwise at or
    above the fixpoint, every finite label a real path length, and
    ``pending0`` covering every vertex whose label fell since its
    out-neighbours last saw it; the loop then lands on the cold solve's
    fixpoint, bitwise.

    The loop works in place on copies of ``dist0`` and ``pending0`` taken
    once on entry, so the caller's tensors are never written."""
    dev = dist0.device
    f32 = torch.float32
    inf = torch.tensor(torch.inf, dtype=f32, device=dev)
    delta_t = None if delta is None else torch.tensor(delta, dtype=f32,
                                                      device=dev)
    limit = torch.tensor(0.0 if delta is None else delta, dtype=f32,
                         device=dev)
    lb = None if target_lb is None else torch.tensor(target_lb, dtype=f32,
                                                     device=dev)

    def settled_or_done(dist, pending):
        done = ~pending.any()
        if target is not None:
            dt = dist[target]
            # settled once no pending label is below the target's: every
            # future candidate is dist[u] + w >= dist[u] >= min pending.
            settled = torch.where(pending, dist, inf).amin() >= dt
            if lb is not None:
                # an admissible bound pins the label from below
                settled = settled | (dt <= lb)
            done = done | settled
        return bool(done)

    dist, pending = dist0.clone(), pending0.clone()
    sweeps = 0
    edges = torch.as_tensor(edges0, dtype=torch.int64).to(dev)
    while sweeps < cap and not settled_or_done(dist, pending):
        if delta is None:
            active = pending
        else:
            has = (pending & (dist <= limit)).any()
            nxt = torch.where(pending, dist, inf).amin() + delta_t
            limit = torch.where(has, limit, nxt)
            active = pending & (dist <= limit)
        E = relax_active(ops, dist, active, pending, sweep=sweep)
        sweeps, edges = sweeps + 1, edges + E
    return dist, sweeps, int(edges), settled_or_done(dist, pending)


def sssp_frontier(
    ops: dict,
    source: int,
    *,
    n: int,
    sweep_fn: Optional[Callable] = None,
    max_sweeps: int | None = None,
    delta: float | None = None,
    target: int | None = None,
    target_lb: float | None = None,
):
    """Frontier-compacted fixpoint SSSP on :func:`frontier_operands`.

    Returns ``(dist, pred, num_sweeps, edges_relaxed, converged)``.
    ``delta`` enables the Δ-bucket throttle, ``target``/``target_lb`` the
    early exit (module docstring); a target solve is partial, so its
    ``pred`` is None.
    """
    sweep = sweep_fn or make_flat_sweep_fn()
    cap = sweep_cap(n, delta, max_sweeps)
    dist0 = _start(n, source, ops["out_w"].device)
    dist, sweeps, edges, converged = frontier_fixpoint(
        ops, dist0, dist0 < torch.inf, n=n, sweep=sweep, cap=cap,
        delta=delta, target=target, target_lb=target_lb,
    )
    if target is not None:
        return dist, None, sweeps, edges, converged
    pred = predecessors_from_dist_csr(dist, ops, source)
    return dist, pred, sweeps, edges, converged
