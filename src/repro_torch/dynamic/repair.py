"""Incremental SSSP repair over a mutated graph (port of
repro/dynamic/repair.py).

A repair turns the fixpoint of the previous version into the fixpoint of
the current one, in two directions matched to the sign of each
:class:`~repro_torch.dynamic.overlay.EdgeDelta` (INF means absent, so
inserts and deletes are extreme decreases and increases):

* **decrease / insert** lowers labels only: ``dist[u] + w_new`` is
  scatter-min'd at each modified arc's head, and every head that fell
  seeds the frontier push of core/frontier.py;
* **increase / delete** raises labels only, and only inside the
  **invalidated cone**: the predecessor-tree descendants of the heads
  whose tree arc was hit (a vertex whose old tree path survived keeps a
  valid path length).  The cone comes from pointer doubling over ``pred``
  (ceil(log2 n) rounds, no edge relaxed), is reset to INF, and is
  re-derived from its boundary by one pull over its incoming windows
  (``pull_edge_slots``); the cone vertices that improved seed the push.

A mixed batch resets the cone, applies the decrease seeds, pulls, and
runs one shared push.  The result is bitwise equal to a fresh solve on the
mutated graph: the warm start is pointwise at or above the new fixpoint
with every finite label a real path length (``frontier_fixpoint``'s
warm-start contract), and ``pred`` is recovered from (dist, graph) as a
fresh solve recovers it.

``edges_relaxed`` counts base-arc relax slots: the pull's cone in-degree
plus the push sweeps' frontier out-degrees, comparable with a full
:func:`sssp_frontier_dynamic` solve's counter (overlay slots, at most the
fixed overlay capacity a sweep, are left out of both).

The module also holds the **dynamic sweeps** that run the unchanged core
fixpoint engines (``sssp_bellman_csr``, ``sssp_multisource_csr``,
``sssp_frontier``) on :meth:`DynamicGraph.dyn_ops`: each is the static
sweep plus a scatter-min over the overlay slots, whose free slots aim an
INF candidate at the drop id n.

No kernel of the port runs on this path: the JAX engines use none here
either (they build on the plain flat and segment sweeps).  Each push sweep
reads two values back to the host, as in core/frontier.py, and the cone's
compaction one more.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

from repro_torch.core.api import SsspResult, resolve_device
from repro_torch.core.bellman_csr import (_start, segment_relax_sweep,
                                          segment_relax_sweep_multi)
from repro_torch.core.frontier import (frontier_fixpoint, make_flat_sweep_fn,
                                       pull_edge_slots, sweep_cap)
from repro_torch.dynamic.overlay import DynamicGraph, MutationBatch


def _min_drop_(x: torch.Tensor, idx: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """In place ``x[..., idx] = min(x[..., idx], vals)`` along the last
    axis, dropping every index >= that axis' length (the overlay's drop id
    n): a dropped slot scatters the dtype's largest value, which never
    wins a min, at index 0.  ``torch.scatter_reduce`` raises on an index
    out of range where JAX's ``mode="drop"`` drops it.  Returns ``x``."""
    keep = idx < x.shape[-1]
    top = torch.inf if x.is_floating_point() else torch.iinfo(x.dtype).max
    vals = torch.where(keep, vals, top)
    x.scatter_reduce_(-1, torch.where(keep, idx, 0).expand_as(vals), vals,
                      "amin")
    return x


# ---------------------------------------------------------------------------
# dynamic sweeps: static sweeps + an overlay scatter-min
# ---------------------------------------------------------------------------

def dynamic_segment_sweep(dist: torch.Tensor, ops: dict) -> torch.Tensor:
    """O(m + C) relax sweep on dynamic operands: the base segment-min
    (tombstoned arcs carry INF and never win) plus a scatter-min over the
    overlay slots.  A ``sweep_fn`` for ``sssp_bellman_csr``."""
    nd = segment_relax_sweep(dist, ops)
    return _min_drop_(nd, ops["ov_dst"], dist[ops["ov_src"]] + ops["ov_w"])


def dynamic_segment_sweep_multi(D: torch.Tensor, ops: dict) -> torch.Tensor:
    """Batched (S, n) twin of :func:`dynamic_segment_sweep`, a
    ``sweep_fn`` for ``sssp_multisource_csr``."""
    nd = segment_relax_sweep_multi(D, ops)
    return _min_drop_(nd, ops["ov_dst"], D[:, ops["ov_src"]] + ops["ov_w"])


def make_dynamic_flat_sweep_fn() -> Callable:
    """Frontier sweep on dynamic operands, in the in-place sweep contract of
    core/frontier.py (``sweep(dist, fids, starts, off, E, fcount, ops,
    fell)``): the flat push over the effective out-weights plus the overlay
    arcs whose source is on the frontier.

    The overlay candidates are gathered from ``dist`` before the base push
    lowers it in place, so they read the labels as they were before the
    sweep (a Jacobi sweep, as JAX's reads them); reading them after would
    reach the same fixpoint but could change ``sweeps`` and
    ``edges_relaxed``.  Every overlay target that falls joins ``fell``."""
    base = make_flat_sweep_fn()

    def sweep(dist, fids, starts, off, E, fcount, ops, fell):
        src = ops["ov_src"]
        active = torch.zeros_like(fell)
        active[fids] = True
        cand = torch.where(active[src], dist[src] + ops["ov_w"], torch.inf)
        base(dist, fids, starts, off, E, fcount, ops, fell)
        tgt = ops["ov_dst"].clamp(max=dist.shape[0] - 1)
        old = dist[tgt]
        _min_drop_(dist, ops["ov_dst"], cand)
        # a free slot's candidate is INF, so its clamped target never falls
        fell[tgt] |= dist[tgt] < old

    return sweep


def predecessors_from_dist_dynamic(dist: torch.Tensor, ops: dict,
                                   source: int) -> torch.Tensor:
    """``pred`` (int32) at the fixpoint over base and overlay arcs, with the
    lowest-u tie-break of ``predecessors_from_dist_csr`` across both, so the
    tree is the one a fresh solve on the snapshot recovers.  Valid under
    strictly positive weights."""
    n = dist.shape[0]
    src, dst = ops["src"], ops["dst"]
    ov_src, ov_dst = ops["ov_src"], ops["ov_dst"]
    via_b = dist[src] + ops["w"]
    best = torch.full_like(dist, torch.inf).scatter_reduce(0, dst, via_b,
                                                           "amin")
    via_o = dist[ov_src] + ops["ov_w"]
    _min_drop_(best, ov_dst, via_o)
    u_cand = torch.where(via_b <= best[dst], src, n)
    u_best = torch.full((n,), n, dtype=torch.int64,
                        device=dist.device).scatter_reduce(0, dst, u_cand,
                                                           "amin")
    best_o = best[ov_dst.clamp(max=n - 1)]       # free slots are dropped
    u_cand_o = torch.where(via_o <= best_o, ov_src, n)
    _min_drop_(u_best, ov_dst, u_cand_o)
    reached = torch.isfinite(dist) & (u_best < n)
    pred = torch.where(reached, u_best, -1).to(torch.int32)
    pred[source] = -1
    return pred


# ---------------------------------------------------------------------------
# full solves on dynamic operands
# ---------------------------------------------------------------------------

def sssp_frontier_dynamic(ops: dict, source: int, *, n: int,
                          max_sweeps: int | None = None,
                          delta: float | None = None):
    """Cold frontier solve on dynamic operands (the repair benchmark's full
    re-solve, and the first solve a repair chains from).  Returns ``(dist,
    pred, sweeps, edges_relaxed, converged)``, pred over base and overlay
    arcs."""
    dist0 = _start(n, source, ops["out_w"].device)
    dist, sweeps, edges, conv = frontier_fixpoint(
        ops, dist0, dist0 < torch.inf, n=n,
        sweep=make_dynamic_flat_sweep_fn(),
        cap=sweep_cap(n, delta, max_sweeps), delta=delta)
    pred = predecessors_from_dist_dynamic(dist, ops, source)
    return dist, pred, sweeps, edges, conv


def solve_dynamic(dyn: DynamicGraph, source: int, *,
                  delta: float | None = None, device="cuda") -> SsspResult:
    """Full frontier solve of the current version of ``dyn`` on ``device``,
    with no container rebuilt: the exact fixpoint of ``dyn.snapshot()``."""
    d, p, s, e, c = sssp_frontier_dynamic(
        dyn.dyn_ops(device=device), int(source), n=dyn.n, delta=delta)
    return SsspResult(d.cpu().numpy(), p.cpu().numpy(), s,
                      "frontier_dynamic", edges_relaxed=e,
                      sources=np.asarray([int(source)], np.int32),
                      converged=c)


# ---------------------------------------------------------------------------
# the repair engine
# ---------------------------------------------------------------------------

def sssp_repair(ops: dict, dist_old: torch.Tensor, pred_old: torch.Tensor,
                source: int, seed_heads: torch.Tensor, upd_src: torch.Tensor,
                upd_dst: torch.Tensor, upd_w: torch.Tensor, *, n: int,
                max_sweeps: int | None = None, delta: float | None = None):
    """Repair ``(dist_old, pred_old)``, a fixpoint of the previous version,
    into the fixpoint of the operands' current version.

    seed_heads: int64 heads of increased or deleted tree arcs
        (``pred_old[head] == tail``);
    upd_src / upd_dst / upd_w: decreased or inserted arcs ``(u, v,
        w_new)``, int64 / int64 / float32.  Entries equal to n are dropped.

    Returns ``(dist, pred, sweeps, edges_relaxed, cone, converged)``:
    dist and pred bitwise equal to a cold solve on the mutated graph,
    ``cone`` the invalidated cone's population, ``converged`` False iff
    ``max_sweeps=`` cut the push short.
    """
    dev = dist_old.device
    inf = torch.inf
    idx = torch.arange(n, device=dev)
    # --- invalidated cone: pred-tree descendants of the seed heads, by
    # pointer doubling (after k rounds aff[v] sees ancestors within 2**k).
    aff = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    aff[seed_heads] = True                   # the drop id n lands past n - 1
    aff = aff[:n]
    anc = torch.where(pred_old >= 0, pred_old.long(), idx)
    for _ in range(max(1, math.ceil(math.log2(max(n, 2))))):
        aff, anc = aff | aff[anc], anc[anc]
    aff &= (idx != source) & torch.isfinite(dist_old)
    dist1 = torch.where(aff, inf, dist_old)
    # --- decrease / insert seeds: one scatter-min at the modified heads.
    dist2 = _min_drop_(dist1.clone(), upd_dst, dist1[upd_src] + upd_w)
    # --- pull the cone's boundary support over its incoming windows; cone
    # sources carry INF, so only live labels contribute.
    fids = torch.nonzero(aff).flatten()                # host sync
    ip = ops["in_indptr"]
    starts = ip[fids]
    degs = ip[fids + 1] - starts
    csum = torch.cumsum(degs, 0)
    E0 = csum[-1] if fids.numel() else csum.new_zeros(())
    dist3 = pull_edge_slots(dist2, fids, dist2, starts, csum - degs, E0,
                            ops["src"], ops["w"])
    ov_src, ov_dst = ops["ov_src"], ops["ov_dst"]
    into_cone = aff[ov_dst.clamp(max=n - 1)] & (ov_dst < n)
    _min_drop_(dist3, ov_dst,
               torch.where(into_cone, dist2[ov_src] + ops["ov_w"], inf))
    # --- one shared push from everything that moved below its reset.
    dist, sweeps, edges, conv = frontier_fixpoint(
        ops, dist3, dist3 < dist1, n=n, sweep=make_dynamic_flat_sweep_fn(),
        cap=sweep_cap(n, delta, max_sweeps), delta=delta, edges0=E0)
    pred = predecessors_from_dist_dynamic(dist, ops, source)
    return dist, pred, sweeps, edges, fids.numel(), conv


@dataclasses.dataclass(frozen=True)
class RepairStats:
    """Work accounting of one repair call (result fields aside)."""

    cone: int            # invalidated-cone population (0 for pure decreases)
    seeds: int           # increase/delete tree-arc heads submitted
    updates: int         # decrease/insert arc candidates submitted
    shortcut: bool       # batch provably couldn't change this source's row


def repair_sssp(dyn: DynamicGraph, prev: SsspResult, batch: MutationBatch,
                *, delta: float | None = None,
                device="cuda") -> "tuple[SsspResult, RepairStats]":
    """Expand ``batch``'s edge deltas into per-arc repair seeds against
    ``prev`` (solved on the pre-batch version), run :func:`sssp_repair` on
    ``dyn``'s current operands on ``device``, and wrap the result.  ``prev``
    must carry dist and pred of one source row (any engine's result: pred
    trees differ only in ties, and any tight tree gives a sound cone).

    When no delta can touch the row — no decrease and no increase of a
    tree arc — ``prev`` is still exact and is returned as it is
    (``stats.shortcut``).  The JAX engine pads the seed and update arrays to
    powers of two to keep its jit shapes; nothing here is compiled per
    shape, so they go unpadded, which changes no count.
    """
    if prev.pred is None:
        raise ValueError("repair needs prev.pred (the cone walks the "
                         "predecessor tree); recover it first")
    dist_old = np.asarray(prev.dist, np.float32)
    pred_old = np.asarray(prev.pred, np.int32)
    if dist_old.ndim != 1:
        raise ValueError("repair_sssp repairs one source row at a time")
    source = (int(prev.sources[0]) if prev.sources is not None
              else int(np.argmin(dist_old)))
    seeds: list[int] = []
    upds: list[tuple] = []
    for r in batch.records:
        arcs = ((r.u, r.v),) if dyn.directed else ((r.u, r.v), (r.v, r.u))
        for a, b in arcs:
            if r.w_new > r.w_old or (np.isinf(r.w_new)
                                     and not np.isinf(r.w_old)):
                if pred_old[b] == a:       # only tree arcs invalidate
                    seeds.append(b)
            elif r.w_new < r.w_old or (np.isinf(r.w_old)
                                       and not np.isinf(r.w_new)):
                upds.append((a, b, np.float32(r.w_new)))
    if not seeds and not upds:
        return prev, RepairStats(cone=0, seeds=0, updates=0, shortcut=True)
    dev = resolve_device(device)
    ops = dyn.dyn_ops(device=dev)
    i64 = torch.int64
    us, ud, uw = (zip(*upds) if upds else ((), (), ()))
    d, p, s, e, cone, conv = sssp_repair(
        ops, torch.tensor(dist_old, device=dev),
        torch.tensor(pred_old, device=dev), source,
        torch.tensor(seeds, dtype=i64, device=dev),
        torch.tensor(us, dtype=i64, device=dev),
        torch.tensor(ud, dtype=i64, device=dev),
        torch.tensor(uw, dtype=torch.float32, device=dev), n=dyn.n,
        delta=delta)
    res = SsspResult(d.cpu().numpy(), p.cpu().numpy(), s, "repair",
                     edges_relaxed=e,
                     sources=np.asarray([source], np.int32), converged=conv)
    return res, RepairStats(cone=cone, seeds=len(seeds), updates=len(upds),
                            shortcut=False)


def row_affected(dist_row: np.ndarray, batch: MutationBatch,
                 directed: bool = False) -> bool:
    """Conservative host-side test: can ``batch`` change this solved row at
    all?  A decrease matters iff it improves some head (``dist[u] + w_new <
    dist[v]`` in float32, the engines' arithmetic); an increase matters iff
    the old arc was tight (``dist[u] + w_old == dist[v]``): a slack arc
    never attains the min.  False means the row is still the exact fixpoint
    of the mutated graph."""
    d = np.asarray(dist_row, np.float32)
    for r in batch.records:
        arcs = ((r.u, r.v),) if directed else ((r.u, r.v), (r.v, r.u))
        for a, b in arcs:
            if np.isfinite(r.w_new) and (r.w_new < r.w_old
                                         or np.isinf(r.w_old)):
                if np.float32(d[a] + np.float32(r.w_new)) < d[b]:
                    return True
            if np.isfinite(r.w_old) and (r.w_new > r.w_old
                                         or np.isinf(r.w_new)):
                if np.isfinite(d[a]) and (
                        np.float32(d[a] + np.float32(r.w_old)) == d[b]):
                    return True
    return False
