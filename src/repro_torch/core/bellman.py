"""Relax-to-fixpoint SSSP on the dense adjacency matrix — the paper's
Algorithm 3/4 (port of the single-device part of repro/core/bellman.py).

One sweep computes, for every v,

    new_dist[v] = min(dist[v], min_u (dist[u] + A[u, v]))

a min-plus matrix-vector product.  The plain sweep takes the contraction a
block of u rows at a time (kernels/sssp_relax/ref.py), so no (n, n)
candidate matrix is ever built; the kernel path (engine
``bellman_kernel``) swaps ``sweep_fn`` for the CUDA matvec.  The fixpoint
loop reads one flag back to the host per sweep.

``use_frontier`` masks the rows whose label did not improve last sweep to
INF, so they contribute nothing; the dense layout stays.

``sssp_bellman_sharded`` distributes the fixpoint over the ranks of a
:class:`~repro_torch.core._dist.ShardGroup`: each rank relaxes its own
column block and ONE all-gather a sweep reassembles the distance vector —
one collective a sweep (about the hop diameter of them) against
Dijkstra's one MINLOC a vertex, the better-grained synchronization the
paper's §V.2 asks for.  Its local min-plus is plain torch ops, as JAX's
is.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.sssp_relax.ref import relax_sweep_ref

#: candidates per block of u rows in the predecessor recovery (256 MB f32)
_PRED_BLOCK_ELEMS = 1 << 26


def _sweep_blocked(dist: torch.Tensor, adj: torch.Tensor,
                   block: int) -> torch.Tensor:
    """The sweep with the contraction blocked over ``block`` rows of u —
    same math, a (block, n) live intermediate."""
    return relax_sweep_ref(dist, adj, block=block)


def sssp_bellman(
    adj: torch.Tensor,
    source: int,
    *,
    sweep_fn: Optional[Callable] = None,
    max_sweeps: int | None = None,
    use_frontier: bool = False,
):
    """Fixpoint SSSP (paper Alg. 3).  Returns ``(dist, pred, num_sweeps)``.

    ``sweep_fn(dist, adj) -> new_dist`` lets the CUDA kernel
    (kernels/sssp_relax/ops.py) replace the plain sweep.  The loop runs
    while ``sweeps < cap`` and the last sweep changed something.
    """
    n = adj.shape[0]
    cap = n if max_sweeps is None else max_sweeps
    sweep = sweep_fn or relax_sweep_ref
    inf = torch.tensor(torch.inf, dtype=adj.dtype, device=adj.device)
    dist = torch.full((n,), torch.inf, dtype=adj.dtype, device=adj.device)
    dist[source] = 0.0
    frontier = dist < inf
    changed, sweeps = n > 0, 0        # the start differs from "no previous"
    while sweeps < cap and changed:
        src = torch.where(frontier, dist, inf) if use_frontier else dist
        new = torch.minimum(sweep(src, adj), dist)   # monotone under masking
        if use_frontier:
            frontier = new < dist
        changed = bool((new != dist).any())
        dist, sweeps = new, sweeps + 1
    return dist, predecessors_from_dist(dist, adj, source), sweeps


def sssp_bellman_sharded(adj_loc: torch.Tensor, source: int, group, *,
                         max_sweeps: int | None = None):
    """Distributed fixpoint SSSP: columns sharded over ``group``, the
    distance vector replicated.  ``adj_loc`` is this rank's (n_pad, loc_n)
    column block of the padded matrix (``Graph.padded(P)``).  Each sweep is
    a local (n_pad, loc_n) min-plus matvec and one tiled all-gather.
    Returns ``(dist (n_pad,), pred (n_pad,) int32, sweeps)`` on every rank;
    pred comes from each owner's block at the fixpoint, diagonal masked.

    The loop is :func:`sharded_start`, :func:`sharded_sweep` while it
    changes something, then :func:`sharded_finish`."""
    n_pad = _check_slab(adj_loc, group)
    cap = n_pad if max_sweeps is None else max_sweeps
    dist = sharded_start(adj_loc, source)
    changed, sweeps = True, 0         # the start differs from "no previous"
    while sweeps < cap and changed:
        dist, changed_t = sharded_sweep(dist, adj_loc, group)
        changed, sweeps = bool(changed_t), sweeps + 1
    return (*sharded_finish(dist, adj_loc, source, group), sweeps)


def _check_slab(adj_loc: torch.Tensor, group) -> int:
    n_pad, loc_n = adj_loc.shape
    if n_pad != loc_n * group.size:
        raise ValueError(f"a ({n_pad}, {loc_n}) slab is not 1/{group.size} "
                         f"of the padded matrix's columns")
    return n_pad


def sharded_start(adj_loc: torch.Tensor, source: int) -> torch.Tensor:
    """The replicated start labels of :func:`sssp_bellman_sharded`."""
    dist = torch.full((adj_loc.shape[0],), torch.inf, dtype=adj_loc.dtype,
                      device=adj_loc.device)
    dist[source] = 0.0
    return dist


def sharded_sweep(dist: torch.Tensor, adj_loc: torch.Tensor, group):
    """One sweep of :func:`sssp_bellman_sharded`: this rank's min-plus
    matvec over its column block and one all-gather.  Returns the new
    replicated labels and a 0-dim bool tensor, whether any changed (left
    on the device: the caller reads it)."""
    loc_n = adj_loc.shape[1]
    v_base = group.rank * loc_n
    mine = dist[v_base:v_base + loc_n]
    new = group.all_gather(relax_sweep_ref(dist, adj_loc, own=mine))
    return new, (new != dist).any()


def sharded_finish(dist: torch.Tensor, adj_loc: torch.Tensor, source: int,
                   group):
    """``(dist, pred)`` of :func:`sssp_bellman_sharded` at the fixpoint:
    each owner's predecessors over its block, all-gathered."""
    v_base = group.rank * adj_loc.shape[1]
    pred = predecessors_from_dist(dist, adj_loc, source, col_base=v_base)
    return dist, group.all_gather(pred)


def predecessors_from_dist(dist: torch.Tensor, adj: torch.Tensor,
                           source: int, *, col_base: int = 0) -> torch.Tensor:
    """pred[] at the fixpoint: ``pred[v] = argmin_u dist[u] + A[u, v]``
    (int32), lowest u on ties, as JAX's argmin.

    The diagonal is masked out (it always ties the fixpoint minimum and
    would give pred[v] == v).  The argmin runs over blocks of u rows with a
    running (min, argmin) that only a strictly smaller block minimum
    replaces, so the lowest u still wins ties and no (n, n) matrix is
    built.  Unreached vertices and the source get -1.  A valid tree
    whenever weights are strictly positive.

    ``adj`` may be a column block (n, C) whose column c is vertex
    ``col_base + c`` (a rank's slab); the result is then those C entries.
    """
    n, C = adj.shape
    dev = adj.device
    step = max(1, _PRED_BLOCK_ELEMS // max(1, C))
    best = torch.full((C,), torch.inf, dtype=dist.dtype, device=dev)
    u_best = torch.zeros((C,), dtype=torch.int64, device=dev)
    for u0 in range(0, n, step):
        u1 = min(n, u0 + step)
        via = dist[u0:u1, None] + adj[u0:u1]
        # no self-predecessors: row r of the block is vertex u0 + r, the
        # column of that vertex u0 + r - col_base
        r0, r1 = max(0, col_base - u0), min(u1 - u0, col_base + C - u0)
        if r0 < r1:
            rows = torch.arange(r0, r1, device=dev)
            via[rows, rows + (u0 - col_base)] = torch.inf
        m, idx = torch.min(via, dim=0)
        better = m < best
        best = torch.where(better, m, best)
        u_best = torch.where(better, idx + u0, u_best)
    own = dist[col_base:col_base + C]
    pred = torch.where(torch.isfinite(own), u_best, -1).to(torch.int32)
    if 0 <= source - col_base < C:
        pred[source - col_base] = -1
    return pred
