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
``sssp_bellman_sharded`` belongs to the sharded slice of the port.
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


def predecessors_from_dist(dist: torch.Tensor, adj: torch.Tensor,
                           source: int) -> torch.Tensor:
    """pred[] at the fixpoint: ``pred[v] = argmin_u dist[u] + A[u, v]``
    (int32), lowest u on ties, as JAX's argmin.

    The diagonal is masked out (it always ties the fixpoint minimum and
    would give pred[v] == v).  The argmin runs over blocks of u rows with a
    running (min, argmin) that only a strictly smaller block minimum
    replaces, so the lowest u still wins ties and no (n, n) matrix is
    built.  Unreached vertices and the source get -1.  A valid tree
    whenever weights are strictly positive.
    """
    n = adj.shape[0]
    dev = adj.device
    step = max(1, _PRED_BLOCK_ELEMS // max(1, n))
    best = torch.full((n,), torch.inf, dtype=dist.dtype, device=dev)
    u_best = torch.zeros((n,), dtype=torch.int64, device=dev)
    for u0 in range(0, n, step):
        u1 = min(n, u0 + step)
        via = dist[u0:u1, None] + adj[u0:u1]
        rows = torch.arange(u1 - u0, device=dev)
        via[rows, rows + u0] = torch.inf         # no self-predecessors
        m, idx = torch.min(via, dim=0)
        better = m < best
        best = torch.where(better, m, best)
        u_best = torch.where(better, idx + u0, u_best)
    pred = torch.where(torch.isfinite(dist), u_best, -1).to(torch.int32)
    if n:
        pred[source] = -1
    return pred
