"""Relax-to-fixpoint SSSP over sparse CSR edges — O(m) per sweep (port of
repro/core/bellman_csr.py).

    via[e]  = dist[src[e]] + w[e]                 (one add per edge)
    new[v]  = min(dist[v], min_{e: dst[e] = v} via[e])

The per-vertex min is ``scatter_reduce(..., "amin")`` onto the distance
vector itself, the stand-in for the CUDA kernel's ``atomicMin`` over
incoming edges: min does not depend on order, so the result is exact and
deterministic.  Vertices with no in-arcs keep their own label.

The kernel path (engine ``bellman_csr_kernel``) swaps ``sweep_fn`` for the
incoming-CSR CUDA kernel in kernels/csr_relax.  The fixpoint loop reads one
flag back to the host per sweep.  ``sssp_multisource_csr`` is the batched
twin: S sources share one gather of the edge arrays per sweep.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.multisource import init_dist


def csr_operands(cg, *, device, with_in_csr: bool = False) -> dict:
    """Stage a core.csr.CsrGraph's arrays on ``device``, as copies: src and
    dst as int64 (scatter indices), w as float32.  ``with_in_csr`` adds the
    int32 incoming CSR the relax kernel consumes with ``w``: row offsets
    ``in_indptr`` (n+1,) and sources ``in_src`` (nnz,), both converted on
    the device from the one copy of each host array."""
    src = torch.tensor(cg.indices, device=device)
    ops = {
        "src": src.long(),
        "dst": torch.tensor(cg.dst_ids(), device=device).long(),
        "w": torch.tensor(cg.weights, device=device),
    }
    if with_in_csr:
        ops["in_indptr"] = torch.tensor(cg.indptr, device=device).int()
        ops["in_src"] = src
    return ops


def segment_relax_sweep(dist: torch.Tensor, ops: dict) -> torch.Tensor:
    """One O(m) relax sweep: per-vertex min over incoming-edge candidates,
    folded with the self-distance (the sweep-fn contract)."""
    via = dist[ops["src"]] + ops["w"]
    return dist.scatter_reduce(0, ops["dst"], via, "amin")


def _start(n: int, source: int, device) -> torch.Tensor:
    dist = torch.full((n,), torch.inf, dtype=torch.float32, device=device)
    dist[source] = 0.0
    return dist


def sssp_bellman_csr(
    ops: dict,
    source: int,
    *,
    n: int,
    sweep_fn: Optional[Callable] = None,
    max_sweeps: int | None = None,
):
    """Fixpoint SSSP on CSR operands.  Returns
    ``(dist, pred, num_sweeps, converged)``.

    ``sweep_fn(dist, ops) -> new_dist`` (self-distance folded in) lets the
    relax kernel replace the scatter-min path.  The loop runs while
    ``sweeps < cap`` and the last sweep changed something; ``converged`` is
    True iff it stopped because nothing changed (False only under a tight
    ``max_sweeps=``: the labels may then sit above their fixpoint).
    """
    cap = n if max_sweeps is None else max_sweeps
    sweep = sweep_fn or segment_relax_sweep
    dist = _start(n, source, ops["w"].device)
    changed, sweeps = n > 0, 0        # the start differs from "no previous"
    while sweeps < cap and changed:
        new = torch.minimum(sweep(dist, ops), dist)
        changed = bool((new != dist).any())
        dist, sweeps = new, sweeps + 1
    pred = predecessors_from_dist_csr(dist, ops, source)
    return dist, pred, sweeps, not changed


def segment_relax_sweep_multi(D: torch.Tensor, ops: dict) -> torch.Tensor:
    """Batched O(S·m) relax sweep over a (S, n) distance matrix: one gather
    of the edge index arrays serves all S sources; each row equals an
    independent ``segment_relax_sweep``."""
    via = D[:, ops["src"]] + ops["w"]
    return D.scatter_reduce(1, ops["dst"].expand_as(via), via, "amin")


def sssp_multisource_csr(
    ops: dict,
    sources: torch.Tensor,
    *,
    n: int,
    sweep_fn: Optional[Callable] = None,
    max_sweeps: int | None = None,
):
    """Batched fixpoint SSSP from S sources.  Returns ``(D (S, n), sweeps,
    converged)``; the sweep count is the max over sources and ``converged``
    the joint flag."""
    cap = n if max_sweeps is None else max_sweeps
    sweep = sweep_fn or segment_relax_sweep_multi
    D = init_dist(n, sources, ops["w"].dtype)
    changed, sweeps = D.numel() > 0, 0
    while sweeps < cap and changed:
        new = torch.minimum(sweep(D, ops), D)
        changed = bool((new != D).any())
        D, sweeps = new, sweeps + 1
    return D, sweeps, not changed


def predecessors_from_dist_csr(dist: torch.Tensor, ops: dict,
                               source: int) -> torch.Tensor:
    """pred[] at the fixpoint from the edge list (int32).

    Every reachable v != source has an incoming arc (u, w) with dist[v] ==
    dist[u] + w; among those the lowest u wins — the dense argmin's
    tie-break, at O(m).  Vertices with no attaining arc (no in-arcs,
    unreachable) get -1, as does the source.  A valid tree whenever weights
    are strictly positive.
    """
    n = dist.shape[0]
    src, dst = ops["src"], ops["dst"]
    via = dist[src] + ops["w"]
    best = torch.full_like(dist, torch.inf).scatter_reduce(0, dst, via, "amin")
    attains = via <= best[dst]
    u_cand = torch.where(attains, src, n)
    u_best = torch.full((n,), n, dtype=torch.int64,
                        device=dist.device).scatter_reduce(0, dst, u_cand,
                                                           "amin")
    reached = torch.isfinite(dist) & (u_best < n)
    pred = torch.where(reached, u_best, -1).to(torch.int32)
    pred[source] = -1
    return pred
