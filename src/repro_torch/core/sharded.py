"""Column-parallel Dijkstra — the paper's Algorithm 2, its MPI version (port
of repro/core/sharded.py) on ``torch.distributed``.

The paper 1-D-partitions the adjacency matrix by *columns* across P
processes (each owns n/P vertices), pads n to a multiple of P, and each
iteration takes a local argmin over the unvisited owned vertices, a global
``MPI_Allreduce(MINLOC)``, then relaxes the owned column block from the
winner's row.  Here the P processes are the ranks of a
:class:`~repro_torch.core._dist.ShardGroup`; each holds its ``(n_pad,
loc_n)`` column slab only, and the MINLOC is one of three collectives:

* :func:`minloc_allgather` — all-gathers of the P (distance, index)
  candidates and a deterministic argmin (the baseline);
* :func:`minloc_pmin` — two min-all-reduces, O(1) payload;
* :func:`minloc_packed` — one all-gather of the f32 bit pattern and the
  index packed together.

All three break ties toward the smallest global index, as the serial
argmin does, and an unreachable local candidate carries the index
``INT32_MAX`` so it never wins a tie at INF against a lower index.  The
chosen vertex and its label stay on the device: the loop never waits for
the host beyond what the collective itself forces.  The result is gathered
at the end (the paper's ``MPI_Gather``) and returned on every rank.
"""
from __future__ import annotations

from typing import Literal

import torch

INT32_MAX = 2**31 - 1
#: the packed variant's tie-break sentinel: above every int32 index
_U32_MAX = 0xFFFFFFFF

MinlocImpl = Literal["allgather", "pmin", "packed"]


def minloc_allgather(d: torch.Tensor, idx: torch.Tensor, group):
    """MINLOC by all-gathering the P candidates: the smallest distance and,
    among equal distances, the smallest index.  ``d`` is a 0-dim f32 and
    ``idx`` a 0-dim int64 tensor; returns the same."""
    ds = group.all_gather(d.view(1))
    idxs = group.all_gather(idx.view(1))
    best = ds.min()
    cand = torch.where(ds == best, idxs, INT32_MAX)
    return best, cand.min()


def minloc_pmin(d: torch.Tensor, idx: torch.Tensor, group):
    """MINLOC by two min-all-reduces (latency 2α, O(1) payload): the first
    finds the winning distance, the second the smallest index whose local
    candidate equals it."""
    best = group.all_reduce(d.view(1).clone(), "min")[0]
    cand = torch.where(d == best, idx, INT32_MAX).view(1)
    return best, group.all_reduce(cand, "min")[0]


def minloc_packed(d: torch.Tensor, idx: torch.Tensor, group):
    """MINLOC in one collective.  Non-negative f32 distances (INF
    included) order as their IEEE-754 bit patterns read as u32, so one
    all-gather of ``[bits, index]`` pairs and two mins give the distance
    and the smallest index among its ties.  The u32 values ride in int64
    (not every backend carries uint32); the sentinel 0xFFFFFFFF is above
    every int32 index, so it loses to ``INT32_MAX``."""
    bits = d.view(1).view(torch.int32).long() & _U32_MAX
    packed = torch.cat([bits, idx.view(1).long()])
    allp = group.all_gather(packed).view(-1, 2)
    best_bits = allp[:, 0].min()
    cand = torch.where(allp[:, 0] == best_bits, allp[:, 1], _U32_MAX)
    best = best_bits.to(torch.int32).view(1).view(torch.float32)[0]
    return best, cand.min()


_MINLOC = {"allgather": minloc_allgather, "pmin": minloc_pmin,
           "packed": minloc_packed}


def dijkstra_sharded(adj_loc: torch.Tensor, source: int, group, *,
                     n_true: int | None = None,
                     minloc: MinlocImpl = "allgather"):
    """Parallel Dijkstra over ``group`` (paper Alg. 2).

    adj_loc: (n_pad, loc_n) this rank's column block of the padded
             adjacency (``Graph.padded(P)``), columns ``[rank * loc_n,
             (rank + 1) * loc_n)``, on the group's device.
    n_true:  the true vertex count; the loop runs that many iterations, as
             the paper's ``for i in 0..n-1`` (padding vertices are
             INF-isolated and never win).
    Returns ``(dist (n_pad,), pred (n_pad,) int32)`` on every rank; valid
    entries are ``[:n_true]``.
    """
    n_pad, loc_n = adj_loc.shape
    if n_pad != loc_n * group.size:
        raise ValueError(f"a ({n_pad}, {loc_n}) slab is not 1/{group.size} "
                         f"of the padded matrix's columns")
    iters = int(n_pad if n_true is None else n_true)
    carry = dijkstra_start(adj_loc, source, group)
    for _ in range(iters):
        carry = dijkstra_iteration(carry, adj_loc, group, minloc=minloc)
    return dijkstra_finish(carry, group)


def dijkstra_start(adj_loc: torch.Tensor, source: int, group) -> tuple:
    """The carry of :func:`dijkstra_sharded`'s loop before its first
    iteration: this rank's ``(labels, predecessors, visited)`` over its
    owned columns, then the loop's constants (the column ids, INF and
    the index sentinel on the device, made once)."""
    loc_n, dev = adj_loc.shape[1], adj_loc.device
    cols = torch.arange(loc_n, device=dev)
    inf = torch.tensor(torch.inf, dtype=adj_loc.dtype, device=dev)
    sentinel = torch.tensor(INT32_MAX, dtype=torch.int64, device=dev)
    loc_dist = torch.where(cols + group.rank * loc_n == source, 0.0, inf)
    loc_pred = torch.full((loc_n,), -1, dtype=torch.int32, device=dev)
    visited = torch.zeros(loc_n, dtype=torch.bool, device=dev)
    return loc_dist, loc_pred, visited, cols, inf, sentinel


def dijkstra_iteration(carry: tuple, adj_loc: torch.Tensor, group, *,
                       minloc: MinlocImpl = "allgather") -> tuple:
    """One iteration of :func:`dijkstra_sharded` (the paper's loop body):
    the local argmin, the global MINLOC, the owner's visit and the
    relaxation of the owned columns.  Returns the next carry."""
    loc_dist, loc_pred, visited, cols, inf, sentinel = carry
    n_pad, loc_n = adj_loc.shape
    v_base = group.rank * loc_n
    # local argmin over the unvisited owned vertices (lowest index)
    masked = torch.where(visited, inf, loc_dist)
    loc_arg = torch.argmin(masked)
    loc_min = masked.index_select(0, loc_arg.view(1))[0]  # no host read
    loc_u = torch.where(torch.isfinite(loc_min), loc_arg + v_base, sentinel)
    # the global MINLOC: the paper's MPI_Allreduce
    du, u = _MINLOC[minloc](loc_min, loc_u, group)
    u_safe = u.clamp(0, n_pad - 1)
    # the owner marks u visited
    is_mine = ((u_safe >= v_base) & (u_safe < v_base + loc_n)
               & torch.isfinite(du))
    visited |= (cols == u_safe - v_base) & is_mine
    # relax the owned columns from row u
    cand = du + adj_loc.index_select(0, u_safe.view(1))[0]
    better = (cand < loc_dist) & ~visited
    loc_dist = torch.where(better, cand, loc_dist)
    loc_pred = torch.where(better, u.to(torch.int32), loc_pred)
    return loc_dist, loc_pred, visited, cols, inf, sentinel


def dijkstra_finish(carry: tuple, group) -> tuple:
    """``(dist, pred)`` of :func:`dijkstra_sharded` from the loop's last
    carry: the owned blocks gathered (the paper's ``MPI_Gather``)."""
    loc_dist, loc_pred = carry[:2]
    return group.all_gather(loc_dist), group.all_gather(loc_pred)
