"""Plain PyTorch version of the in-place frontier push kernel.

Frontier relaxation is adds and mins over f32, exact like the other sweeps,
so the CUDA kernel must agree with this bitwise, and so must the flat
slot-walking sweep of core/frontier.py: all three scatter-min the same
candidate multiset into ``dist`` and flag the same fallen labels.
"""
from __future__ import annotations

import torch


def frontier_relax_ref(dist: torch.Tensor, fids: torch.Tensor,
                       out_indptr: torch.Tensor, out_dst: torch.Tensor,
                       out_w: torch.Tensor, fell: torch.Tensor, *,
                       flabels: torch.Tensor | None = None) -> torch.Tensor:
    """In place: ``dist[v] = min(dist[v], snap[u] + w)`` for every out-arc
    (u, v, w) of every frontier vertex ``u = fids[f]``, ``snap`` being
    ``dist`` before the call; ids outside [0, n) (the compaction sentinel
    n) are skipped.  ``fell[v]`` is set where ``dist[v] < snap[v]`` and
    left as it was elsewhere; returns ``fell``.

    Written uncompacted, as an independent check of the slot arithmetic:
    every out-arc of the graph is relaxed, and arcs whose source is not on
    the frontier contribute INF, which never wins.  The fallen labels come
    from comparing the whole vector with the snapshot, not from the
    scatter.

    With ``flabels`` the rows' labels are given (row f pushes
    ``flabels[f]``; an id listed twice pushes the smaller), the sources are
    the R rows of the out-CSR and ``dist`` is a block of targets, as in the
    kernel's explicit-label mode.
    """
    n = dist.shape[0]
    rows = n if flabels is None else out_indptr.shape[0] - 1
    ip = out_indptr.long()
    m = int(ip[rows])
    deg = ip[1:rows + 1] - ip[:rows]
    arc_src = torch.repeat_interleave(
        torch.arange(rows, device=dist.device), deg, output_size=m)
    f = fids.long()
    ok = (f >= 0) & (f < rows)
    snap = dist.clone()
    if flabels is None:
        on = torch.zeros(n, dtype=torch.bool, device=dist.device)
        on[f[ok]] = True
        lab = torch.where(on, snap, torch.inf)
    else:
        lab = torch.full((rows,), torch.inf, device=dist.device)
        lab.scatter_reduce_(0, f[ok], flabels[ok], "amin")
    cand = lab[arc_src] + out_w[:m]
    new = snap.scatter_reduce(0, out_dst[:m].long(), cand, "amin")
    fell |= new < snap
    dist.copy_(new)
    return fell
