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
                       out_w: torch.Tensor,
                       fell: torch.Tensor) -> torch.Tensor:
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
    """
    n = dist.shape[0]
    ip = out_indptr.long()
    m = int(ip[n])
    deg = ip[1:n + 1] - ip[:n]
    arc_src = torch.repeat_interleave(
        torch.arange(n, device=dist.device), deg, output_size=m)
    f = fids.long()
    on = torch.zeros(n, dtype=torch.bool, device=dist.device)
    on[f[(f >= 0) & (f < n)]] = True
    snap = dist.clone()
    cand = torch.where(on[arc_src], snap[arc_src] + out_w[:m], torch.inf)
    new = snap.scatter_reduce(0, out_dst[:m].long(), cand, "amin")
    fell |= new < snap
    dist.copy_(new)
    return fell
