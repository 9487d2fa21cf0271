"""The plain reference: Bellman-Ford over the generator's raw edge list in
plain PyTorch, and connected components by hooking and pointer jumping.

It builds nothing from the program and imports nothing of it.  Each sweep
takes ``min(D[:, v], D[:, u] + w)`` over every arc in both orientations,
duplicates and self-loops included (a duplicate's least weight wins, a
self-loop never lowers a label), so its fixpoint is the least label of
every vertex over the float32 path sums from the root: the exact float32
distances every engine of the program must give bit for bit.  ``dtype``
other than float32 is the control, the same sweeps in a lower precision.
"""
from __future__ import annotations

import numpy as np
import torch

from sssp_bench.inputs import EdgeList


def _arcs(edges: EdgeList):
    return (torch.cat([edges.u, edges.v]), torch.cat([edges.v, edges.u]),
            torch.cat([edges.w, edges.w]))


def distances(edges: EdgeList, roots, *, dtype=torch.float32,
              chunk: int = 8, max_check: int = 64) -> np.ndarray:
    """``(len(roots), n)`` float32 distances from each root, solved ``chunk``
    roots at a time.  The loop reads its "anything changed" flag once every
    ``k`` sweeps, ``k`` doubling up to ``max_check`` (extra sweeps at the
    fixpoint change nothing)."""
    u, v, w = _arcs(edges)
    w = w.to(dtype)
    n = edges.n
    out = []
    roots = [int(r) for r in roots]
    for i in range(0, len(roots), chunk):
        rs = torch.tensor(roots[i:i + chunk], device=u.device)
        D = torch.full((len(rs), n), float("inf"), dtype=dtype,
                       device=u.device)
        D[torch.arange(len(rs), device=u.device), rs] = 0
        idx = v.expand(len(rs), -1)
        k = 1
        while True:
            before = D
            for _ in range(k):
                D = D.scatter_reduce(1, idx, D[:, u] + w, "amin")
            if torch.equal(D, before):
                break
            k = min(2 * k, max_check)
        out.append(D.float().cpu().numpy())
        del D, before, idx
    return np.concatenate(out) if out else np.zeros((0, n), np.float32)


def components(edges: EdgeList) -> torch.Tensor:
    """(n,) int64 component label of each vertex (the least-indexed vertex
    hooked so far in its component; equal labels iff connected)."""
    u, v, _ = _arcs(edges)
    lab = torch.arange(edges.n, device=u.device)
    while True:
        lu, lv = lab[u], lab[v]
        differ = lu != lv
        if not bool(differ.any()):
            return lab
        lo = torch.minimum(lu, lv)[differ]
        hi = torch.maximum(lu, lv)[differ]
        lab = lab.scatter_reduce(0, hi, lo, "amin")
        while True:
            jumped = lab[lab]
            if torch.equal(jumped, lab):
                break
            lab = jumped
