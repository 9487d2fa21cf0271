"""The Graph500 Kronecker generator (Graph500 specification, section
"Graph generation"; its reference ``kronecker_generator.m``), on the
device from the seed.

``2**scale`` vertices and ``edgefactor * 2**scale`` undirected edges.  Each
edge picks one quadrant of the adjacency matrix a level, ``scale`` levels:
the row bit is 1 with probability ``C + D``, the column bit then 1 with
probability ``B / (A + B)`` or ``D / (C + D)``.  Vertex labels are then
permuted, and weights are uniform in [0, 1).  The random numbers come from
one ``torch.Generator`` on the device, in a few large calls, so the same
seed gives the same graph on the same device.  Parameters: ``scale``,
``edgefactor``, ``A``, ``B``, ``C`` (``D = 1 - A - B - C``) and
``graph_seed``: where it is given, the graph is drawn from it, and the run's
seed draws only a permutation of the vertex labels, so every run solves an
isomorphic graph (``EdgeList.labels`` maps the drawn vertices to the run's
labels).
"""
from __future__ import annotations

import torch

from sssp_bench.inputs import EdgeList


def generate(params: dict, seed: int, device) -> EdgeList:
    if "graph_seed" not in params:
        return kronecker(params, seed, device)
    g = kronecker(params, int(params["graph_seed"]), device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    perm = torch.randperm(g.n, generator=gen, device=device)
    return EdgeList(n=g.n, u=perm[g.u], v=perm[g.v], w=g.w,
                    labels=perm.cpu().numpy())


def kronecker(params: dict, seed: int, device) -> EdgeList:
    """The specification's generator, every random number from ``seed``."""
    scale = int(params["scale"])
    n = 1 << scale
    m = int(params["edgefactor"]) * n
    a, b, c = float(params["A"]), float(params["B"]), float(params["C"])
    ab = a + b
    c_norm = c / (1.0 - ab)
    a_norm = a / ab
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    u = torch.zeros(m, dtype=torch.int64, device=device)
    v = torch.zeros(m, dtype=torch.int64, device=device)
    for level in range(scale):
        r = torch.rand((2, m), generator=gen, device=device)
        ii = r[0] > ab
        jj = r[1] > torch.where(ii, c_norm, a_norm)
        u += ii.to(torch.int64) << level
        v += jj.to(torch.int64) << level
        del r, ii, jj
    perm = torch.randperm(n, generator=gen, device=device)
    u, v = perm[u], perm[v]
    w = torch.rand(m, generator=gen, device=device)
    return EdgeList(n=n, u=u, v=v, w=w)
