"""Cheap topology features for the cost model — the query-time view (the
port's copy of repro/tune/features.py, numpy only).

The per-engine log-linear fits (tune/model.py) need more than (n, m):
the frontier engine's sweep count tracks the graph's hop eccentricity
(a road grid takes ~200 sweeps where a random sparse graph takes ~10 at
the same size), and the Δ-routing profile tracks degree skew.  Both are
computable in one cheap numpy pass over the stored arcs plus one
level-synchronous BFS — the "degree skew" and "frontier width" axes of
the calibration design grid — and both are available at dispatch time,
unlike solve outcomes (sweeps, edges_relaxed), which a selector cannot
see before it selects.

Features are memoized on the graph instance (``CsrGraph._memo``, the
same seam ``delta_profile`` uses), so repeat routing of a pinned serving
handle costs a dict lookup.
"""
from __future__ import annotations

import numpy as np

__all__ = ["graph_features"]


def _bfs_profile(indptr: np.ndarray, src: np.ndarray, n: int) -> tuple:
    """Hop eccentricity of vertex 0 and mean frontier width, by
    level-synchronous BFS over the stored arcs treated as undirected
    (direction is irrelevant for a topology *feature*; exactness is an
    engine property, not a feature property).  O(hops · m) numpy work.
    """
    dst = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    src = np.asarray(src, dtype=np.int64)
    visited = np.zeros(n, dtype=bool)
    frontier = np.zeros(n, dtype=bool)
    visited[0] = frontier[0] = True
    hops = 0
    reached = 1
    while True:
        # arcs incident to the frontier, both orientations
        nxt = np.zeros(n, dtype=bool)
        nxt[dst[frontier[src]]] = True
        nxt[src[frontier[dst]]] = True
        nxt &= ~visited
        if not nxt.any():
            break
        visited |= nxt
        frontier = nxt
        hops += 1
        reached += int(nxt.sum())
    width = reached / max(hops, 1)
    return max(hops, 1), width, reached


def graph_features(cg) -> dict:
    """Topology features of a :class:`~repro_torch.core.csr.CsrGraph`:

    - ``n``, ``m``: vertex / stored-arc counts;
    - ``skew``: max in-degree over mean in-degree (>= 1.0) — the hub
      corpus scores high, road grids near 1;
    - ``hops``: BFS eccentricity of vertex 0 (undirected view) — the
      frontier engine's sweep count proxy;
    - ``width``: mean BFS frontier width (vertices reached per hop);
    - ``reached``: vertices in vertex 0's undirected component.

    Memoized per graph instance.
    """
    def build():
        n = int(cg.n)
        m = int(cg.nnz)
        indeg = np.diff(cg.indptr)
        mean_deg = max(float(indeg.mean()) if n else 0.0, 1e-9)
        skew = max(float(indeg.max(initial=0)) / mean_deg, 1.0)
        hops, width, reached = _bfs_profile(cg.indptr, cg.indices, n)
        return {"n": n, "m": m, "skew": skew, "hops": hops,
                "width": width, "reached": reached}

    return cg._memo("_tune_features", build)
