"""Serial Dijkstra — the paper's Algorithm 1 (port of repro/core/serial.py).

The textbook O(n^2) loop: n iterations of (argmin over unvisited, mark
visited, relax the chosen row).  It is the baseline every parallel engine is
held against.  Predecessors are tracked as in Alg. 1 lines 13-14.
"""
from __future__ import annotations

import numpy as np
import torch


def dijkstra_serial(adj: torch.Tensor, source: int):
    """Single-source shortest paths on a dense adjacency matrix.

    adj: (n, n) float32, INF for missing edges; source: int.
    Returns (dist (n,), pred (n,) int32): pred[v] = -1 for source/unreached.
    The chosen vertex stays on the device (a 1-element index), so the loop
    never waits for the host.
    """
    n = adj.shape[0]
    dist = torch.full((n,), torch.inf, dtype=adj.dtype, device=adj.device)
    dist[source] = 0.0
    pred = torch.full((n,), -1, dtype=torch.int32, device=adj.device)
    visited = torch.zeros(n, dtype=torch.bool, device=adj.device)
    for _ in range(n):
        # Alg.1 line 9: u <- unvisited node with min dist (ties: lowest index)
        masked = torch.where(visited, torch.inf, dist)
        u = torch.argmin(masked).view(1)
        du = masked.index_select(0, u)
        visited.index_fill_(0, u, True)
        # Alg.1 lines 11-15: relax u's row; du == INF never improves.
        cand = du + adj.index_select(0, u)[0]
        better = (cand < dist) & ~visited
        dist = torch.where(better, cand, dist)
        pred = torch.where(better, u.to(torch.int32), pred)
    return dist, pred


def dijkstra_serial_np(adj, source):
    """Pure-numpy oracle of Alg. 1 (float64), an independent check."""
    n = adj.shape[0]
    dist = np.full((n,), np.inf, np.float64)
    pred = np.full((n,), -1, np.int64)
    visited = np.zeros((n,), bool)
    dist[source] = 0.0
    for _ in range(n):
        masked = np.where(visited, np.inf, dist)
        u = int(np.argmin(masked))
        if not np.isfinite(masked[u]):
            break
        visited[u] = True
        cand = dist[u] + adj[u].astype(np.float64)
        better = (cand < dist) & ~visited
        pred[better] = u
        dist = np.where(better, cand, dist)
    return dist, pred
