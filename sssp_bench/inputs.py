"""The inputs of a cell, made by the benchmark and handed to both sides:
the generator's undirected edge list (to the reference as it is) and the
incoming CSR built from it (to the program, through
``repro_torch.core.csr.from_arrays``)."""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch


@dataclasses.dataclass
class EdgeList:
    """An undirected edge list on one device: edge ``i`` joins ``u[i]`` and
    ``v[i]`` with weight ``w[i]`` (float32).  Duplicates and self-loops may
    be present: a duplicate's least weight wins, a self-loop is dropped,
    and neither changes a shortest distance.

    ``labels``, where the generator draws one fixed structure and the run's
    seed only relabels it, maps each vertex of that structure to its label
    in this run (so every seed solves an isomorphic graph); None where the
    seed draws the structure itself."""
    n: int
    u: torch.Tensor     # (M,) int64
    v: torch.Tensor     # (M,) int64
    w: torch.Tensor     # (M,) float32
    labels: Optional[np.ndarray] = None


def incoming_csr(edges: EdgeList) -> tuple:
    """The incoming CSR of ``edges`` with both orientations stored, built on
    the edge list's device and returned as numpy: ``(indptr (n+1,) int64,
    indices (nnz,) int32, weights (nnz,) float32)``, rows sorted by (dst,
    src), self-loops dropped, each duplicate arc at its least weight."""
    n = edges.n
    u = torch.cat([edges.u, edges.v])
    v = torch.cat([edges.v, edges.u])
    w = torch.cat([edges.w, edges.w])
    keep = u != v
    u, v, w = u[keep], v[keep], w[keep]
    key, order = torch.sort(v * n + u)
    w = w[order]
    del u, v, order
    uniq, inv = torch.unique_consecutive(key, return_inverse=True)
    del key
    wmin = torch.full((uniq.shape[0],), float("inf"), dtype=torch.float32,
                      device=w.device).scatter_reduce(0, inv, w, "amin")
    del inv, w
    dst = torch.div(uniq, n, rounding_mode="floor")
    src = (uniq - dst * n).to(torch.int32)
    counts = torch.bincount(dst, minlength=n)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=dst.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return (indptr.cpu().numpy(), src.cpu().numpy(), wmin.cpu().numpy())
