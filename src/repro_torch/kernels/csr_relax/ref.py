"""Plain PyTorch versions of the padded-ELL relax kernel.

Min-plus over an explicit edge list is exact in f32 (adds and compares
only), so the CUDA kernel must agree with these bitwise, and the ELL and
flat-CSR forms agree with each other: they enumerate the same candidates.
"""
from __future__ import annotations

import torch


def ell_relax_ref(dist: torch.Tensor, ell_idx: torch.Tensor,
                  ell_w: torch.Tensor) -> torch.Tensor:
    """One sweep over padded-ELL rows. (n,), (n, K), (n, K) -> (n,).

    new[v] = min(dist[v], min_k dist[ell_idx[v, k]] + ell_w[v, k])

    Padding slots are (0, INF): dist[0] + INF == INF never wins.
    """
    cand = (dist[ell_idx] + ell_w).amin(dim=1)
    return torch.minimum(dist, cand)


def segment_relax_ref(dist: torch.Tensor, src_ids: torch.Tensor,
                      dst_ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """The same sweep as a scatter-min over flat CSR arcs (the engine's
    O(m) formulation), folded with the self-distance."""
    via = dist[src_ids] + weights
    return dist.scatter_reduce(0, dst_ids.long(), via, "amin")
