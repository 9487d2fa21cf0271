"""Plain PyTorch versions of the relax sweep.

Min-plus over an explicit edge list is exact in f32 (adds and compares
only), so the CUDA kernel must agree with these bitwise, and the ELL, CSR
and flat-arc forms agree with each other: they enumerate the same
candidates.
"""
from __future__ import annotations

import torch


def ell_relax_ref(dist: torch.Tensor, ell_idx: torch.Tensor,
                  ell_w: torch.Tensor) -> torch.Tensor:
    """One sweep over padded-ELL rows (the TPU kernel's operand).
    (n,), (n, K), (n, K) -> (n,).

    new[v] = min(dist[v], min_k dist[ell_idx[v, k]] + ell_w[v, k])

    Padding slots are (0, INF): dist[0] + INF == INF never wins.
    """
    cand = (dist[ell_idx] + ell_w).amin(dim=1)
    return torch.minimum(dist, cand)


def ell_relax_csr_ref(dist: torch.Tensor, indptr: torch.Tensor,
                      indices: torch.Tensor, weights: torch.Tensor, *,
                      row_base: int = 0) -> torch.Tensor:
    """The same sweep over the incoming CSR (the CUDA kernel's operand): a
    segment-min of the arcs' candidates between the row offsets, folded
    with the self-distance.  (n,), (n+1,), (m,), (m,) -> (n,).  With a
    ``row_base`` the R rows of the CSR are the labels ``dist[row_base:
    row_base + R]`` and the result is (R,)."""
    rows = indptr.shape[0] - 1
    via = dist[indices.long()] + weights
    own = dist.narrow(0, row_base, rows)
    return own.scatter_reduce(0, row_ids(indptr, indices.shape[0]), via,
                              "amin")


def row_ids(indptr: torch.Tensor, m: int) -> torch.Tensor:
    """(m,) int64 row of each arc of a CSR with row offsets ``indptr``
    (``m`` given, so no device sync)."""
    n = indptr.shape[0] - 1
    return torch.repeat_interleave(torch.arange(n, device=indptr.device),
                                   (indptr[1:] - indptr[:-1]).long(),
                                   output_size=m)


def segment_relax_ref(dist: torch.Tensor, src_ids: torch.Tensor,
                      dst_ids: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """The same sweep as a scatter-min over flat CSR arcs (the engine's
    O(m) formulation), folded with the self-distance."""
    via = dist[src_ids] + weights
    return dist.scatter_reduce(0, dst_ids.long(), via, "amin")
