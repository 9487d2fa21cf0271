"""Public wrappers of the dense min-plus kernels.

The JAX wrappers pad n (and S) with INF to the block grid and fold
``min(dist, ·)`` around the kernel.  Here the kernels mask their ragged
tails themselves and already fold the self-distance in, so nothing is
padded or folded: the result is the same bit for bit (INF padding never
wins a min).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.sssp_relax import kernel as K


def relax_sweep(dist: torch.Tensor, adj: torch.Tensor,
                frontier: torch.Tensor | None = None, *,
                frontier_mode: bool = False) -> torch.Tensor:
    """One relaxation sweep through the kernel; bitwise equal to
    ref.relax_sweep_ref.  dist (n,), adj (n, n) -> (n,).  With
    ``frontier_mode`` a boolean ``frontier`` (n,) must be passed, and rows
    off it contribute nothing."""
    if frontier_mode:
        if frontier is None:
            raise ValueError("frontier_mode=True needs a frontier")
        return K.relax_matvec_frontier(dist, frontier, adj)
    return K.relax_matvec(dist, adj)


def relax_sweep_multi(D: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """Batched sweep through the kernel: D (S, n), adj (n, n) -> (S, n)."""
    return K.relax_matmul(D, adj)


def make_sweep_fn():
    """``sweep_fn(dist, adj)`` for core.bellman.sssp_bellman."""
    return relax_sweep
