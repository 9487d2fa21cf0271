"""Batched multi-source SSSP (port of the single-device part of
repro/core/multisource.py).

The min-plus sweep generalises to a min-plus matmul over a (S, n)
distance matrix: S sources share every read of the adjacency matrix.  The
fixpoint and each row equal running the paper's Alg. 3 once per source.
``sssp_multisource_sharded`` belongs to the sharded slice of the port.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.kernels.sssp_relax.ref import relax_sweep_multi_ref


def init_dist(n: int, sources: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(S, n) initial distance matrix: 0 at (s, sources[s]), INF elsewhere,
    on ``sources``' device."""
    cols = torch.arange(n, device=sources.device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=sources.device)
    return torch.where(cols == sources[:, None], zero, torch.inf).to(dtype)


def sssp_multisource(
    adj: torch.Tensor,
    sources: torch.Tensor,
    *,
    sweep_fn: Optional[Callable] = None,
    max_sweeps: int | None = None,
):
    """Fixpoint SSSP from S sources at once on the dense matrix.  Returns
    ``(D (S, n), sweeps)``.  ``sweep_fn(D, adj)`` lets the CUDA matmul
    (kernels/sssp_relax/ops.relax_sweep_multi) replace the plain sweep."""
    n = adj.shape[0]
    cap = n if max_sweeps is None else max_sweeps
    sweep = sweep_fn or relax_sweep_multi_ref
    D = init_dist(n, sources, adj.dtype)
    changed, sweeps = D.numel() > 0, 0
    while sweeps < cap and changed:
        new = torch.minimum(sweep(D, adj), D)
        changed = bool((new != D).any())
        D, sweeps = new, sweeps + 1
    return D, sweeps
