"""Batched multi-source SSSP (port of the single-device part of
repro/core/multisource.py).

The min-plus sweep generalises to a min-plus matmul over a (S, n)
distance matrix: S sources share every read of the adjacency matrix.  The
fixpoint and each row equal running the paper's Alg. 3 once per source.

``sssp_multisource_sharded`` distributes the batched sweep over the ranks
of a :class:`~repro_torch.core._dist.ShardGroup`: one all-gather of the
(S, loc_n) block a sweep, in plain torch ops as JAX's.
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


def sssp_multisource_sharded(adj_loc: torch.Tensor, sources: torch.Tensor,
                             group, *, max_sweeps: int | None = None):
    """Distributed batched fixpoint: columns sharded over ``group``, D
    replicated.  ``adj_loc`` is this rank's (n_pad, loc_n) column block of
    the padded matrix.  One all-gather of the (S, loc_n) block a sweep
    (:func:`sharded_sweep`).  Returns ``(D (S, n_pad), sweeps)`` on every
    rank."""
    n_pad, loc_n = adj_loc.shape
    if n_pad != loc_n * group.size:
        raise ValueError(f"a ({n_pad}, {loc_n}) slab is not 1/{group.size} "
                         f"of the padded matrix's columns")
    cap = n_pad if max_sweeps is None else max_sweeps
    D = init_dist(n_pad, sources, adj_loc.dtype)
    changed, sweeps = D.numel() > 0, 0
    while sweeps < cap and changed:
        D, changed_t = sharded_sweep(D, adj_loc, group)
        changed, sweeps = bool(changed_t), sweeps + 1
    return D, sweeps


def sharded_sweep(D: torch.Tensor, adj_loc: torch.Tensor, group):
    """One sweep of :func:`sssp_multisource_sharded`: this rank's min-plus
    matmul over its column block and one all-gather.  Returns the new
    replicated D and a 0-dim bool tensor, whether any label changed."""
    loc_n = adj_loc.shape[1]
    v_base = group.rank * loc_n
    mine = D[:, v_base:v_base + loc_n]
    new = group.all_gather(relax_sweep_multi_ref(D, adj_loc, own=mine),
                           dim=1)
    return new, (new != D).any()
