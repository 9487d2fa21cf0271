"""Plain PyTorch versions of the dense min-plus relaxation kernels.

Min-plus is exact in f32 (adds and compares only; min does not depend on
order), so the CUDA kernels must agree with these bitwise, and so must any
blocking of the contraction over u.  In bfloat16 or float16 each sum here
is rounded to 16 bits before the min; the kernels add and take the min in
float32 and round the minimum once, which gives the same bits (rounding is
monotone), so they agree bitwise in 16 bits too.  The candidate tensor is built one
block of u rows at a time, so a sweep at n = 40,000 (a 6.4 GB matrix)
never holds more than ``_BLOCK_ELEMS`` candidates at once.
"""
from __future__ import annotations

import torch

#: candidates held at once per block of u rows (256 MB of float32)
_BLOCK_ELEMS = 1 << 26


def _rows(n: int, s: int = 1) -> int:
    return max(1, _BLOCK_ELEMS // max(1, s * n))


def relax_sweep_ref(dist: torch.Tensor, adj: torch.Tensor, *,
                    block: int | None = None,
                    own: torch.Tensor | None = None) -> torch.Tensor:
    """One relaxation sweep. (n,), (n, n) -> (n,).

    new[v] = min(dist[v], min_u(dist[u] + adj[u, v]))

    The paper's CUDA kernel (Alg. 4) as a min-plus matvec, with the
    contraction taken ``block`` rows of u at a time.  ``adj`` may be a
    column block (n, C) of the matrix (a rank's slab in bellman_sharded);
    ``own`` (C,) are then its columns' labels, folded in place of dist.
    """
    n, C = adj.shape
    step = block or _rows(C)
    base = dist if own is None else own
    out = base
    for u0 in range(0, n, step):
        cand = (dist[u0:u0 + step, None] + adj[u0:u0 + step]).amin(dim=0)
        out = torch.minimum(out, cand)
    return out.clone() if out is base else out


def relax_sweep_frontier_ref(dist: torch.Tensor, frontier: torch.Tensor,
                             adj: torch.Tensor) -> torch.Tensor:
    """The sweep with only the frontier's rows relaxing: (n,), (n,) bool,
    (n, n) -> (n,).

    new[v] = min(dist[v], min_{u: frontier[u]}(dist[u] + adj[u, v]))

    Rows off the frontier contribute INF; the self-distance fold keeps
    every label, on the frontier or not.
    """
    masked = torch.where(frontier, dist, torch.inf)
    return torch.minimum(dist, relax_sweep_ref(masked, adj))


def relax_sweep_multi_ref(D: torch.Tensor, adj: torch.Tensor, *,
                          block: int | None = None,
                          own: torch.Tensor | None = None) -> torch.Tensor:
    """Batched (multi-source) sweep. (S, n), (n, n) -> (S, n).

    new[s, v] = min(D[s, v], min_u(D[s, u] + adj[u, v]))

    A min-plus matmul, blocked over u like ``relax_sweep_ref``, which
    also says what a column block ``adj`` (n, C) with ``own`` (S, C) is.
    """
    S, n = D.shape
    step = block or _rows(adj.shape[1], S)
    base = D if own is None else own
    out = base
    for u0 in range(0, n, step):
        cand = (D[:, u0:u0 + step, None]
                + adj[None, u0:u0 + step, :]).amin(dim=1)
        out = torch.minimum(out, cand)
    return out.clone() if out is base else out
