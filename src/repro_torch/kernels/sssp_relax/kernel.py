"""Wrappers of the hand-written CUDA dense min-plus kernels
(``csrc/relax_matvec.cu``, ``csrc/relax_matmul.cu`` and
``csrc/relax_matvec_frontier.cu``; they replace the Pallas TPU kernels
``repro/kernels/sssp_relax/kernel.py:relax_matvec``, ``relax_matmul`` and
``relax_matvec_frontier``, and each source says what bounds it on an H100
and how its design answers that).

Each wrapper launches its kernel on CUDA tensors and runs its plain
version (ref.py) on CPU tensors, and counts the kernel's launches in
``<wrapper>.launches``.  Unlike the TPU kernels, which returned the pure
relaxation term, the kernels fold in the self-distance ``min(dist, ·)``
that the JAX ops wrappers applied, so their outputs are whole sweeps.
Labels and weights must be nonnegative: the kernels combine partial
minima with an atomicMin on float bit patterns read as int32, which
orders them only from +0 up to +inf.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                relax_sweep_multi_ref,
                                                relax_sweep_ref)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64


def relax_matvec(dist: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """``min(dist[v], min_u dist[u] + adj[u, v])`` for every v, into a new
    tensor.  dist f32 (n,), adj f32 (n, n), both contiguous."""
    n = adj.shape[0]
    common.check(dist, "dist", torch.float32, (n,))
    common.check(adj, "adj", torch.float32, (n, n))
    if not common.on_cuda(dist, adj):
        return relax_sweep_ref(dist, adj)
    out = dist.clone()
    if n == 0:
        return out
    rc = common.launcher("relax_matvec", (_P, _P, _P, _I64, _P))(
        dist.data_ptr(), adj.data_ptr(), out.data_ptr(), n,
        common.stream(dist))
    common.raise_on_error(rc, "relax_matvec")
    relax_matvec.launches += 1
    return out


def relax_matvec_frontier(dist: torch.Tensor, frontier: torch.Tensor,
                          adj: torch.Tensor) -> torch.Tensor:
    """``min(dist[v], min_{u: frontier[u]} dist[u] + adj[u, v])`` for every
    v, into a new tensor.  dist f32 (n,), frontier bool (n,), adj f32
    (n, n), all contiguous."""
    n = adj.shape[0]
    common.check(dist, "dist", torch.float32, (n,))
    common.check(frontier, "frontier", torch.bool, (n,))
    common.check(adj, "adj", torch.float32, (n, n))
    if not common.on_cuda(dist, frontier, adj):
        return relax_sweep_frontier_ref(dist, frontier, adj)
    out = dist.clone()
    if n == 0:
        return out
    rc = common.launcher("relax_matvec_frontier", (_P, _P, _P, _P, _I64, _P))(
        dist.data_ptr(), frontier.data_ptr(), adj.data_ptr(), out.data_ptr(),
        n, common.stream(dist))
    common.raise_on_error(rc, "relax_matvec_frontier")
    relax_matvec_frontier.launches += 1
    return out


def relax_matmul(D: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """``min(D[s, v], min_u D[s, u] + adj[u, v])`` for every (s, v), into a
    new tensor.  D f32 (S, n), adj f32 (n, n), both contiguous."""
    n = adj.shape[0]
    S = D.shape[0]
    common.check(D, "D", torch.float32, (S, n))
    common.check(adj, "adj", torch.float32, (n, n))
    if not common.on_cuda(D, adj):
        return relax_sweep_multi_ref(D, adj)
    out = D.clone()
    if out.numel() == 0:
        return out
    rc = common.launcher("relax_matmul", (_P, _P, _P, _I64, _I64, _P))(
        D.data_ptr(), adj.data_ptr(), out.data_ptr(), S, n,
        common.stream(D))
    common.raise_on_error(rc, "relax_matmul")
    relax_matmul.launches += 1
    return out


relax_matvec.launches = 0
relax_matvec_frontier.launches = 0
relax_matmul.launches = 0
