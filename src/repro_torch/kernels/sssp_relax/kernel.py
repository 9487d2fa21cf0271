"""Wrappers of the hand-written CUDA dense min-plus kernels
(``csrc/relax_matvec.cu``, ``csrc/relax_matmul.cu`` and
``csrc/relax_matvec_frontier.cu``; they replace the Pallas TPU kernels
``repro/kernels/sssp_relax/kernel.py:relax_matvec``, ``relax_matmul`` and
``relax_matvec_frontier``, and each source says what bounds it on an H100
and how its design answers that).

Each wrapper launches its kernel on CUDA tensors and runs its plain
version (ref.py) on CPU tensors, and counts the kernel's launches in
``<wrapper>.launches``, whatever the dtype.  Labels and matrix share one
dtype, float32, bfloat16 or float16 (``common.DENSE_DTYPES``), as the
Pallas kernels take any float dtype and give ``dist.dtype``; each kernel
has one C entry a dtype, with float32 arithmetic and one rounding of each
minimum to 16 bits, which equals the plain version's 16-bit sums
(``csrc/min_plus_types.cuh``).  Unlike the TPU kernels, which returned the
pure relaxation term, the kernels fold in the self-distance ``min(dist,
·)`` that the JAX ops wrappers applied, so their outputs are whole
sweeps.  Labels and weights must be nonnegative: the kernels combine
partial minima with an atomic min on bit patterns, which orders them only
from +0 up to +inf.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                relax_sweep_multi_ref,
                                                relax_sweep_ref)

_P, _I64 = ctypes.c_void_p, ctypes.c_int64
#: the C entry of each dtype: ``<kernel><suffix>_launch``
_SUFFIX = {torch.float32: "", torch.bfloat16: "_bf16", torch.float16: "_f16"}


def _entry(name: str, dtype: torch.dtype, argtypes: tuple):
    return common.launcher(name, argtypes, name + _SUFFIX[dtype])


def relax_matvec(dist: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """``min(dist[v], min_u dist[u] + adj[u, v])`` for every v, into a new
    tensor.  dist (n,), adj (n, n), both contiguous and of one dtype of
    ``common.DENSE_DTYPES``."""
    n = adj.shape[0]
    common.check_dense(dist, "dist", (n,), adj)
    if not common.on_cuda(dist, adj):
        return relax_sweep_ref(dist, adj)
    out = dist.clone()
    if n == 0:
        return out
    rc = _entry("relax_matvec", dist.dtype, (_P, _P, _P, _I64, _P))(
        dist.data_ptr(), adj.data_ptr(), out.data_ptr(), n,
        common.stream(dist))
    common.raise_on_error(rc, "relax_matvec")
    relax_matvec.launches += 1
    return out


def relax_matvec_frontier(dist: torch.Tensor, frontier: torch.Tensor,
                          adj: torch.Tensor) -> torch.Tensor:
    """``min(dist[v], min_{u: frontier[u]} dist[u] + adj[u, v])`` for every
    v, into a new tensor.  dist (n,), frontier bool (n,), adj (n, n), all
    contiguous; dist and adj of one dtype of ``common.DENSE_DTYPES``."""
    n = adj.shape[0]
    common.check_dense(dist, "dist", (n,), adj)
    common.check(frontier, "frontier", torch.bool, (n,))
    if not common.on_cuda(dist, frontier, adj):
        return relax_sweep_frontier_ref(dist, frontier, adj)
    out = dist.clone()
    if n == 0:
        return out
    rc = _entry("relax_matvec_frontier", dist.dtype,
                (_P, _P, _P, _P, _I64, _P))(
        dist.data_ptr(), frontier.data_ptr(), adj.data_ptr(), out.data_ptr(),
        n, common.stream(dist))
    common.raise_on_error(rc, "relax_matvec_frontier")
    relax_matvec_frontier.launches += 1
    return out


def relax_matmul(D: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
    """``min(D[s, v], min_u D[s, u] + adj[u, v])`` for every (s, v), into a
    new tensor.  D (S, n), adj (n, n), both contiguous and of one dtype of
    ``common.DENSE_DTYPES``."""
    n = adj.shape[0]
    S = D.shape[0]
    common.check_dense(D, "D", (S, n), adj)
    if not common.on_cuda(D, adj):
        return relax_sweep_multi_ref(D, adj)
    out = D.clone()
    if out.numel() == 0:
        return out
    rc = _entry("relax_matmul", D.dtype, (_P, _P, _P, _I64, _I64, _P))(
        D.data_ptr(), adj.data_ptr(), out.data_ptr(), S, n,
        common.stream(D))
    common.raise_on_error(rc, "relax_matmul")
    relax_matmul.launches += 1
    return out


relax_matvec.launches = 0
relax_matvec_frontier.launches = 0
relax_matmul.launches = 0
