"""Wrapper of the hand-written CUDA incoming-CSR relax kernel
(``csrc/ell_relax.cu``; it replaces the Pallas TPU kernel
``repro/kernels/csr_relax/kernel.py:ell_relax``, whose name it keeps, and
the source says what bounds it on an H100 and how its design answers that).

``ell_relax`` launches the kernel on CUDA tensors and runs the plain
version (ref.py) on CPU tensors.  ``ell_relax.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.csr_relax.ref import ell_relax_csr_ref

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _I64, _I64, _I, _P)


def ell_relax(dist: torch.Tensor, indptr: torch.Tensor,
              indices: torch.Tensor, weights: torch.Tensor, *,
              row_base: int | None = None) -> torch.Tensor:
    """``min(dist[v], min_e dist[indices[e]] + weights[e])`` over the arcs
    e of row v, ``[indptr[v], indptr[v+1])``, for every v, into a new
    tensor.  dist f32 (n,), indptr int32 (n+1,), indices int32 (m,),
    weights f32 (m,), all contiguous on one device.

    With ``row_base`` the rows are a block of ``dist``: the CSR has R rows
    (indptr (R+1,)), row v's own label is ``dist[row_base + v]`` and the
    result is (R,); sources index all of ``dist`` (the sharded pull over an
    owner's block of the gathered vector).  The kernel gives each row
    ``common.lane_group(R, m)`` lanes."""
    common.check_csr(dist, indptr, indices, weights, row_base=row_base)
    if not common.on_cuda(dist, indptr, indices, weights):
        return ell_relax_csr_ref(dist, indptr, indices, weights,
                                 row_base=row_base or 0)
    rows = indptr.shape[0] - 1
    out = torch.empty(rows, dtype=dist.dtype, device=dist.device)
    if rows == 0:
        return out
    rc = common.launcher("ell_relax", _ARGS)(
        dist.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
        weights.data_ptr(), out.data_ptr(), rows, row_base or 0,
        common.lane_group(rows, indices.shape[0]), common.stream(dist))
    common.raise_on_error(rc, "ell_relax")
    ell_relax.launches += 1
    return out


ell_relax.launches = 0
