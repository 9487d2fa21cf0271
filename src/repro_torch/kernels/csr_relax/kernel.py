"""Wrapper of the hand-written CUDA padded-ELL relax kernel
(``csrc/ell_relax.cu``; it replaces the Pallas TPU kernel
``repro/kernels/csr_relax/kernel.py:ell_relax``, and the source says what
bounds it on an H100 and how its design answers that).

``ell_relax`` launches the kernel on CUDA tensors and runs the plain version
(ref.py) on CPU tensors.  ``ell_relax.launches`` counts the kernel's
launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.csr_relax.ref import ell_relax_ref

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _I64, _I, _P)


def ell_relax(dist: torch.Tensor, ell_idx: torch.Tensor,
              ell_w: torch.Tensor) -> torch.Tensor:
    """``min(dist[v], min_k dist[ell_idx[v, k]] + ell_w[v, k])`` for every
    v, into a new tensor.  dist f32 (n,), ell_idx int32 (n, K), ell_w f32
    (n, K), all contiguous; on CUDA K must be a multiple of 4 (the ops layer
    pads to 8)."""
    n, K = ell_idx.shape
    common.check(dist, "dist", torch.float32, (n,))
    common.check(ell_idx, "ell_idx", torch.int32, (n, K))
    common.check(ell_w, "ell_w", torch.float32, (n, K))
    if not common.on_cuda(dist, ell_idx, ell_w):
        return ell_relax_ref(dist, ell_idx, ell_w)
    if K % 4:
        raise ValueError(f"ELL width {K} is not a multiple of 4")
    common.check_aligned(ell_idx, "ell_idx")
    common.check_aligned(ell_w, "ell_w")
    out = torch.empty_like(dist)
    if n == 0:
        return out
    rc = common.launcher("ell_relax", _ARGS)(
        dist.data_ptr(), ell_idx.data_ptr(), ell_w.data_ptr(), out.data_ptr(),
        n, K, common.stream(dist))
    common.raise_on_error(rc, "ell_relax")
    ell_relax.launches += 1
    return out


ell_relax.launches = 0
