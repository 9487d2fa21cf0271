"""Wrapper of the hand-written CUDA light-bucket pull kernel
(``csrc/bucket_relax.cu``; it replaces the Pallas TPU kernel
``repro/kernels/bucket_relax/kernel.py:bucket_relax``, and the source says
what bounds it on an H100 and how its design answers that).

``bucket_relax`` launches the kernel on CUDA tensors and runs the plain
version (ref.py) on CPU tensors.  ``bucket_relax.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import common
from repro_torch.kernels.bucket_relax.ref import bucket_relax_csr_ref

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _P, _I64, _I, _P)


def bucket_relax(dist: torch.Tensor, indptr: torch.Tensor,
                 indices: torch.Tensor, weights: torch.Tensor,
                 hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused light pull over the light incoming CSR: ``(new, go)`` as
    ref.bucket_relax_csr_ref, with ``go`` a 0-dim bool tensor on the device
    (no host sync).  dist f32 (n,), indptr int32 (n+1,), indices int32
    (m,), weights f32 (m,), hi f32 0-dim, all contiguous on one device.
    The kernel gives each row ``common.lane_group(n, m)`` lanes."""
    common.check_csr(dist, indptr, indices, weights)
    common.check(hi, "hi", torch.float32, ())
    if not common.on_cuda(dist, indptr, indices, weights, hi):
        return bucket_relax_csr_ref(dist, indptr, indices, weights, hi)
    n = dist.shape[0]
    out = torch.empty_like(dist)
    flag = torch.zeros((), dtype=torch.int32, device=dist.device)
    if n == 0:
        return out, flag.bool()
    rc = common.launcher("bucket_relax", _ARGS)(
        dist.data_ptr(), indptr.data_ptr(), indices.data_ptr(),
        weights.data_ptr(), hi.data_ptr(), out.data_ptr(), flag.data_ptr(),
        n, common.lane_group(n, indices.shape[0]), common.stream(dist))
    common.raise_on_error(rc, "bucket_relax")
    bucket_relax.launches += 1
    return out, flag.bool()


bucket_relax.launches = 0
