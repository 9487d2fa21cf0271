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
from repro_torch.kernels.bucket_relax.ref import bucket_relax_ref

_P, _I64, _I = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_ARGS = (_P, _P, _P, _P, _P, _P, _I64, _I, _P)


def bucket_relax(dist: torch.Tensor, ell_idx: torch.Tensor,
                 ell_w: torch.Tensor,
                 hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One fused light pull: ``(new, go)`` as ref.bucket_relax_ref, with
    ``go`` a 0-dim bool tensor on the device (no host sync).  dist f32
    (n,), ell_idx int32 (n, K), ell_w f32 (n, K), hi f32 0-dim, all on one
    device and contiguous; on CUDA K must be a multiple of 4."""
    n, K = ell_idx.shape
    common.check(dist, "dist", torch.float32, (n,))
    common.check(ell_idx, "ell_idx", torch.int32, (n, K))
    common.check(ell_w, "ell_w", torch.float32, (n, K))
    common.check(hi, "hi", torch.float32, ())
    if not common.on_cuda(dist, ell_idx, ell_w, hi):
        return bucket_relax_ref(dist, ell_idx, ell_w, hi)
    if K % 4:
        raise ValueError(f"ELL width {K} is not a multiple of 4")
    common.check_aligned(ell_idx, "ell_idx")
    common.check_aligned(ell_w, "ell_w")
    out = torch.empty_like(dist)
    flag = torch.zeros((), dtype=torch.int32, device=dist.device)
    if n == 0:
        return out, flag.bool()
    rc = common.launcher("bucket_relax", _ARGS)(
        dist.data_ptr(), ell_idx.data_ptr(), ell_w.data_ptr(), hi.data_ptr(),
        out.data_ptr(), flag.data_ptr(), n, K, common.stream(dist))
    common.raise_on_error(rc, "bucket_relax")
    bucket_relax.launches += 1
    return out, flag.bool()


bucket_relax.launches = 0
