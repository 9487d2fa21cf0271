"""Public wrappers of the fused light-bucket pull kernel.

``bucket_relax_block`` hands the light incoming CSR to the kernel as it is
(the CSR has no width to pad).  ``make_bucket_pull_fn`` adapts it to
core/delta_stepping.py's pull contract ``pull(dist, ops, hi) -> (new,
go)``; it is bitwise equal to the plain ``make_light_pull_fn`` (same
candidates, exact comparisons), so ``delta_stepping_kernel`` solves match
``delta_stepping`` bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bucket_relax import kernel as K


def bucket_relax_block(
        dist: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
        weights: torch.Tensor,
        hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed fused light pull: bitwise equal to
    ref.bucket_relax_ref on the ELL of the same arcs.  dist (n,), indptr
    (n+1,), indices/weights (m,), hi f32 0-dim -> (new (n,), go 0-dim
    bool)."""
    return K.bucket_relax(dist, indptr, indices, weights, hi)


def make_bucket_pull_fn():
    """The kernel-backed light pull for
    core.delta_stepping.sssp_delta_stepping, reading the operands' light
    incoming CSR."""
    def pull(dist, ops, hi):
        return bucket_relax_block(dist, ops["light_indptr"],
                                  ops["light_src"], ops["light_w"], hi)
    return pull
