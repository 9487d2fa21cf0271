"""Public wrappers of the fused light-bucket pull kernel.

``bucket_relax_block`` pads the light ELL width to a multiple of 8 with
(0, INF) slots, which can neither improve a label nor raise the flag, and
runs the kernel.  ``make_bucket_pull_fn`` adapts it to
core/delta_stepping.py's pull contract ``pull(dist, ops, hi) -> (new, go)``;
it is bitwise equal to the flat ``make_light_pull_fn`` (same candidates,
exact comparisons), so ``delta_stepping_kernel`` solves match
``delta_stepping`` bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.bucket_relax import kernel as K
from repro_torch.kernels.common import aligned, pad_to


def bucket_relax_block(dist: torch.Tensor, ell_idx: torch.Tensor,
                       ell_w: torch.Tensor,
                       hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel-backed fused light pull: bitwise equal to
    ref.bucket_relax_ref.  dist (n,), ell_idx/ell_w (n, K), hi f32 0-dim
    -> (new (n,), go 0-dim bool)."""
    width = aligned(max(ell_idx.shape[1], 1), 8)
    idx = pad_to(ell_idx, width, 1, 0)
    w = pad_to(ell_w, width, 1, float("inf"))
    return K.bucket_relax(dist, idx, w, hi)


def make_bucket_pull_fn():
    """The kernel-backed light pull for
    core.delta_stepping.sssp_delta_stepping, reading the operands' light
    in-ELL."""
    def pull(dist, ops, hi):
        return bucket_relax_block(dist, ops["light_ell_idx"],
                                  ops["light_ell_w"], hi)
    return pull
