"""Public wrappers of the padded-ELL relax kernel.

``csr_relax_sweep`` pads the ELL width to a multiple of 8 with (0, INF)
slots — which never win a min, the paper's unreachable-padding argument —
and runs the kernel, whose output already folds in ``min(dist, ·)``.  Rows
need no padding: the kernel masks its ragged last block itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import aligned, pad_to
from repro_torch.kernels.csr_relax import kernel as K


def csr_relax_sweep(dist: torch.Tensor, ell_idx: torch.Tensor,
                    ell_w: torch.Tensor) -> torch.Tensor:
    """One sparse relaxation sweep through the ELL kernel; bitwise equal to
    ref.ell_relax_ref.  dist (n,), ell_idx/ell_w (n, K) -> (n,)."""
    width = aligned(max(ell_idx.shape[1], 1), 8)
    idx = pad_to(ell_idx, width, 1, 0)
    w = pad_to(ell_w, width, 1, float("inf"))
    return K.ell_relax(dist, idx, w)


def make_csr_sweep_fn():
    """``sweep_fn(dist, ops)`` for core.bellman_csr.sssp_bellman_csr,
    reading the operands' ELL view."""
    def sweep(dist, ops):
        return csr_relax_sweep(dist, ops["ell_idx"], ops["ell_w"])
    return sweep
