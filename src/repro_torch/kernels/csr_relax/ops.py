"""Public wrappers of the incoming-CSR relax kernel.

The CSR has no width to pad: ``csr_relax_sweep`` hands the row offsets,
sources and weights to the kernel as they are, and the kernel's output
already folds in ``min(dist, ·)``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.csr_relax import kernel as K


def csr_relax_sweep(dist: torch.Tensor, indptr: torch.Tensor,
                    indices: torch.Tensor,
                    weights: torch.Tensor) -> torch.Tensor:
    """One sparse relaxation sweep through the kernel over the incoming
    CSR; bitwise equal to ref.ell_relax_ref on the ELL of the same arcs.
    dist (n,), indptr (n+1,), indices/weights (m,) -> (n,)."""
    return K.ell_relax(dist, indptr, indices, weights)


def make_csr_sweep_fn():
    """``sweep_fn(dist, ops)`` for core.bellman_csr.sssp_bellman_csr,
    reading the operands' int32 incoming CSR (``csr_operands(...,
    with_in_csr=True)``)."""
    def sweep(dist, ops):
        return csr_relax_sweep(dist, ops["in_indptr"], ops["in_src"],
                               ops["w"])
    return sweep
