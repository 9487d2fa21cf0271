"""Plain PyTorch versions of the fused Δ-stepping light-bucket pull.

The pull is gathers, adds and mins over f32 — exact operations — so the
CUDA kernel must agree with these bitwise, flag included, and the ELL and
CSR forms agree with each other: they enumerate the same candidates.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.csr_relax.ref import ell_relax_csr_ref


def bucket_relax_ref(dist: torch.Tensor, ell_idx: torch.Tensor,
                     ell_w: torch.Tensor,
                     hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(new, go)`` over the padded light in-ELL (the TPU kernel's
    operand), with ``new = min(dist, min_k dist[ell_idx[:, k]] +
    ell_w[:, k])`` and ``go = any((new < dist) & (new < hi))`` — the Δ
    engine's inner-loop step and its control bit (a 0-dim bool tensor)."""
    cand = (dist[ell_idx] + ell_w).amin(dim=1)
    new = torch.minimum(dist, cand)
    return new, ((new < dist) & (new < hi)).any()


def bucket_relax_csr_ref(
        dist: torch.Tensor, indptr: torch.Tensor, indices: torch.Tensor,
        weights: torch.Tensor,
        hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The same ``(new, go)`` over the light incoming CSR (the CUDA
    kernel's operand): the plain CSR relax sweep (a segment-min of the
    arcs' candidates, folded with the self-distance) and its flag."""
    new = ell_relax_csr_ref(dist, indptr, indices, weights)
    return new, ((new < dist) & (new < hi)).any()
