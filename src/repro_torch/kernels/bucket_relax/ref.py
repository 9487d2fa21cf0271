"""Plain PyTorch version of the fused Δ-stepping light-bucket pull.

The pull is gathers, adds and mins over f32 — exact operations — so the
CUDA kernel must agree with this bitwise, flag included.
"""
from __future__ import annotations

import torch


def bucket_relax_ref(dist: torch.Tensor, ell_idx: torch.Tensor,
                     ell_w: torch.Tensor,
                     hi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``(new, go)`` with ``new = min(dist, min_k dist[ell_idx[:, k]] +
    ell_w[:, k])`` and ``go = any((new < dist) & (new < hi))`` — the Δ
    engine's inner-loop step and its control bit (a 0-dim bool tensor)."""
    cand = (dist[ell_idx] + ell_w).amin(dim=1)
    new = torch.minimum(dist, cand)
    return new, ((new < dist) & (new < hi)).any()
