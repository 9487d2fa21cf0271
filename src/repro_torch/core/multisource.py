"""Batched multi-source helpers (port of the single-device part of
repro/core/multisource.py that the CSR engines use)."""
from __future__ import annotations

import torch


def init_dist(n: int, sources: torch.Tensor,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(S, n) initial distance matrix: 0 at (s, sources[s]), INF elsewhere,
    on ``sources``' device."""
    cols = torch.arange(n, device=sources.device)[None, :]
    zero = torch.zeros((), dtype=dtype, device=sources.device)
    return torch.where(cols == sources[:, None], zero, torch.inf).to(dtype)
