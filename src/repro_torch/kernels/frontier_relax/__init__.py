from repro_torch.kernels.frontier_relax.kernel import frontier_relax
from repro_torch.kernels.frontier_relax.ops import make_frontier_sweep_fn
from repro_torch.kernels.frontier_relax.ref import frontier_relax_ref

__all__ = [
    "frontier_relax",
    "make_frontier_sweep_fn",
    "frontier_relax_ref",
]
