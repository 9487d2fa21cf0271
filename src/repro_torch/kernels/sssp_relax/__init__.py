from repro_torch.kernels.sssp_relax.kernel import (relax_matmul, relax_matvec,
                                                   relax_matvec_frontier)
from repro_torch.kernels.sssp_relax.ops import (make_sweep_fn, relax_sweep,
                                                relax_sweep_multi)
from repro_torch.kernels.sssp_relax.ref import (relax_sweep_frontier_ref,
                                                relax_sweep_multi_ref,
                                                relax_sweep_ref)

__all__ = [
    "relax_matvec",
    "relax_matmul",
    "relax_matvec_frontier",
    "relax_sweep",
    "relax_sweep_multi",
    "make_sweep_fn",
    "relax_sweep_ref",
    "relax_sweep_multi_ref",
    "relax_sweep_frontier_ref",
]
