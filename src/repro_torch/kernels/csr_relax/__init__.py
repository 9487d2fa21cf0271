from repro_torch.kernels.csr_relax.kernel import ell_relax
from repro_torch.kernels.csr_relax.ops import csr_relax_sweep, make_csr_sweep_fn
from repro_torch.kernels.csr_relax.ref import (ell_relax_csr_ref, ell_relax_ref,
                                               segment_relax_ref)

__all__ = [
    "ell_relax",
    "csr_relax_sweep",
    "make_csr_sweep_fn",
    "ell_relax_csr_ref",
    "ell_relax_ref",
    "segment_relax_ref",
]
