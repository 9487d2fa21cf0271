"""Hand-written CUDA kernels (``csrc/``) with their wrappers and plain
PyTorch versions, one package per kernel: ``kernel.py`` (wrapper and launch
count), ``ops.py`` (padding and engine adapters), ``ref.py`` (plain
version)."""


def wrappers() -> dict:
    """The six kernel wrappers by kernel name; each counts its launches in
    its ``launches`` attribute."""
    from repro_torch.kernels.bucket_relax.kernel import bucket_relax
    from repro_torch.kernels.csr_relax.kernel import ell_relax
    from repro_torch.kernels.frontier_relax.kernel import frontier_relax
    from repro_torch.kernels.sssp_relax.kernel import (relax_matmul,
                                                       relax_matvec,
                                                       relax_matvec_frontier)

    return {"ell_relax": ell_relax, "frontier_relax": frontier_relax,
            "bucket_relax": bucket_relax, "relax_matvec": relax_matvec,
            "relax_matmul": relax_matmul,
            "relax_matvec_frontier": relax_matvec_frontier}
