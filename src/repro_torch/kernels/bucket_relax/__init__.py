from repro_torch.kernels.bucket_relax.kernel import bucket_relax
from repro_torch.kernels.bucket_relax.ops import (bucket_relax_block,
                                                  make_bucket_pull_fn)
from repro_torch.kernels.bucket_relax.ref import (bucket_relax_csr_ref,
                                                  bucket_relax_ref)

__all__ = [
    "bucket_relax",
    "bucket_relax_block",
    "make_bucket_pull_fn",
    "bucket_relax_csr_ref",
    "bucket_relax_ref",
]
