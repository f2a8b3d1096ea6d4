"""The plain PyTorch versions of the SPC5 kernels (re-exported from
``repro_torch.core.ref_spmv``), as the reference's ``repro.kernels.ref``
re-exports its jnp oracle.

They decode the same chunked layout with the same rank expansion, so a
kernel-against-plain comparison isolates the kernel (its staging, launch
plan and scatter) from the format logic.
"""
from repro_torch.core.ref_spmv import (  # noqa: F401
    SPC5Device,
    device_put,
    spmm,
    spmv,
    spmv_dense_oracle,
)
