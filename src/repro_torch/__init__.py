"""PyTorch/CUDA port of the SPC5 reproduction (beta(r,c) SpMV without zero
padding), built beside the JAX package ``repro``, which stays the reference.

Importing this package (or any of its modules) builds nothing: the CUDA
kernels under ``kernels/csrc`` are compiled on first use by
:mod:`repro_torch.kernels._build`. Entry points run on the card unless the
caller passes ``device="cpu"`` (see :func:`repro_torch.kernels.ops.prepare`).
"""
