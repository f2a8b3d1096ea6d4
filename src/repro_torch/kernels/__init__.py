"""Hand-written CUDA kernels (``csrc/``), their wrappers and the ops facade.

Nothing is compiled at import time; the shared library is built by
:func:`repro_torch.kernels._build.load_library` the first time a wrapper
receives a CUDA tensor.
"""
