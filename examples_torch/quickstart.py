"""Quickstart: SPC5 block-sparse formats and kernels on the card.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]

The port of ``examples/quickstart.py``. It runs on the card unless
``--device cpu`` is given; there, the SpMV of step 3 is the plain PyTorch
version on both sides. The line before the last gives the launches of the
SpMV kernels (none on the CPU).
"""
import argparse
import json

import numpy as np
import torch

from repro_torch.core import formats as F
from repro_torch.core import matgen
from repro_torch.core.selector import RecordStore, select_kernel
from repro_torch.kernels import ops, spc5_spmv, spc5_spmv_desc


def launches():
    """The SpMV kernels' launches so far, those that launched."""
    return {k: v for mod in (spc5_spmv, spc5_spmv_desc)
            for k, v in mod.LAUNCHES.items() if v}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="'cpu' for the plain PyTorch versions on the host "
                         "(default: the card)")
    args = ap.parse_args(argv)
    device = ops.resolve_device(args.device)

    # 1. a sparse matrix (FEM-like structure, as in the paper's Set-A)
    csr = matgen.fem_blocks(3_000, 4, 6, seed=0)
    print(f"matrix: {csr.shape}, nnz={csr.nnz}")

    # 2. convert to beta(r,c) -- NO zero padding: values array == nnz
    for rc in [(1, 8), (2, 4), (4, 4), (4, 8)]:
        mat = F.csr_to_spc5(csr, *rc)
        print(f"  beta{rc}: blocks={mat.nblocks:6d} "
              f"avg nnz/block={mat.avg_nnz_per_block:5.2f} "
              f"(fill {mat.fill_ratio*100:4.1f}%) "
              f"bytes={mat.occupancy_bytes()/1e6:6.2f}MB "
              f"vs CSR {csr.occupancy_bytes()/1e6:6.2f}MB")

    # 3. SpMV through the kernel, held against the plain version
    mat = F.csr_to_spc5(csr, 4, 4)
    plan = ops.prepare(mat, cb=256, device=device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        csr.shape[1]).astype(np.float32)).to(device)
    y_ref = ops.spmv(plan, x, use_pallas=False)       # plain PyTorch
    y = ops.spmv(plan, x)                             # the kernel
    err = float((y_ref - y).abs().max())
    what = "kernel" if device.type == "cuda" else "plain (CPU)"
    print(f"SpMV ({plan.layout} + {plan.lowering}): {what}-vs-plain "
          f"max err = {err:.2e}")

    # 4. record-based kernel selection (paper §Prediction)
    store = RecordStore()
    for k, gf_per_avg in [("1x8", 0.30), ("2x4", 0.33), ("4x4", 0.26),
                          ("4x8", 0.22), ("2x8", 0.28), ("8x4", 0.2)]:
        for avg in [1.0, 4.0, 16.0, 32.0]:
            store.add(k, avg, 1, gf_per_avg * avg)    # toy records
    best, pred, _ = select_kernel(csr, store, workers=1)
    print(f"launches: {json.dumps(launches(), sort_keys=True)}")
    print(f"selector picks beta({best}) predicted {pred:.2f} GF/s")


if __name__ == "__main__":
    main()
