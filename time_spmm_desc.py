#!/usr/bin/env python3
"""Time the three descriptor SpMM kernels on the yi-6b vocab weight.

    python3 time_spmm_desc.py [--label NAME] [--out FILE]

A shorter run than ``chip_smoke.py`` for work on ``spc5_spmm_desc.cu``: it
builds the kernels, converts the vocab weight as ``chip_smoke.py`` does
(64,000 x 4,096 at density 0.1, beta(4,8)), prepares its panels and
whole-vector descriptor plans through ``ops.prepare`` (the plans that the
default layer and the batch-1 caller get), checks each kernel once against
its plain version at nvec 16 and 128 (within ``1e-5 * max|Y|``), and times
each kernel with CUDA events, L2 flushed before every call, twice: as the
wrapper plans the launch (``vidx`` staged in shared memory where it fits)
and with ``vidx`` read through L1, the kernels' other path, forced by
replacing ``spc5_spmm_desc.smem_plan`` for the call. It prints the card's
name and power limit, one line per kernel, batch and path, and last one
JSON object ``{"label": ..., "card": ..., "times": {"<kernel> nvec=<n>
<path>": ms}}``, also written to ``--out``.

To compare two versions of the code, unpack one into a directory that
``.gitignore`` lists (``git archive``) and run both trees in one call, in
the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import chip_smoke as S

PATHS = ("planned", "vidx_l1")
KERNELS = {"spmm_cuda_panels_desc_db": "panels",
           "spmm_cuda_panels_desc": "panels",
           "spmm_cuda_desc": "whole_vector"}


def vidx_through_l1(stages, cb, r, c, vmax, vidx_width, nvec, pr=0):
    """``smem_plan`` with vidx never staged."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmm_desc as KDM

    def smem(tw):
        return (stages * KDM.stage_bytes(cb, r, c, vmax, vidx_width, False)
                + 4 * pr * tw)
    tw = KM.column_tile(nvec, smem)
    return tw, False, smem(tw)


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_spmm_desc: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmm_desc as KDM
    device = torch.device("cuda")
    card = S.card_line()
    print(card)
    t0 = time.perf_counter()
    S.build_kernels()
    _, _, mat = S.make_vocab()
    plans = {"panels": ops.prepare(mat, lowering="descriptor",
                                   nvec=S.VOCAB["nvec"], device=device),
             "whole_vector": ops.prepare(mat, layout="whole_vector",
                                         lowering="descriptor",
                                         device=device)}
    del mat
    for layout, plan in plans.items():
        if plan.layout != layout:
            raise S.SmokeFailure(f"{layout} plan came out {plan.layout}")
        S.print_spmm_plan(f"{layout} descriptor", plan)
    rng = np.random.default_rng(1)
    times = {}
    for nvec in S.SPMM_NVECS:
        x = torch.from_numpy(rng.standard_normal(
            (S.VOCAB["cols"], nvec)).astype(np.float32)).to(device)
        for name, layout in KERNELS.items():
            call = S.kernel_call(name, plans[layout], x)
            plain = S.plain_y(plans[layout], x)
            planned = KDM.smem_plan
            for path in PATHS:
                if path == "vidx_l1":
                    KDM.smem_plan = vidx_through_l1
                try:
                    err = S.rel_err(call(), plain)
                    if not err <= S.TOL:
                        raise S.SmokeFailure(f"{name} nvec={nvec} {path}: "
                                             f"{err} > {S.TOL}")
                    ms = S.cuda_time_ms(call, device)
                finally:
                    KDM.smem_plan = planned
                times[f"{name} nvec={nvec} {path}"] = ms
                print(f"time {name} nvec={nvec} {path}: {ms:.4f} ms "
                      f"(max|Y - plain| {err:.3g} of max|Y|)")
            del plain
    print(f"total {time.perf_counter() - t0:.1f} s")
    result = {"label": args.label, "card": card, "times": times}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.SmokeFailure as e:
        print(f"time_spmm_desc FAILED: {e}", file=sys.stderr)
        sys.exit(1)
