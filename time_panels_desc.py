#!/usr/bin/env python3
"""Time the two panel descriptor SpMV kernels at other splits and rings.

    python3 time_panels_desc.py [--label NAME] [--out FILE]

A shorter run than ``chip_smoke.py`` for work on the panel kernels of
``spc5_spmv_desc.cu``: it builds the kernels, prepares the two panel
descriptor plans ``chip_smoke.py`` times at batch 1 (the default vocab
layer's: yi-6b's 64,000 x 4,096 vocab weight at density 0.1 in beta(4,8),
``ops.prepare(lowering="descriptor", nvec=128)``; and the FEM matrix's,
pr=512, cb=64, xw=512), and on each times both kernels with CUDA events, L2
flushed before every call: at S = 1 and at 1/2, 1, 2, 3 and 4 times the S
the wrapper picks (capped at nchunks), and the double-buffered one with a
ring of 2 as well as its ``DB_STAGES`` (replaced for the call). Every
setting is first held against the plain version (within ``1e-5 *
max|y|``). It prints the card's name and power limit, one line per plan,
kernel and setting, and last one JSON object ``{"label": ..., "card": ...,
"launch": {plan: {"s1": ..., "s2": ...}}, "times": {"<plan> <kernel>
<setting>": ms}}``, also written to ``--out``.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import chip_smoke as S

KERNELS = {"spmv_cuda_panels_desc_db": "s2", "spmv_cuda_panels_desc": "s1"}


def settings(plan, launch):
    """(kernel, setting, ring length or None, split) to time on the plan."""
    from repro_torch.kernels import spc5_spmv_desc as KD
    out = []
    for name, key in KERNELS.items():
        auto = launch[key]["split"]
        splits = {1, max(1, auto // 2)} | {min(plan.nchunks, m * auto)
                                           for m in (1, 2, 3, 4)}
        out += [(name, f"split{s}", None, s) for s in sorted(splits)]
    out += [("spmv_cuda_panels_desc_db", f"ring{s}", s, None)
            for s in sorted({2, KD.DB_STAGES})]
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_panels_desc: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv_desc as KD
    device = torch.device("cuda")
    card = S.card_line()
    print(card)
    t0 = time.perf_counter()
    S.build_kernels()
    _, _, vocab = S.make_vocab()
    _, fem = S.make_matrix()
    plans = {"vocab": ops.prepare(vocab, lowering="descriptor",
                                  nvec=S.VOCAB["nvec"], device=device),
             "fem": ops.prepare(fem, layout="panels", lowering="descriptor",
                                tune=False, device=device,
                                **S.GEOM["panels"])}
    del vocab, fem
    rng = np.random.default_rng(1)
    times, launches = {}, {}
    for key, plan in plans.items():
        if (plan.layout, plan.lowering) != ("panels", "descriptor"):
            raise S.SmokeFailure(f"{key} plan came out {plan.layout} + "
                                 f"{plan.lowering}")
        S.print_plan(key, plan)
        launches[key] = S.panel_desc_launches(plan)
        x = torch.from_numpy(rng.standard_normal(plan.ncols).astype(
            np.float32)).to(device)
        plain = S.plain_y(plan, x)
        planned = KD.DB_STAGES
        for name, setting, ring, split in settings(plan, launches[key]):
            call = S.kernel_call(name, plan, x, split=split)
            if ring is not None:
                KD.DB_STAGES = ring
            try:
                err = S.rel_err(call(), plain)
                if not err <= S.TOL:
                    raise S.SmokeFailure(f"{key} {name} {setting}: {err} > "
                                         f"{S.TOL}")
                ms = S.cuda_time_ms(call, device)
            finally:
                KD.DB_STAGES = planned
            times[f"{key} {name} {setting}"] = ms
            print(f"time {key} {name} {setting}: {ms:.4f} ms (max|y - "
                  f"plain| {err:.3g} of max|y|)")
        del plain
    print(f"total {time.perf_counter() - t0:.1f} s")
    result = {"label": args.label, "card": card, "launch": launches,
              "times": times}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.SmokeFailure as e:
        print(f"time_panels_desc FAILED: {e}", file=sys.stderr)
        sys.exit(1)
