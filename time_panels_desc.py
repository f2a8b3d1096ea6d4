#!/usr/bin/env python3
"""Time the four panel SpMV kernels at other splits, rings and thread counts.

    python3 time_panels_desc.py [--lowering mask|descriptor|both] [--cb N]
                                [--label NAME] [--out FILE]

A shorter run than ``chip_smoke.py`` for work on the panel SpMV kernels of
``spc5_spmv.cu`` (mask) and ``spc5_spmv_desc.cu`` (descriptor): it builds
the kernels, prepares the panel plans ``chip_smoke.py`` times at batch 1
(yi-6b's 64,000 x 4,096 vocab weight at density 0.1 in beta(4,8),
``ops.prepare(lowering=..., nvec=128)``; and the FEM matrix's, pr=512,
cb=64, xw=512) in each asked lowering (``--cb``: both plans cut into
chunks of N blocks instead, pr and xw as before), and on each times both
kernels with CUDA events, L2 flushed before every call: at S = 1 and at
1/2, 1, 2, 3 and 4 times the S the wrapper picks (capped at nchunks), the
double-buffered one with rings of 2 and 3 (``DB_STAGES`` replaced for the
call), and the mask kernels with 1, 2 and 4 block rows a thread
(``ROWS_PER_THREAD``, which sets the CTA's threads and so S). Every setting
is first held against the plain version (within ``1e-5 * max|y|``). It
prints the card's name and power limit, one line per plan, kernel and
setting, and last one JSON object ``{"label": ..., "card": ...,
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

KERNELS = {"descriptor": {"spmv_cuda_panels_desc_db": "s2",
                          "spmv_cuda_panels_desc": "s1"},
           "mask": {"spmv_cuda_panels_db": "s2", "spmv_cuda_panels": "s1"}}


def settings(plan, launch):
    """(kernel, setting, module overrides, split) to time on the plan."""
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    module = KD if plan.lowering == "descriptor" else K
    out = []
    for name, key in KERNELS[plan.lowering].items():
        auto = launch[key]["split"]
        splits = {1, max(1, auto // 2)} | {min(plan.nchunks, m * auto)
                                           for m in (1, 2, 3, 4)}
        out += [(name, f"split{s}", {}, s) for s in sorted(splits)]
        if module is K:
            out += [(name, f"rows{k}", {(K, "ROWS_PER_THREAD"): k}, None)
                    for k in (1, 2, 4) if k != K.ROWS_PER_THREAD]
    db = next(iter(KERNELS[plan.lowering]))
    out += [(db, f"ring{s}", {(module, "DB_STAGES"): s}, None)
            for s in (2, 3)]
    return out


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lowering", default="both",
                    choices=("mask", "descriptor", "both"))
    ap.add_argument("--cb", type=int, default=0,
                    help="chunk size of both plans (default: their own)")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_panels_desc: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    device = torch.device("cuda")
    card = S.card_line()
    print(card)
    t0 = time.perf_counter()
    S.build_kernels()
    _, _, vocab = S.make_vocab()
    _, fem = S.make_matrix()
    lowerings = (("mask", "descriptor") if args.lowering == "both"
                 else (args.lowering,))
    plans = {}
    cut = dict(S.GEOM["panels"], **({"cb": args.cb} if args.cb else {}))
    for lowering in lowerings:
        vocab_cut = dict(layout="panels", tune=False, **cut) if args.cb \
            else dict(nvec=S.VOCAB["nvec"])
        plans[f"vocab {lowering}"] = ops.prepare(
            vocab, lowering=lowering, device=device, **vocab_cut)
        plans[f"fem {lowering}"] = ops.prepare(
            fem, layout="panels", lowering=lowering, tune=False,
            device=device, **cut)
    del vocab, fem
    rng = np.random.default_rng(1)
    times, launches = {}, {}
    for key, plan in plans.items():
        if plan.layout != "panels" or plan.lowering not in key:
            raise S.SmokeFailure(f"{key} plan came out {plan.layout} + "
                                 f"{plan.lowering}")
        S.print_plan(key, plan)
        launches[key] = S.panel_launches(plan)
        x = torch.from_numpy(rng.standard_normal(plan.ncols).astype(
            np.float32)).to(device)
        plain = S.plain_y(plan, x)
        for name, setting, override, split in settings(plan, launches[key]):
            call = S.kernel_call(name, plan, x, split=split)
            saved = {k: getattr(*k) for k in override}
            for (module, attr), value in override.items():
                setattr(module, attr, value)
            try:
                err = S.rel_err(call(), plain)
                if not err <= S.TOL:
                    raise S.SmokeFailure(f"{key} {name} {setting}: {err} > "
                                         f"{S.TOL}")
                ms = S.cuda_time_ms(call, device)
            finally:
                for (module, attr), value in saved.items():
                    setattr(module, attr, value)
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
