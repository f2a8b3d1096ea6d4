#!/usr/bin/env python3
"""Sweep the panel descriptor SpMM pair's knobs on the yi-6b vocab weight.

    python3 time_spmm_desc.py [--label NAME] [--out FILE] [--nvec N ...]
                              [--variants NAME ...]

A shorter run than ``chip_smoke.py`` for work on ``spc5_spmm_desc.cu``: it
builds the kernels, converts the vocab weight as ``chip_smoke.py`` does
(64,000 x 4,096 at density 0.1, beta(4,8)) and prepares the default layer's
plan (panels + descriptor, through ``ops.prepare`` at nvec 128). At each
batch (default 16 and 128) it times ``spmm_cuda_panels_desc_db`` at the
launch its wrapper plans and at one knob changed at a time:

  * ``waves1`` / ``waves2`` / ``waves8``: S from 1, 2 or 8 waves of CTAs
    (``spc5_spmv.SPLIT_WAVES``, 4 on the main path); ``split1``: S = 1;
  * ``tile32`` / ``tile64``: the widest column tile (``PANEL_TILE``, 128
    on the main path: 32 lanes of four columns);
  * ``parts8``: at least eight row parts a panel (``PANEL_ROW_PARTS``;
    the main path takes the fewest at which two CTAs fit an SM);
    ``one_cta_an_sm``: the fewest at which one CTA fits;
  * ``stage_chunks1`` / ``stage_chunks4``: chunks a stage holds
    (``PANEL_STAGE_CHUNKS``, 2 on the main path, taken only where an SM
    then holds as many CTAs as with one); ``stage_chunks4_one_cta`` and
    ``stage_chunks4_parts8``: four chunks with ``one_cta_an_sm`` or
    ``parts8``, where the plan can take them;
  * ``threads128`` / ``threads256`` / ``threads512``: threads a CTA
    (``PANEL_THREADS``; the wrapper takes 512 where a lane group is a whole
    warp, else 256);

and ``spmm_cuda_panels_desc`` at its planned launch (``--variants``: only
those named, e.g. ``planned``). A variant whose launch lacks what it asks
for (the plan refused it at this batch) is reported as refused and not
timed. Every other variant is first checked against the plain version
(within ``1e-5 * max|Y|``), then timed with CUDA events, L2 flushed before
every call. It prints the card's name
and power limit, each variant's launch and time, the static SASS of the
main path's panel kernels (``cuobjdump -sass``: instructions, opcode
classes, the walk's innermost loop; the listing goes beside ``--out``) and
last one JSON object ``{"label": ..., "card": ..., "times": {"<kernel>
nvec=<n> <variant>": ms}, "launches": {...}, "refused": {...}, "sass":
{...}}``, also written to ``--out``.

To compare two versions of the code, unpack one into a directory that
``.gitignore`` lists (``git archive``) and run both trees in one call, in
the order A, B, B, A.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

import chip_smoke as S

DB = "spmm_cuda_panels_desc_db"
SYNC = "spmm_cuda_panels_desc"


def variants():
    """(name, {(module, attribute): value}, {launch field: value it must
    have}) of the sweep, the planned launch first."""
    from repro_torch.kernels import spc5_spmm_desc as KDM
    from repro_torch.kernels import spc5_spmv as K
    one_cta = {(KDM, "TWO_CTA_SMEM_BYTES"): 0}
    parts8 = {(KDM, "PANEL_ROW_PARTS"): 8}
    return ([("planned", {}, {})]
            + [(f"waves{w}", {(K, "SPLIT_WAVES"): w}, {}) for w in (1, 2, 8)]
            + [("split1", {"split": 1}, {"split": 1})]
            + [(f"tile{t}", {(KDM, "PANEL_TILE"): t}, {"tile_columns": t})
               for t in (32, 64)]
            + [("parts8", parts8, {"row_parts": 8})]
            + [("one_cta_an_sm", one_cta, {})]
            + [(f"stage_chunks{q}", {(KDM, "PANEL_STAGE_CHUNKS"): q},
                {"chunks_per_stage": q}) for q in (1, 4)]
            + [(f"stage_chunks4_{name}", {(KDM, "PANEL_STAGE_CHUNKS"): 4,
                                          **knob}, {"chunks_per_stage": 4})
               for name, knob in (("one_cta", one_cta), ("parts8", parts8))]
            + [(f"threads{t}", {(KDM, "PANEL_THREADS"): t}, {"threads": t})
               for t in (128, 256, 512)])


def with_settings(settings, fn):
    """Run fn() with the module attributes of ``settings`` replaced."""
    saved = {k: getattr(*k) for k in settings if isinstance(k, tuple)}
    try:
        for k, v in settings.items():
            if isinstance(k, tuple):
                setattr(k[0], k[1], v)
        return fn()
    finally:
        for (mod, attr), v in saved.items():
            setattr(mod, attr, v)


def launch_of(name, plan, nvec, x, split=None):
    from repro_torch.kernels import spc5_spmm_desc as KDM
    stages = KDM.PANEL_DB_STAGES if name == DB else 1
    return KDM.panels_launch(
        stages, plan.npanels, plan.nchunks, cb=plan.cb, r=plan.r, c=plan.c,
        vmax=plan.vmax, pr=plan.pr, nvec=nvec,
        vec=KDM.panels_vector(nvec, x), wv=plan.desc_vidx.element_size(),
        wx=plan.desc_xcol.element_size(), device=plan.device, split=split)


def sass_counts(out_path):
    """Static SASS of the panel kernels of beta(4,8), four columns a lane
    (the vocab layer's), from ``cuobjdump -sass`` on the built library:
    {kernel: {"instructions": n, opcode class: n, "walk_loop": n}}, the
    last the instructions of the innermost loop around the block walk's
    FMAs (one pass takes a batch of four set lanes); the listing goes to
    ``out_path``."""
    from repro_torch.kernels import _build
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build._lib_path(
        "spc5_spmm_desc"))], capture_output=True, text=True, timeout=120,
        check=True).stdout
    with open(out_path, "w") as f:
        f.write(text)
    classes = {"LDS": r"LDS\b", "STS": r"STS\b", "LDG": r"LDG\b",
               "FFMA": r"FFMA\b", "ATOMS": r"ATOMS\b",
               "RED/ATOMG": r"(RED|REDG|ATOMG)\b", "SHFL": r"SHFL\b",
               "MATCH": r"MATCH\b", "BAR": r"BAR\b",
               "LDGSTS (cp.async)": r"LDGSTS\b",
               "UBLKCP (bulk copy)": r"UBLKCP\b"}
    counts, code, kernel = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(r"spmm_desc_panels_kernelILi4ELi8ELi4ELi(\d)E",
                          m.group(1))
            kernel = f"spmm_desc_panels_kernel<4,8,4,{k.group(1)}>" if k \
                else None
            if kernel:
                counts[kernel] = {"instructions": 0, **{c: 0 for c in classes}}
                code[kernel] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                       r"([A-Z][\w.]*)(.*)", line)
        if kernel and ins:
            counts[kernel]["instructions"] += 1
            code[kernel].append((int(ins.group(1), 16), ins.group(3),
                                 ins.group(4)))
            for c, pat in classes.items():
                if re.match(pat, ins.group(3)):
                    counts[kernel][c] += 1
    for kernel, ins in code.items():
        loops = []      # (first, last) address of each backward branch's loop
        for addr, op, rest in ins:
            t = re.match(r"\s*0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < addr:
                loops.append((int(t.group(1), 16), addr))
        sizes = [len([op for a, op, _ in ins if lp[0] <= a <= lp[1]])
                 for lp in loops
                 if any(op.startswith("FFMA") for a, op, _ in ins
                        if lp[0] <= a <= lp[1])]
        counts[kernel]["walk_loop"] = min(sizes or [0])
    print(f"SASS of the vocab layer's panel kernels: {counts}")
    return counts


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--nvec", type=int, nargs="+", default=list(S.SPMM_NVECS))
    ap.add_argument("--variants", nargs="+", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_spmm_desc: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ops
    device = torch.device("cuda")
    card = S.card_line()
    print(card)
    t0 = time.perf_counter()
    S.build_kernels()
    _, _, mat = S.make_vocab()
    plan = ops.prepare(mat, lowering="descriptor", nvec=S.VOCAB["nvec"],
                       device=device)
    del mat
    if plan.layout != "panels":
        raise S.SmokeFailure(f"the vocab plan came out {plan.layout}")
    S.print_spmm_plan("panels descriptor", plan)
    rng = np.random.default_rng(1)
    times, launches, refused = {}, {}, {}
    for nvec in args.nvec:
        x = torch.from_numpy(rng.standard_normal(
            (S.VOCAB["cols"], nvec)).astype(np.float32)).to(device)
        plain = S.plain_y(plan, x)
        runs = ([(DB, *v) for v in variants()]
                + [(SYNC, "planned", {}, {})])
        runs = [run for run in runs
                if args.variants is None or run[1] in args.variants]
        for name, variant, settings, want in runs:
            extra = {"split": settings["split"]} if "split" in settings \
                else {}
            key = f"{name} nvec={nvec} {variant}"
            launch = with_settings(settings, lambda: launch_of(
                name, plan, nvec, x, **extra))
            if any(launch[k] != v for k, v in want.items()):
                refused[key] = launch
                print(f"refused {key}: the plan's launch {launch} lacks "
                      f"{want}; not timed")
                continue
            call = S.kernel_call(name, plan, x, **extra)

            def run(name=name, call=call, extra=extra):
                err = S.rel_err(call(), plain)
                if not err <= S.TOL:
                    raise S.SmokeFailure(f"{name} nvec={nvec} {variant}: "
                                         f"{err} > {S.TOL}")
                return (err, S.cuda_time_ms(call, device),
                        launch_of(name, plan, nvec, x, **extra))
            err, ms, launch = with_settings(settings, run)
            times[key], launches[key] = ms, launch
            print(f"time {key}: {ms:.4f} ms (max|Y - plain| {err:.3g} of "
                  f"max|Y|); launch {launch}")
        del plain
    sass = {}
    if args.out:
        sass = sass_counts(os.path.splitext(args.out)[0] + ".sass.txt")
    print(f"total {time.perf_counter() - t0:.1f} s")
    result = {"label": args.label, "card": card, "times": times,
              "launches": launches, "refused": refused, "sass": sass}
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
