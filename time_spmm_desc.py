#!/usr/bin/env python3
"""Sweep a panel SpMM pair's, or a whole-vector SpMM kernel's, knobs on the
yi-6b vocab weight.

    python3 time_spmm_desc.py [--layout panels|whole|tail]
                              [--lowering descriptor|mask|both]
                              [--label NAME] [--out FILE] [--nvec N ...]
                              [--variants NAME ...]

A shorter run than ``chip_smoke.py`` for work on the panel SpMM kernels of
``spc5_spmm_desc.cu`` (descriptor, the default) and ``spc5_spmm.cu``
(``--lowering mask``): it builds the kernels, converts the vocab weight as
``chip_smoke.py`` does (64,000 x 4,096 at density 0.1, beta(4,8)) and
prepares the plan of each asked lowering (panels, through ``ops.prepare``
at nvec 128: the default layer's descriptor plan, or the mask layer's
plan). At each batch (default 16 and 128) it times the pair's
double-buffered kernel (``spmm_cuda_panels_desc_db`` / ``spmm_cuda_panels_db``)
at the launch its wrapper plans and at one knob changed at a time (the
lowering's own module attributes):

  * ``waves1`` / ``waves2`` / ``waves8``: S from 1, 2 or 8 waves of CTAs
    (``spc5_spmv.SPLIT_WAVES``, 4 on the main path); ``split1``: S = 1;
  * ``tile32`` / ``tile64``: the widest column tile (``PANEL_TILE``, 128
    on the main path: 32 lanes of four columns);
  * ``parts8``: at least eight row parts a panel (``PANEL_ROW_PARTS``;
    the main path takes the fewest at which two CTAs fit an SM);
    ``one_cta_an_sm``: the fewest at which one CTA fits;
  * ``stage_chunks1`` / ``stage_chunks2`` / ``stage_chunks4``: chunks a
    stage holds (``PANEL_STAGE_CHUNKS``, on the main path 2 for the
    descriptor pair and 4 for the mask pair, each taken only where an SM
    then holds as many CTAs as with one); ``stage_chunks4_one_cta`` and
    ``stage_chunks4_parts8``: four chunks with ``one_cta_an_sm`` or
    ``parts8``, where the plan can take them;
  * ``threads128`` / ``threads256`` / ``threads512``: threads a CTA
    (``PANEL_THREADS``; the wrapper takes 512 where a lane group is a whole
    warp, else 256);

and the synchronous twin (``spmm_cuda_panels_desc`` / ``spmm_cuda_panels``)
at its planned launch and at S = 1 (``--variants``: only those named, e.g.
``planned``). A variant whose launch lacks what it asks for (the plan
refused it at this batch) is reported as refused and not timed. Every other
variant is first checked against the plain version (within ``1e-5 *
max|Y|``), then timed with CUDA events, L2 flushed before every call. It
prints the card's name and power limit, each variant's launch and time, the
static SASS of the main path's panel kernels of each timed lowering
(``cuobjdump -sass``: instructions, opcode classes, the walk's innermost
loop; the listing of those kernels goes beside ``--out``), one JSON object
``{"label": ..., "card": ..., "times": {"<kernel> nvec=<n> <variant>":
ms}, "launches": {...}, "refused": {...}, "sass": {...}}``, also written to
``--out``, and last the label, card and times alone.

``--layout whole`` sweeps the whole-vector kernel of each asked lowering
instead: ``spmm_cuda_desc`` on the token plan (whole-vector + descriptor,
cb 256, as ``ops.prepare`` builds it at nvec 1) and ``spmm_cuda`` on the
whole-vector mask plan of the same weight, at the launch its wrapper plans
and at one knob changed at a time (module attributes of ``spc5_spmm``,
whose planning both lowerings share):

  * ``grid1``: G = 1; ``one_chunk_a_cta``: G = nchunks; ``waves1`` /
    ``waves2`` / ``waves8``: G from 1, 2 or 8 waves (4 on the main path);
  * ``ring`` / ``one_stage``: rounds in a ring of two stages, or one stage
    (``WHOLE_RING``; the main path takes the ring where an SM then holds as
    many CTAs);
  * ``stage_chunks1`` / ``stage_chunks2`` / ``stage_chunks4``: the most
    chunks a round stages (``WHOLE_STAGE_CHUNKS``, 4 on the main path, taken
    only where an SM still holds as many CTAs);
  * ``tile_rows16`` / ``tile_rows32`` / ``tile_rows64``: rows of the Y tile
    (``WHOLE_TILE_ROWS``, 16 on the main path);
  * ``threads64`` / ``threads128`` / ``threads256`` / ``threads512``:
    threads a CTA (``WHOLE_THREADS``); ``planned_again``: the planned launch once more,
    last, for the spread;

and the SASS counts of the whole-vector kernels of beta(4,8) (one per
columns a lane), with ``ATOMS.CAST`` (a shared-memory float atomic's
compare-and-swap loop) counted apart.

``--layout tail`` sweeps the test split's SpMM tail kernel
(``spmm_tail_cuda``) on the vocab test layer's bucketed tail (the same
weight in beta(2,4) through ``SparseLinear.from_dense(layout="test")``,
``chip_smoke.py``'s test layer (a)) at the launch its wrapper plans and at
one knob changed at a time (attributes of ``spc5_spmv_tail``):

  * ``grid1``: G = 1; ``one_group_a_cta``: G = the groups of 128 slots;
    ``waves2`` / ``waves8``: G from 2 or 8 waves (1/2 and 2 times the 4 of
    the main path);
  * ``tile_rows16`` / ``tile_rows32`` / ``tile_rows64``: rows of the Y tile
    (``SPMM_TAIL_TILE_ROWS``);
  * ``threads128`` / ``threads256`` / ``threads512``: threads a CTA
    (``SPMM_TAIL_THREADS``); ``planned_again``;

beside cuSPARSE on the tail alone (``"library_ms"``), and the SASS counts of
its kernels (one per columns a lane; ``ATOMS`` must be 0).

To compare two versions of the code, unpack one into a directory that
``.gitignore`` lists (``git archive``), copy this script into it, and run
both trees in one call, in the order A, B, B, A. In a tree whose mask
wrapper plans no launch (no ``panels_launch``), the mask pair is timed at
its own launch, printed as ``None``, and every other mask variant is
refused.
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

#: (double-buffered kernel, synchronous twin) of each lowering's pair.
PAIRS = {"descriptor": ("spmm_cuda_panels_desc_db", "spmm_cuda_panels_desc"),
         "mask": ("spmm_cuda_panels_db", "spmm_cuda_panels")}
#: The whole-vector SpMM kernel of each lowering.
WHOLE = {"descriptor": "spmm_cuda_desc", "mask": "spmm_cuda"}


def module(lowering):
    """The wrapper module of the lowering's panel SpMM pair."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmm_desc as KDM
    return KDM if lowering == "descriptor" else KM


def variants(lowering):
    """(name, {(module, attribute): value}, {launch field: value it must
    have}) of the sweep of the lowering's ``_db`` kernel, the planned
    launch first."""
    from repro_torch.kernels import spc5_spmv as K
    M = module(lowering)
    one_cta = {(M, "TWO_CTA_SMEM_BYTES"): 0}
    parts8 = {(M, "PANEL_ROW_PARTS"): 8}
    return ([("planned", {}, {})]
            + [(f"waves{w}", {(K, "SPLIT_WAVES"): w}, {}) for w in (1, 2, 8)]
            + [("split1", {"split": 1}, {"split": 1})]
            + [(f"tile{t}", {(M, "PANEL_TILE"): t}, {"tile_columns": t})
               for t in (32, 64)]
            + [("parts8", parts8, {"row_parts": 8})]
            + [("one_cta_an_sm", one_cta, {})]
            + [(f"stage_chunks{q}", {(M, "PANEL_STAGE_CHUNKS"): q},
                {"chunks_per_stage": q}) for q in (1, 2, 4)]
            + [(f"stage_chunks4_{name}", {(M, "PANEL_STAGE_CHUNKS"): 4,
                                          **knob}, {"chunks_per_stage": 4})
               for name, knob in (("one_cta", one_cta), ("parts8", parts8))]
            + [(f"threads{t}", {(M, "PANEL_THREADS"): t}, {"threads": t})
               for t in (128, 256, 512)])


def whole_variants():
    """(name, settings, {launch field: value it must have}) of the sweep of
    a whole-vector kernel, the planned launch first; a ``grid`` setting
    goes to the wrapper (``"all"``: one chunk a CTA)."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmv as K
    return ([("planned", {}, {}), ("grid1", {"grid": 1}, {"grid": 1}),
             ("one_chunk_a_cta", {"grid": "all"}, {}),
             ("ring", {(KM, "WHOLE_RING"): True}, {"stages": 2}),
             ("one_stage", {(KM, "WHOLE_RING"): False}, {"stages": 1})]
            + [(f"waves{w}", {(K, "SPLIT_WAVES"): w}, {}) for w in (1, 2, 8)]
            + [(f"stage_chunks{q}", {(KM, "WHOLE_STAGE_CHUNKS"): q},
                {"chunks_per_stage": q}) for q in (1, 2, 4)]
            + [(f"tile_rows{t}", {(KM, "WHOLE_TILE_ROWS"): t},
                {"tile_rows": t}) for t in (16, 32, 64)]
            + [(f"threads{t}", {(KM, "WHOLE_THREADS"): t}, {"threads": t})
               for t in (64, 128, 256, 512)]
            + [("planned_again", {}, {})])


def tail_variants():
    """(name, settings, {launch field: value it must have}) of the sweep of
    the SpMM tail kernel, the planned launch first; a ``grid`` setting goes
    to the wrapper (``"all"``: one group of slots a CTA)."""
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_tail as KT
    return ([("planned", {}, {}), ("grid1", {"grid": 1}, {"grid": 1}),
             ("one_group_a_cta", {"grid": "all"}, {})]
            + [(f"waves{w}", {(K, "SPLIT_WAVES"): w}, {}) for w in (2, 8)]
            + [(f"tile_rows{t}", {(KT, "SPMM_TAIL_TILE_ROWS"): t},
                {"tile_rows": t}) for t in (16, 32, 64)]
            + [(f"threads{t}", {(KT, "SPMM_TAIL_THREADS"): t},
                {"threads": t}) for t in (128, 256, 512)]
            + [("planned_again", {}, {})])


def tail_call(plan, x, **kw):
    """A call of ``spmm_tail_cuda`` on the test plan's buckets."""
    from repro_torch.kernels import spc5_spmv_tail as KT
    return lambda: KT.spmm_tail_cuda(
        plan.single_rows, plan.single_cols, plan.single_values, x,
        pr=plan.tail_pr, nrows=plan.nrows, **kw)


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


def launch_of(name, plan, nvec, x, split=None, grid=None):
    """The launch the wrapper of kernel ``name`` plans on the plan at batch
    nvec; None for a kernel of a tree that plans none."""
    if plan.layout == "test":
        return S.tail_launch(plan, nvec, x, grid=grid)
    M = module(plan.lowering)
    if plan.layout == "whole_vector":
        if not hasattr(M, "whole_launch"):
            return None
        geom = dict(cb=plan.cb, r=plan.r, c=plan.c, vmax=plan.vmax,
                    nvec=nvec, vec=M.panels_vector(nvec, x))
        if plan.lowering == "descriptor":
            geom.update(wv=plan.desc_vidx.element_size(),
                        wx=plan.desc_xcol.element_size())
        return M.whole_launch(int(plan.chunk_vbase.shape[0]),
                              device=plan.device, grid=grid, **geom)
    if not hasattr(M, "panels_launch"):
        return None
    stages = M.PANEL_DB_STAGES if name.endswith("_db") else 1
    geom = dict(cb=plan.cb, r=plan.r, c=plan.c, vmax=plan.vmax, pr=plan.pr,
                nvec=nvec, vec=M.panels_vector(nvec, x))
    if plan.lowering == "descriptor":
        geom.update(wv=plan.desc_vidx.element_size(),
                    wx=plan.desc_xcol.element_size())
    return M.panels_launch(stages, plan.npanels, plan.nchunks,
                           device=plan.device, split=split, **geom)


#: Per (layout, lowering): the library of its SpMM kernels and the mangled
#: name of its vocab-layer kernels (beta(4,8); panels: four columns a lane,
#: the ring's stages as group 1; whole-vector: the columns a lane as group
#: 1), and how to print that name.
SASS = {("panels", "descriptor"): (
            "spc5_spmm_desc", r"spmm_desc_panels_kernelILi4ELi8ELi4ELi(\d)E",
            "spmm_desc_panels_kernel<4,8,4,{}>"),
        ("panels", "mask"): (
            "spc5_spmm", r"spmm_panels_kernelILi8ELi4ELi(\d)E",
            "spmm_panels_kernel<8,4,{}>"),
        ("whole", "descriptor"): (
            "spc5_spmm_desc",
            r"spmm_whole_kernelINS_9DescWholeELi4ELi8ELi(\d)E",
            "spmm_whole_kernel<DescWhole,4,8,{}>"),
        ("whole", "mask"): (
            "spc5_spmm", r"spmm_whole_kernelINS_9MaskWholeELi4ELi8ELi(\d)E",
            "spmm_whole_kernel<MaskWhole,4,8,{}>"),
        ("tail", "tail"): (
            "spc5_spmv_tail", r"spmm_tail_kernelILi(\d)E",
            "spmm_tail_kernel<{}>")}


def sass_counts(lowering, out_path, layout="panels"):
    """Static SASS of the layout's and lowering's kernels of beta(4,8) (the
    vocab layer's), from ``cuobjdump -sass`` on the built library:
    {kernel: {"instructions": n, opcode class: n, "walk_loop": n}}, the
    last the instructions of the innermost loop around the walk's FMAs (one
    pass takes a batch of four set lanes); ``ATOMS.CAST`` counts the
    compare-and-swap loops of shared-memory float atomics. The listing goes
    to ``out_path``."""
    from repro_torch.kernels import _build
    lib, pattern, label = SASS[layout, lowering]
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build._lib_path(lib))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    classes = {"LDS": r"LDS\b", "STS": r"STS\b", "LDG": r"LDG\b",
               "FFMA": r"FFMA\b", "ATOMS": r"ATOMS\b",
               "ATOMS.CAST": r"ATOMS\.CAST",
               "RED/ATOMG": r"(RED|REDG|ATOMG)\b", "SHFL": r"SHFL\b",
               "MATCH": r"MATCH\b", "BAR": r"BAR\b",
               "LDGSTS (cp.async)": r"LDGSTS\b",
               "UBLKCP (bulk copy)": r"UBLKCP\b"}
    counts, code, kernel, listing = {}, {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(pattern, m.group(1))
            kernel = label.format(k.group(1)) if k else None
            if kernel:
                counts[kernel] = {"instructions": 0, **{c: 0 for c in classes}}
                code[kernel] = []
        if kernel:
            listing.append(line)
        if m:
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
    with open(out_path, "w") as f:  # the listing of these kernels only
        f.write("\n".join(listing) + "\n")
    print(f"SASS of the vocab layer's {lowering} {layout} kernels: "
          f"{counts}")
    return counts


def sweep(plan, nvecs, names, device, rng):
    """Time the plan's SpMM kernels at each batch: for a panel plan the
    pair's ``_db`` kernel at every variant of :func:`variants` and the twin
    at its planned launch and S = 1; for a whole-vector plan its kernel at
    every variant of :func:`whole_variants` (only the variants in ``names``
    unless None); for a test plan its SpMM tail kernel at every variant of
    :func:`tail_variants`. Returns times, launches and refused variants,
    keyed "<kernel> nvec=<n> <variant>"."""
    import torch
    times, launches, refused = {}, {}, {}
    for nvec in nvecs:
        x = torch.from_numpy(rng.standard_normal(
            (S.VOCAB["cols"], nvec)).astype(np.float32)).to(device)
        if plan.layout == "test":
            plain = S.tail_y(plan, x)
            runs = [(S.SPMM_TAIL_KERNEL, *v) for v in tail_variants()]
        elif plan.layout == "whole_vector":
            plain = S.plain_y(plan, x)
            runs = [(WHOLE[plan.lowering], *v) for v in whole_variants()]
        else:
            plain = S.plain_y(plan, x)
            db, sync = PAIRS[plan.lowering]
            runs = ([(db, *v) for v in variants(plan.lowering)]
                    + [(sync, "planned", {}, {}),
                       (sync, "split1", {"split": 1}, {"split": 1})])
        runs = [run for run in runs if names is None or run[1] in names]
        for name, variant, settings, want in runs:
            extra = {k: settings[k] for k in ("split", "grid")
                     if k in settings}
            if extra.get("grid") == "all":
                extra["grid"] = (
                    -(-plan.single_rows.numel() // 128)
                    if plan.layout == "test"
                    else int(plan.chunk_vbase.shape[0]))
            key = f"{name} nvec={nvec} {variant}"
            launch = with_settings(settings, lambda: launch_of(
                name, plan, nvec, x, **extra))
            if (settings if launch is None
                    else any(launch[k] != v for k, v in want.items())):
                refused[key] = launch
                print(f"refused {key}: the plan's launch {launch} lacks "
                      f"{want or settings}; not timed")
                continue
            call = (tail_call(plan, x, **extra) if plan.layout == "test"
                    else S.kernel_call(name, plan, x, **extra))

            # one CTA walks every chunk: a few calls take long enough
            reps = 3 if extra.get("grid") == 1 else S.REPS

            def run(name=name, call=call, extra=extra, reps=reps):
                err = S.rel_err(call(), plain)
                if not err <= S.TOL:
                    raise S.SmokeFailure(f"{name} nvec={nvec} {variant}: "
                                         f"{err} > {S.TOL}")
                return (err, S.cuda_time_ms(call, device, reps),
                        launch_of(name, plan, nvec, x, **extra))
            err, ms, launch = with_settings(settings, run)
            times[key], launches[key] = ms, launch
            print(f"time {key}: {ms:.4f} ms (max|Y - plain| {err:.3g} of "
                  f"max|Y|); launch {launch}")
        del plain
    return times, launches, refused


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layout", default="panels",
                    choices=("panels", "whole", "tail"))
    ap.add_argument("--lowering", default="descriptor",
                    choices=("descriptor", "mask", "both"))
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
    w, vcsr, mat = S.make_vocab()
    lowerings = (("mask", "descriptor") if args.lowering == "both"
                 else (args.lowering,))
    rng = np.random.default_rng(1)
    times, launches, refused, sass = {}, {}, {}, {}
    library_ms = {}
    if args.layout == "tail":
        plan = S.build_test_layer(w, device).plan
        lowerings = ()
        tail_t = S.scipy_csr(S.tail_parts(plan)[2], device)
        for nvec in args.nvec:
            x = torch.from_numpy(rng.standard_normal(
                (S.VOCAB["cols"], nvec)).astype(np.float32)).to(device)
            print(f"timing cuSPARSE on the tail alone, nvec={nvec}")
            library_ms[nvec] = S.cuda_time_ms(lambda: tail_t @ x, device)
        for out, part in zip((times, launches, refused),
                             sweep(plan, args.nvec, args.variants, device,
                                   rng)):
            out.update(part)
        if args.out:
            sass.update(sass_counts("tail", os.path.splitext(args.out)[0]
                                    + ".tail.sass.txt", "tail"))
    del w
    for lowering in lowerings:
        if args.layout == "whole":
            # the token plan (nvec 1) and the mask plan of the same chunks
            plan = ops.prepare(mat, layout="whole_vector", lowering=lowering,
                               device=device)
        else:
            plan = ops.prepare(mat, lowering=lowering, nvec=S.VOCAB["nvec"],
                               device=device)
            if plan.layout != "panels":
                raise S.SmokeFailure(f"the vocab {lowering} plan came out "
                                     f"{plan.layout}")
        S.print_spmm_plan(f"{plan.layout} {lowering}", plan)
        for out, part in zip((times, launches, refused),
                             sweep(plan, args.nvec, args.variants, device,
                                   rng)):
            out.update(part)
        del plan
        if args.out:
            sass.update(sass_counts(
                lowering, os.path.splitext(args.out)[0]
                + f".{args.layout}.{lowering}.sass.txt", args.layout))
    print(f"total {time.perf_counter() - t0:.1f} s")
    result = {"label": args.label, "card": card, "times": times,
              "launches": launches, "refused": refused, "sass": sass,
              "library_ms": library_ms}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f)
    print(json.dumps(result))
    # last, short enough to survive a cut of the output's head
    print(json.dumps({"label": args.label, "card": card, "times": times}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except S.SmokeFailure as e:
        print(f"time_spmm_desc FAILED: {e}", file=sys.stderr)
        sys.exit(1)
