#!/usr/bin/env python3
"""Time the SpMV kernels of one layout at other launch settings.

    python3 time_panels_desc.py [--layout panels|whole|tail]
                                [--lowering mask|descriptor|both] [--cb N]
                                [--label NAME] [--out FILE]
    python3 time_panels_desc.py --against DIR [--sass-only] [--out FILE]

A shorter run than ``chip_smoke.py`` for work on the SpMV kernels of
``spc5_spmv.cu`` (mask) and ``spc5_spmv_desc.cu`` (descriptor). It builds
the kernels and prepares the plans ``chip_smoke.py`` times at batch 1,
yi-6b's 64,000 x 4,096 vocab weight at density 0.1 in beta(4,8) and the FEM
matrix (``--cb``: those two plans cut into chunks of N blocks instead):

* ``--layout panels`` (the default): the panel plans (the vocab weight
  through ``ops.prepare(lowering=..., nvec=128)``; the FEM matrix at pr=512,
  cb=64, xw=512) in each asked lowering. Both panel SpMV kernels of the
  lowering at S = 1 and at 1/2, 1, 2, 3 and 4 times the S the wrapper picks
  (capped at nchunks), the double-buffered one with rings of 2 and 3
  (``DB_STAGES`` replaced for the call), and the mask kernels with 1, 2 and
  4 block rows a thread (``ROWS_PER_THREAD``, which sets the CTA's threads
  and so S).
* ``--layout whole``: the whole-vector plans of each asked lowering.
  Descriptor: the vocab weight's token plan (``ops.prepare`` at nvec 1),
  the FEM matrix at cb=256 and the flat-tail test plan's multi sub-plan
  (the same weight in beta(2,4)); both ``spmv_cuda_desc`` kernels at 1/2,
  1 and 2 times the grid G the wrapper picks and at one chunk a CTA; with y
  tiles of 64 and 4,096 rows (``WHOLE_TILE_ROWS``), one and four lane
  quads a thread (``WHOLE_QUADS_PER_THREAD``) and 256 threads a CTA at
  most (``WHOLE_THREADS``), each replaced for the call; and with the
  card's L2 fetch granularity set to 32 bytes (``cuCtxSetLimit``, restored
  after the setting; it asks L2 to fetch only the 32-byte sectors a kernel
  reads of the repeated ``xcol`` / ``yrow`` entries); beside them plain
  torch sums reading each whole plan and the parts of it the kernels read
  (``chip_smoke.plan_read_ms``). Mask: the vocab weight's whole-vector
  mask layer (``ops.prepare(layout="whole_vector", lowering="mask",
  nvec=128)``, ``chip_smoke.py``'s) and the FEM matrix at cb=256; both
  ``spmv_cuda`` kernels at 1/2, 1 and 2 times G and at one chunk a CTA,
  and at each pair of 4, 8 and 16 block rows a thread
  (``WHOLE_ROWS_PER_THREAD`` and ``WHOLE_SPARSE_ROWS_PER_THREAD``: 256,
  128 and 64 threads on both plans) and warp tiles of 16, 32, 128 and 512
  rows (``WHOLE_TILE_ROWS``), each replaced for the call. Then the static
  SASS of the asked whole-vector kernels (``cuobjdump -sass``:
  instructions per kernel and the counts of
  the loads, atomics, shuffles, votes and barriers among them; the
  listings are written beside ``--out``).
* ``--layout tail``: the test split's SpMV tail kernel (``spmv_tail_cuda``)
  on the vocab test layer's tail (the same weight in beta(2,4) through
  ``SparseLinear.from_dense(layout="test")``, ``chip_smoke.py``'s test
  layer (a): 125 buckets of about 64 K slots) at S = 1, 1/2, 1 and 2 times
  the S the wrapper picks and one group of slots a CTA, and at the other
  two of 128, 256 and 512 threads a CTA (``TAIL_THREADS``, replaced for the
  call), each with the smoke's L2 flush (a 512 MiB write) and the planned
  launch also with a clean one (a read, which leaves no dirty line for the
  kernel's reads to write back), beside cuSPARSE on the tail alone and
  plain torch sums reading the three bucket arrays, each with both
  flushes; then the static SASS of both tail kernels (SpMV and SpMM:
  ``ATOMS`` must be 0).

``--against DIR`` compares this tree with another checkout of the
repository unpacked in DIR (the parent commit's ``git archive``, say)
instead: (1) the static SASS of every kernel of the five CUDA sources,
both trees' compiled by nvcc into cubins side by side (``cuobjdump
-sass``, the names demangled, each instantiation matched by name and
template arguments): the kernels whose opcode sequences differ, with their
instruction counts and ``-Xptxas -v`` registers, counted for the f32
instantiations (matched without their value type, which older trees lack)
and for every instantiation DIR has, narrow ones too (kernels only this
tree has, such as the column-map kernels, are new, not compared); (2)
unless ``--sass-only``, the f32 whole-vector descriptor SpMV pair on the
vocab token plan and the four mask SpMV kernels at bf16 and int8 on the
vocab mask layers, each timed in a subprocess of each tree with that
tree's own wrappers and kernels, in turns (DIR, this, this, DIR), on the
same seeded inputs.

Every setting is first held against the plain version (within ``1e-5 *
max|y|``) and timed with CUDA events, L2 flushed before every call. It
prints the card's name and power limit, one line per plan, kernel and
setting, and last one JSON object ``{"label": ..., "card": ..., "launch":
{plan: {"s1": ..., "s2": ...}}, "times": {"<plan> <kernel> <setting>":
ms}}`` (``--layout whole`` adds ``"read_ms"`` and ``"sass"``, ``--layout
tail`` those and ``"library_ms"``), also written to ``--out``.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

import chip_smoke as S

KERNELS = {"descriptor": {"spmv_cuda_panels_desc_db": "s2",
                          "spmv_cuda_panels_desc": "s1"},
           "mask": {"spmv_cuda_panels_db": "s2", "spmv_cuda_panels": "s1"}}

#: CU_LIMIT_MAX_L2_FETCH_GRANULARITY of the CUDA driver API.
_L2_FETCH_LIMIT = 5


@contextlib.contextmanager
def l2_fetch_granularity(nbytes):
    """The current context's L2 fetch granularity set to ``nbytes`` (a hint
    to the card) for the block, then restored."""
    if nbytes is None:
        yield
        return
    cuda = ctypes.CDLL("libcuda.so.1")
    old = ctypes.c_size_t(0)
    if cuda.cuCtxGetLimit(ctypes.byref(old), _L2_FETCH_LIMIT) != 0:
        raise S.SmokeFailure("cuCtxGetLimit(MAX_L2_FETCH_GRANULARITY) failed")
    if cuda.cuCtxSetLimit(_L2_FETCH_LIMIT, ctypes.c_size_t(nbytes)) != 0:
        raise S.SmokeFailure("cuCtxSetLimit(MAX_L2_FETCH_GRANULARITY) failed")
    print(f"    L2 fetch granularity {nbytes} bytes (default {old.value})")
    try:
        yield
    finally:
        cuda.cuCtxSetLimit(_L2_FETCH_LIMIT, old)


def panel_settings(plan, launch):
    """(kernel, setting, module overrides, wrapper keywords, L2 fetch
    bytes) to time on a panel plan."""
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    module = KD if plan.lowering == "descriptor" else K
    out = []
    for name, key in KERNELS[plan.lowering].items():
        auto = launch[key]["split"]
        splits = {1, max(1, auto // 2)} | {min(plan.nchunks, m * auto)
                                           for m in (1, 2, 3, 4)}
        out += [(name, f"split{s}", {}, {"split": s}, None)
                for s in sorted(splits)]
        if module is K:
            out += [(name, f"rows{k}", {(K, "ROWS_PER_THREAD"): k}, {}, None)
                    for k in (1, 2, 4) if k != K.ROWS_PER_THREAD]
    db = next(iter(KERNELS[plan.lowering]))
    out += [(db, f"ring{s}", {(module, "DB_STAGES"): s}, {}, None)
            for s in (2, 3)]
    return out


#: Block rows a thread and warp-tile rows the whole-vector mask kernels are
#: timed at (for either kind of plan, dense or sparse block rows); the
#: wrapper's own pair is among them, a second timing of its launch.
MASK_ROWS = (4, 8, 16)
MASK_TILES = (16, 32, 128, 512)


def whole_settings(plan, launch):
    """The same for a whole-vector plan of either lowering."""
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    nchunks = int(plan.chunk_vbase.shape[0])
    desc = plan.lowering == "descriptor"
    out = []
    for name, key in S.WHOLE_SPMV[plan.lowering].items():
        auto = launch[key]["grid"]
        grids = {max(1, auto // 2), auto, min(nchunks, 2 * auto), nchunks}
        out += [(name, f"grid{g}", {}, {"grid": g}, None)
                for g in sorted(grids)]
        if desc:
            out += [(name, f"tile{t}", {(KD, "WHOLE_TILE_ROWS"): t}, {},
                     None) for t in (64, 4096)]
            out += [(name, "fetch32", {}, {}, 32)]
            out += [(name, f"quads{q}", {(KD, "WHOLE_QUADS_PER_THREAD"): q},
                     {}, None) for q in (1, 4)]
            out += [(name, "threads256", {(KD, "WHOLE_THREADS"): 256}, {},
                     None)]
        else:
            out += [(name, f"rows{k}_tile{t}",
                     {(K, "WHOLE_ROWS_PER_THREAD"): k,
                      (K, "WHOLE_SPARSE_ROWS_PER_THREAD"): k,
                      (K, "WHOLE_TILE_ROWS"): t}, {}, None)
                    for k in MASK_ROWS for t in MASK_TILES]
    return out


#: The library whose SASS ``--layout whole`` (per lowering) or ``--layout
#: tail`` counts, and the mangled names of its kernels counted (group 1 the
#: kernel, group 2 a template argument where it has one).
WHOLE_SASS = {"descriptor": ("spc5_spmv_desc",
                             r"\d(spmv_desc_whole_kernel)IfLi(\d)E"),
              "mask": ("spc5_spmv", r"\d(spmv_whole_kernel)IfLi(\d)E"),
              "tail": ("spc5_spmv_tail",
                       r"\d(sp(?:mv|mm)_tail_kernel)If(?:Li(\d)E)?E")}


def sass_counts(out_path, lowering):
    """Static SASS of the lowering's whole-vector kernels (or, for
    ``"tail"``, both tail kernels) from ``cuobjdump -sass`` on the built
    library: {kernel: {"instructions": n, opcode
    class: n, "decode_loop": n, "chunk_loop": n}}, the last two the
    instructions of the innermost loop around a shuffle and of the
    outermost one around the stage wait (every width's path counted; a
    thread runs one); the listing goes to ``out_path``."""
    from repro_torch.kernels import _build
    library, pattern = WHOLE_SASS[lowering]
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", str(_build._lib_path(library))],
                          capture_output=True, text=True, timeout=120,
                          check=True).stdout
    with open(out_path, "w") as f:
        f.write(text)
    classes = {"LDS": r"LDS\b", "LDG": r"LDG\b", "ATOMS": r"ATOMS\b",
               "RED/ATOMG": r"(REDG?|ATOMG)\b", "SHFL": r"SHFL\b",
               "VOTE": r"VOTEU?\b", "BAR": r"BAR\b",
               "LDGSTS (cp.async)": r"LDGSTS\b",
               "UBLKCP (bulk copy)": r"UBLKCP\b", "SYNCS (mbarrier)":
               r"SYNCS\b"}
    counts, code, kernel = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            k = re.search(pattern, m.group(1))
            kernel = (None if not k else f"{k.group(1)}<{k.group(2)}>"
                      if k.group(2) else k.group(1))
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

        def size(loop, ops):
            body = [op for a, op, _ in ins if loop[0] <= a <= loop[1]]
            return len(body) if any(o.startswith(ops) for o in body) else 0
        decode = [size(lp, "SHFL") for lp in loops]
        chunk = [size(lp, "SYNCS.PHASECHK") for lp in loops]
        counts[kernel]["decode_loop"] = min([n for n in decode if n] or [0])
        counts[kernel]["chunk_loop"] = max(chunk or [0])
    print(f"SASS of the {lowering} kernels: {counts}")
    return counts


def tail_settings(plan, launch):
    """(kernel, setting, module overrides, wrapper keywords, L2 fetch
    bytes) to time on a test plan's bucketed tail."""
    from repro_torch.kernels import spc5_spmv_tail as KT
    auto, groups = launch["split"], launch["groups"]
    splits = sorted({1, max(1, auto // 2), auto, min(groups, 2 * auto),
                     groups})
    return ([(S.TAIL_KERNEL, f"split{s}", {}, {"split": s}, None)
             for s in splits]
            + [(S.TAIL_KERNEL, f"threads{t}", {(KT, "TAIL_THREADS"): t}, {},
                None) for t in (128, 256, 512) if t != KT.TAIL_THREADS])


def tail_call(plan, x, **kw):
    """A call of ``spmv_tail_cuda`` on the plan's buckets."""
    from repro_torch.kernels import spc5_spmv_tail as KT
    args, akw, _ = S.tail_parts(plan)
    return lambda: KT.spmv_tail_cuda(*args, x, **akw, **kw)


def build_plans(args, device):
    """{name: plan} for ``--layout`` and ``--lowering``."""
    from repro_torch.kernels import ops
    w, vcsr, vocab = S.make_vocab()
    if args.layout == "tail":
        return {"test tail": S.build_test_layer(w, device).plan}
    del w
    _, fem = S.make_matrix()
    plans = {}
    lowerings = (("mask", "descriptor") if args.lowering == "both"
                 else (args.lowering,))
    if args.layout == "whole":
        cut = {"cb": args.cb} if args.cb else {}
        fem_geom = dict(S.GEOM["whole_vector"], **cut)
        if "mask" in lowerings:
            vocab_cut = (dict(tune=False, **cut) if args.cb
                         else dict(nvec=S.VOCAB["nvec"]))
            plans["vocab mask"] = ops.prepare(
                vocab, layout="whole_vector", lowering="mask",
                device=device, **vocab_cut)
            plans["fem mask"] = ops.prepare(
                fem, layout="whole_vector", lowering="mask", tune=False,
                device=device, **fem_geom)
        if "descriptor" in lowerings:
            plans["token"] = (ops.prepare(vocab, device=device, tune=False,
                                          **cut)
                              if args.cb else ops.prepare(vocab,
                                                          device=device))
            plans["fem"] = ops.prepare(
                fem, layout="whole_vector", lowering="descriptor",
                tune=False, device=device, **fem_geom)
            plans["flat"] = S.build_flat_test_plan(vcsr, device).multi
        return plans
    cut = dict(S.GEOM["panels"], **({"cb": args.cb} if args.cb else {}))
    for lowering in lowerings:
        vocab_cut = dict(layout="panels", tune=False, **cut) if args.cb \
            else dict(nvec=S.VOCAB["nvec"])
        plans[f"vocab {lowering}"] = ops.prepare(
            vocab, lowering=lowering, device=device, **vocab_cut)
        plans[f"fem {lowering}"] = ops.prepare(
            fem, layout="panels", lowering=lowering, tune=False,
            device=device, **cut)
    return plans


#: The CUDA sources whose f32 kernels ``--against`` compares.
AGAINST_SOURCES = ("spc5_spmv", "spc5_spmm", "spc5_spmv_desc",
                   "spc5_spmm_desc", "spc5_spmv_tail")

#: What ``--against`` times in both trees: (plan, value store, kernel).
AGAINST_TIMES = (("token", "f32", "spmv_cuda_desc_db"),
                 ("token", "f32", "spmv_cuda_desc"),
                 *((plan, vdtype, name) for vdtype in ("bf16", "int8")
                   for plan, name in (("whole_mask", "spmv_cuda_db"),
                                      ("whole_mask", "spmv_cuda"),
                                      ("panel_mask", "spmv_cuda_panels_db"),
                                      ("panel_mask", "spmv_cuda_panels"))))

#: A subprocess of one tree (its root the working directory): builds the
#: vocab plans ``chip_smoke.py`` builds, holds each kernel against its plain
#: version, times it and prints {"<plan> <vdtype> <kernel>": ms} last.
_AGAINST_CHILD = r"""
import json, sys
sys.path[:0] = ["src", "."]
import numpy as np, torch
import chip_smoke as S
from repro_torch.kernels import ops
dev = torch.device("cuda")
_, _, mat = S.make_vocab()
x = torch.from_numpy(np.random.default_rng(1).standard_normal(
    mat.ncols).astype(np.float32)).to(dev)
kw = {"token": {}, "whole_mask": dict(layout="whole_vector", lowering="mask",
                                      nvec=128),
      "panel_mask": dict(layout="panels", lowering="mask", nvec=128)}
plans, out = {}, {}
for plan, vdtype, name in json.loads(sys.argv[1]):
    if (plan, vdtype) not in plans:
        extra = {} if vdtype == "f32" else {"vdtype": vdtype}
        plans[plan, vdtype] = ops.prepare(mat, device=dev, **kw[plan], **extra)
    p = plans[plan, vdtype]
    call = S.kernel_call(name, p, x)
    err = S.rel_err(call(), S.plain_y(p, x))
    if not err <= S.TOL:
        raise SystemExit(f"{plan} {vdtype} {name}: {err}")
    out[f"{plan} {vdtype} {name}"] = S.cuda_time_ms(call, dev)
print(json.dumps(out))
"""


def _compile_cubins(csrc, out_dir, tag):
    """nvcc (``_build.NVCC_FLAGS``, to a cubin) started on every
    :data:`AGAINST_SOURCES` file of ``csrc``: {source: (cubin, process)}."""
    from repro_torch.kernels import _build
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-shared", "-Xcompiler",
                                                       "-fPIC")]
    out = {}
    for name in AGAINST_SOURCES:
        cubin = os.path.join(out_dir, f"{tag}.{name}.cubin")
        out[name] = (cubin, subprocess.Popen(
            [_build.nvcc_path(), *flags, "-cubin", "-o", cubin,
             os.path.join(csrc, f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    return out


def _sass_opcodes(cubin):
    """{mangled kernel: [opcode, ...]} of a cubin (predicates dropped)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    text = subprocess.run([tool, "-sass", cubin], capture_output=True,
                          text=True, timeout=600, check=True).stdout
    out, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if m and cur is not None:
            ins = re.sub(r"^@!?U?P\w+\s+", "", m.group(1).strip())
            cur.append(ins.split()[0] if ins else "")
    return out


def _f32_key(mangled, demangled):
    """The kernel's name and template arguments with its f32 value type
    left out (the parent may not have had that parameter); None for a
    narrow instantiation (bf16, int8)."""
    if "bfloat16" in demangled or "signed char" in demangled:
        return None
    k = demangled[5:] if demangled.startswith("void ") else demangled
    k = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", k)
    k = re.sub(r"\((?:int|unsigned int|bool)\)", "", k).split("(")[0]
    return k.replace("<float>", "").replace("float, ", "").strip()


def _kernel_key(demangled):
    """The kernel's name and template arguments, every value type kept."""
    k = demangled[5:] if demangled.startswith("void ") else demangled
    k = re.sub(r"\(anonymous namespace\)::|<unnamed>::", "", k)
    return re.sub(r"\((?:int|unsigned int|bool)\)", "", k).split("(")[0]


def _ptxas(log):
    """{mangled: registers line, mangled + "#stack": stack line} of an
    ``-Xptxas -v`` log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = m.group(1)
        elif cur and "Used" in line:
            out[cur] = line.split(":", 1)[1].strip()
        elif cur and "bytes stack frame" in line:
            out[cur + "#stack"] = line.strip()
    return out


def against(other, sass_only=False):
    """``--against DIR``: the SASS comparison and (unless ``sass_only``) the
    timings in turns (see the module docstring), the cubins in a temporary
    directory. Returns the result."""
    with tempfile.TemporaryDirectory() as work:
        return _against(os.path.abspath(other), work, sass_only)


def _against(other, work, sass_only=False):
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    runs = {"this": _compile_cubins(str(_build.CSRC), work, "this"),
            "other": _compile_cubins(os.path.join(
                other, "src", "repro_torch", "kernels", "csrc"), work,
                "other")}
    built = {}
    for tag, procs in runs.items():
        for name, (cubin, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode:
                raise S.SmokeFailure(f"{tag} {name}: nvcc failed\n{log}")
            built[tag, name] = (cubin, log)
    print(f"against: both trees' cubins built in "
          f"{time.perf_counter() - t0:.1f} s")
    filt = (shutil.which("cu++filt") or shutil.which("c++filt")
            or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                            "bin", "cu++filt"))
    sass = {}
    for name in AGAINST_SOURCES:
        ops_, keys, regs = {}, {}, {}
        for tag in runs:
            ops_[tag] = _sass_opcodes(built[tag, name][0])
            dem = subprocess.run([filt], input="\n".join(ops_[tag]),
                                 capture_output=True, text=True,
                                 check=True).stdout.splitlines()
            keys[tag] = {m: d for m, d in zip(ops_[tag], dem)}
            regs[tag] = _ptxas(built[tag, name][1])
        f32 = {tag: {_f32_key(m, d): m for m, d in keys[tag].items()
                     if _f32_key(m, d) is not None} for tag in runs}
        same = [k for k, m in f32["other"].items()
                if k in f32["this"] and ops_["this"][f32["this"][k]]
                == ops_["other"][m]]
        differ = {k: {"instructions": [len(ops_["other"][m]),
                                       len(ops_["this"][f32["this"][k]])],
                      "registers": [regs["other"].get(m),
                                    regs["this"].get(f32["this"][k])]}
                  for k, m in f32["other"].items()
                  if k in f32["this"] and k not in same}
        missing = sorted(k for k in f32["other"] if k not in f32["this"])
        narrow = {d: [regs["this"].get(m), regs["this"].get(m + "#stack")]
                  for m, d in keys["this"].items()
                  if _f32_key(m, d) is None}
        every = {tag: {_kernel_key(d): m for m, d in keys[tag].items()}
                 for tag in runs}
        all_same = [k for k, m in every["other"].items()
                    if k in every["this"]
                    and ops_["this"][every["this"][k]] == ops_["other"][m]]
        all_differ = sorted(k for k in every["other"]
                            if k in every["this"] and k not in all_same)
        new = sorted(k for k in every["this"] if k not in every["other"])
        sass[name] = {"f32_kernels": len(f32["other"]), "same": len(same),
                      "differ": differ, "missing": missing,
                      "narrow": narrow,
                      "all_kernels": len(every["other"]),
                      "all_same": len(all_same), "all_differ": all_differ,
                      "new": new}
        print(f"SASS {name}: {len(f32['other'])} f32 kernels in {other}, "
              f"{len(same)} with the same opcodes here, {len(differ)} "
              f"differ, {len(missing)} missing; {len(narrow)} narrow ones; "
              f"every instantiation: {len(every['other'])} in {other}, "
              f"{len(all_same)} the same here, {len(all_differ)} differ, "
              f"{len(new)} new here")
        for k in all_differ:
            print(f"  differs (any width): {k}")
        for k, d in differ.items():
            print(f"  differs: {k}: {d['instructions'][0]} -> "
                  f"{d['instructions'][1]} instructions; registers "
                  f"{d['registers'][0]} -> {d['registers'][1]}")
    times = {"other": [], "this": []}
    for tag in (() if sass_only else ("other", "this", "this", "other")):
        root = other if tag == "other" else S.HERE
        print(f"against: timing in {tag} ({root})")
        proc = subprocess.run(
            [sys.executable, "-c", _AGAINST_CHILD,
             json.dumps(AGAINST_TIMES)], cwd=root, capture_output=True,
            text=True, timeout=1200)
        if proc.returncode:
            raise S.SmokeFailure(f"{tag}: {proc.stderr[-2000:]}")
        times[tag].append(json.loads(proc.stdout.strip().splitlines()[-1]))
    result = {"card": S.card_line(), "other": other, "sass": sass,
              "times": {}}
    for plan, vdtype, name in (() if sass_only else AGAINST_TIMES):
        key = f"{plan} {vdtype} {name}"
        t = {tag: [run[key] for run in runs_] for tag, runs_ in times.items()}
        ratio = np.mean(t["this"]) / np.mean(t["other"])
        result["times"][key] = dict(t, ratio=ratio)
        print(f"time {key}: {other} {t['other']}, this {t['this']} ms; "
              f"{ratio:.4f}x")
    return result


def main() -> int:
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layout", default="panels",
                    choices=("panels", "whole", "tail"))
    ap.add_argument("--lowering", default="both",
                    choices=("mask", "descriptor", "both"),
                    help="the plans' lowering")
    ap.add_argument("--cb", type=int, default=0,
                    help="chunk size of both plans (default: their own)")
    ap.add_argument("--label", default="")
    ap.add_argument("--out", default="")
    ap.add_argument("--against", default="",
                    help="compare with the tree in this directory instead")
    ap.add_argument("--sass-only", action="store_true",
                    help="with --against: compare the SASS, time nothing")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_panels_desc: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = S.card_line()
    print(card)
    if args.against:
        result = against(args.against, args.sass_only)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(result, f)
        print(json.dumps({k: v for k, v in result.items() if k != "sass"}))
        return 0
    t0 = time.perf_counter()
    S.build_kernels()
    plans = build_plans(args, device)
    whole, tail = args.layout == "whole", args.layout == "tail"
    rng = np.random.default_rng(1)
    times, launches, read_ms, library_ms = {}, {}, {}, {}
    for key, plan in plans.items():
        x = torch.from_numpy(rng.standard_normal(plan.ncols).astype(
            np.float32)).to(device)
        if tail:
            if not plan.tail_pr:
                raise S.SmokeFailure(f"{key}: the tail is not bucketed")
            launches[key] = S.tail_launch(plan)
            print(f"plan {key}: buckets {tuple(plan.single_rows.shape)}, "
                  f"pr {plan.tail_pr}, xw {plan.tail_xw}, n_single "
                  f"{plan.n_single}; launch {launches[key]}")
            plain = S.tail_y(plan, x)
            tail_t = S.scipy_csr(S.tail_parts(plan)[2], device)
            print("  timing cuSPARSE on the tail alone (torch.mv), and "
                  "torch sums reading the buckets; then the kernel, each "
                  "also with a clean L2 flush")
            arrays = [a.view(torch.float32) for a in (
                plan.single_rows, plan.single_cols, plan.single_values)]
            for clean in (False, True):
                tag = f"{key} {'clean' if clean else 'dirty'}"
                library_ms[tag] = S.cuda_time_ms(
                    lambda: torch.mv(tail_t, x), device, clean=clean)
                read_ms[tag] = S.cuda_time_ms(
                    lambda: [a.sum() for a in arrays], device, clean=clean)
            times[f"{key} {S.TAIL_KERNEL} planned_clean"] = S.cuda_time_ms(
                tail_call(plan, x), device, clean=True)
            settings = tail_settings(plan, launches[key])
        else:
            want = (("whole_vector", "mask" if key.endswith("mask")
                     else "descriptor") if whole
                    else ("panels", key.split()[1]))
            if (plan.layout, plan.lowering) != want:
                raise S.SmokeFailure(f"{key} plan came out {plan.layout} + "
                                     f"{plan.lowering}")
            S.print_plan(key, plan)
            launches[key] = (S.whole_launches(plan) if whole
                             else S.panel_launches(plan))
            if whole and plan.lowering == "descriptor":
                read_ms[key] = S.plan_read_ms(plan)
            plain = S.plain_y(plan, x)
            settings = (whole_settings if whole else panel_settings)(
                plan, launches[key])
        for name, setting, override, kw, fetch in settings:
            call = (tail_call(plan, x, **kw) if tail
                    else S.kernel_call(name, plan, x, **kw))
            saved = {k: getattr(*k) for k in override}
            for (module, attr), value in override.items():
                setattr(module, attr, value)
            try:
                with l2_fetch_granularity(fetch):
                    err = S.rel_err(call(), plain)
                    if not err <= S.TOL:
                        raise S.SmokeFailure(f"{key} {name} {setting}: "
                                             f"{err} > {S.TOL}")
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
    if whole or tail:
        base = (os.path.splitext(args.out)[0] if args.out
                else args.layout)
        result["sass"] = {}
        for lowering in (("tail",) if tail else
                         sorted({p.lowering for p in plans.values()})):
            result["sass"].update(sass_counts(
                f"{base}.{WHOLE_SASS[lowering][0]}.sass.txt", lowering))
    if whole or tail:
        result["read_ms"] = read_ms
    if tail:
        result["library_ms"] = library_ms
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
