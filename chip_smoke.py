#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

What it does, in order, failing (exit code 1, no result line) at the first
phase that goes wrong:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one nvcc per source, all started together, and prints the
   build time and each kernel's registers (``-Xptxas -v``);
3. holds all fifteen kernels against their plain PyTorch versions on
   small matrices of every supported block shape (SpMM at nvec 3, 16 and
   128), the seven descriptor kernels also on a matrix wider and one
   taller than 32,767 (int32 ``xcol`` / ``yrow`` tables), and the test
   split's tail kernel on three bucket geometries (the reference's tail
   test, nrows % pr != 0, and a window wider than 12,288 columns);
4. SpMV path: builds ``matgen.fem_blocks(200_000, 4, 12, seed=5)``, the
   SET_A bone010 structure class at 200,000 rows (about 9.5 M nonzeros), in
   beta(4,4), and drives ``ops.prepare`` + ``ops.spmv`` through both
   layouts (whole-vector, cb=256; panels, pr=512, cb=64, xw=512) and both
   lowerings (mask, descriptor), each with ``double_buffer`` True and
   False; checks that ``lowering="auto"`` resolves to the descriptor
   lowering by the cost model, as in the reference;
5. SparseLinear path: the vocab projection of yi-6b (64,000 x 4,096, the
   weight ``serve.py``'s vocab bench draws: ``default_rng(0)``, standard
   normal, float32), magnitude-pruned to density 0.1 (beta(4,8) by eq. 4),
   through ``SparseLinear.from_dense(w, density=0.1, nvec=128)`` with every
   other argument at its default, the reference's default layer, whose
   layout pass must resolve to panels + descriptor (its forward runs
   ``spmm_cuda_panels_desc_db``); beside it two mask layers on the same
   converted matrix (``ops.prepare(lowering="mask")``: auto layout, panels,
   and whole-vector), ``ops.spmm(..., double_buffer=False)`` on both panel
   layers and a batch-1 call of both, at batches of 16 and 128;
   then the whole-vector descriptor plan of the same weight:
   ``ops.prepare(mat)`` at nvec=1 (whole-vector + descriptor, the
   reference's pick for one decode token), ``ops.spmv`` with
   ``double_buffer`` True and False and ``ops.spmm`` at batches of 16 and
   128, printing the tables' bytes and the host time of
   ``chunk_descriptors``;
6. beta(r,c)_test path: the same weight in beta(2,4) (whose singleton
   blocks hold about 30 % of the nonzeros) as
   ``SparseLinear.from_dense(w, density=0.1, block=(2, 4), layout="test",
   nvec=128)``: its multi sub-plan is panels by the 2 MiB rule, lowered by
   the cost model, and its tail is bucketed by panel; batch 1 runs the
   multi SpMV kernel + ``spmv_tail_cuda``, batches of 16 and 128 the multi
   SpMM kernel + the plain ``spmm_coo``. Beside it the flat-tail plan
   ``ops.prepare(beta(2,4), layout="test")`` at nvec = 1: whole-vector
   multi, tail through the plain ``spmv_coo``, no tail kernel. Prints the
   host time of ``split_singletons``;
7. in each path every launch counter is set to 0 just before and read just
   after, and every kernel of the path must have launched; every output is
   checked against the kernel's plain version on the card and against a
   float64 scipy product on the host, both within ``1e-5 * max|y_ref|``
   (f32 sums in another order);
8. times each kernel, its plain version and the cuSPARSE call on the same
   inputs (``torch.mv`` / ``@`` on a ``torch.sparse_csr_tensor``; timed
   only, never used by the port) with CUDA events, after warm-up, with L2
   flushed before every launch, and computes each kernel's bound from the
   bytes this run's product needs over 3.35 TB/s and its flops over 67
   TFLOP/s (for a descriptor kernel, whose ``xcol`` / ``yrow`` tables
   repeat each block's columns and rows, c and r entries per block; beside
   it the bound on the whole plan's bytes, the mask plan's bound for the
   same product and the mask kernel's time on the mask plan); the tail
   kernel beside its bound (its 12-byte slots, padding included, x and y),
   cuSPARSE on the tail alone and its plain version, and the test layer's
   forwards beside the default layer's and cuSPARSE on the whole weight;
9. prints the ``{"kernels": [...]}`` line, then, last, the
   ``{"ok": true, "device": ...}`` line.

It needs the repository beside it (``src/repro_torch``) and a CUDA device;
it never runs on the CPU.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM published peaks (NVIDIA data sheet, dense): HBM3 bandwidth and
#: f32 rate outside the tensor cores, at the full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

TOL = 1e-5                       # |y - y_ref| <= TOL * max|y_ref|
FLUSH_BYTES = 512 * 2**20        # > 50 MB L2, and keeps the card busy while
                                 # the host enqueues the timed launch
REPS = 30

MATRIX = dict(dim=200_000, bs=4, blocks_per_row=12, seed=5, rc=(4, 4))
GEOM = {"whole_vector": dict(cb=256), "panels": dict(pr=512, cb=64, xw=512)}
#: yi-6b's vocab projection (src/repro/configs/yi_6b.py: vocab 64,000,
#: d_model 4,096) as serve.py's vocab bench builds it, pruned to 10 %.
VOCAB = dict(rows=64_000, cols=4_096, density=0.1, block=(4, 8), seed=0,
             nvec=128)
SPMM_NVECS = (16, 128)
SPMM_KERNELS = {
    # name: (layout, double_buffer, the Pallas function it replaces)
    "spmm_cuda_panels_db": ("panels", True,
                            "src/repro/kernels/spc5_spmm.py:449"),
    "spmm_cuda_panels": ("panels", False,
                         "src/repro/kernels/spc5_spmm.py:309"),
    "spmm_cuda": ("whole_vector", False,
                  "src/repro/kernels/spc5_spmm.py:140"),
}
KERNELS = {
    # name: (layout, lowering, double_buffer, the Pallas function it
    # replaces)
    "spmv_cuda_db": ("whole_vector", "mask", True,
                     "src/repro/kernels/spc5_spmv.py:1000"),
    "spmv_cuda": ("whole_vector", "mask", False,
                  "src/repro/kernels/spc5_spmv.py:223"),
    "spmv_cuda_panels_db": ("panels", "mask", True,
                            "src/repro/kernels/spc5_spmv.py:490"),
    "spmv_cuda_panels": ("panels", "mask", False,
                         "src/repro/kernels/spc5_spmv.py:376"),
    "spmv_cuda_desc_db": ("whole_vector", "descriptor", True,
                          "src/repro/kernels/spc5_spmv.py:729"),
    "spmv_cuda_desc": ("whole_vector", "descriptor", False,
                       "src/repro/kernels/spc5_spmv.py:657"),
    "spmv_cuda_panels_desc_db": ("panels", "descriptor", True,
                                 "src/repro/kernels/spc5_spmv.py:925"),
    "spmv_cuda_panels_desc": ("panels", "descriptor", False,
                              "src/repro/kernels/spc5_spmv.py:824"),
}
SOURCE = {"mask": "src/repro_torch/kernels/csrc/spc5_spmv.cu",
          "descriptor": "src/repro_torch/kernels/csrc/spc5_spmv_desc.cu"}
SPMM_SOURCE = "src/repro_torch/kernels/csrc/spc5_spmm.cu"
DESC_SPMM_KERNELS = {
    # name: (layout, double_buffer, the Pallas function it replaces)
    "spmm_cuda_panels_desc_db": ("panels", True,
                                 "src/repro/kernels/spc5_spmm.py:768"),
    "spmm_cuda_panels_desc": ("panels", False,
                              "src/repro/kernels/spc5_spmm.py:654"),
    "spmm_cuda_desc": ("whole_vector", False,
                       "src/repro/kernels/spc5_spmm.py:546"),
}
DESC_SPMM_SOURCE = "src/repro_torch/kernels/csrc/spc5_spmm_desc.cu"
#: The mask kernel each descriptor SpMM kernel is timed beside.
MASK_TWIN = {"spmm_cuda_panels_desc_db": "spmm_cuda_panels_db",
             "spmm_cuda_panels_desc": "spmm_cuda_panels",
             "spmm_cuda_desc": "spmm_cuda"}
#: Matrices whose whole-vector descriptor xcol (ncols) or yrow (nrows)
#: bound needs int32 tables.
WIDE_TALL = {"wide": (300, 40_000), "tall": (40_000, 300)}
#: The test split's tail kernel.
TAIL_KERNEL = "spmv_tail_cuda"
TAIL_SOURCE = "src/repro_torch/kernels/csrc/spc5_spmv_tail.cu"
TAIL_REPLACES = "src/repro/kernels/spc5_spmv.py:558"
#: beta(2,4), one of the two shapes the reference's bench runs the paper's
#: beta_test variants on (benchmarks/bench_spmv_seq.py:207-217).
TEST_BLOCK = (2, 4)


#: Itanium mangling of the kernels' vidx type parameter.
INDEX_TYPE = {"a": "int8", "s": "int16", "i": "int32"}


class SmokeFailure(Exception):
    pass


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_kernels() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s (nvcc "
          f"{' '.join(_build.NVCC_FLAGS)})")
    for name, rec in _build.BUILD_LOG.items():
        print(f"  {name}: nvcc {rec['seconds']:.2f} s")
        kernel = ""
        for line in str(rec["log"]).splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(sp(?:mv|mm)(?:_desc)?_(?:whole|panels)"
                              r"_kernel)I((?:Li\d+E|[asi])+)E", line)
                if m:
                    targs = [n or INDEX_TYPE[t] for n, t in re.findall(
                        r"Li(\d+)E|([asi])", m.group(2))]
                    kernel = f"{m.group(1)}<{','.join(targs)}>"
                elif "spmv_tail_kernel" in line:
                    kernel = "spmv_tail_kernel"
                else:
                    kernel = line.split("'")[1]
            elif "Used" in line and kernel:
                print(f"    {kernel}: {line.split(':', 1)[1].strip()}")
    if not _build.BUILD_LOG:
        print("  loaded from an earlier build")


def tail_y(plan, x):
    """A test plan's singleton tail times x (1-D) or X (2-D), in plain
    PyTorch: ``spmv_coo_panels`` (the tail kernel's plain version) for
    panel buckets, ``spmv_coo`` for a flat tail, ``spmm_coo`` for SpMM."""
    import torch
    from repro_torch.core import ref_spmv as R
    rows, cols, vals = plan.single_rows, plan.single_cols, plan.single_values
    if x.dim() == 1:
        if plan.tail_pr:
            return R.spmv_coo_panels(rows, cols, vals, x, pr=plan.tail_pr,
                                     nrows=plan.nrows)
        return R.spmv_coo(rows, cols, vals, x, nrows=plan.nrows)
    if not plan.tail_pr:
        return R.spmm_coo(rows, cols, vals, x, nrows=plan.nrows)
    npanels = rows.shape[0]
    grows = (torch.arange(npanels, dtype=rows.dtype, device=rows.device)
             [:, None] * plan.tail_pr + rows)
    return R.spmm_coo(grows.reshape(-1), cols.reshape(-1), vals.reshape(-1),
                      x, nrows=npanels * plan.tail_pr)[:plan.nrows]


def plain_y(plan, x):
    """The plain version of the plan's kernel: SpMV for a 1-D x, SpMM for a
    2-D X (for a test plan: its multi sub-plan's plus its tail's)."""
    from repro_torch.core import ref_spmv as R
    if plan.layout == "test":
        y = plain_y(plan.multi, x)
        return y + tail_y(plan, x) if plan.n_single else y
    if plan.lowering == "descriptor":
        if plan.layout == "panels":
            fn = R.spmv_panels_desc if x.dim() == 1 else R.spmm_panels_desc
            return fn(plan.dev, x, pr=plan.pr, nrows=plan.nrows,
                      ncols_pad=plan.ncols_pad)
        fn = R.spmv_desc if x.dim() == 1 else R.spmm_desc
        return fn(plan.dev, x, nrows=plan.nrows)
    if plan.layout == "panels":
        fn = R.spmv_panels if x.dim() == 1 else R.spmm_panels
        return fn(plan.dev, x, r=plan.r, c=plan.c, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = R.spmv if x.dim() == 1 else R.spmm
    return fn(plan.dev, x, r=plan.r, c=plan.c, nrows=plan.nrows,
              ncols=plan.ncols)


def rel_err(y, y_ref) -> float:
    import torch
    y_ref = torch.as_tensor(y_ref, device=y.device)
    scale = max(float(y_ref.abs().max()), 1.0)
    return float((y.double() - y_ref.double()).abs().max()) / scale


SMALL_GEOM = {"whole_vector": dict(cb=16),
              "panels": dict(pr=64, xw=64, cb=16)}


def small_check(device) -> None:
    """All fourteen kernels against their plain versions, every block
    shape, several chunks and panels (302x260, cb=16, pr=xw=64); the SpMM
    kernels at nvec 3, 16 and 128; the descriptor kernels also on the
    :data:`WIDE_TALL` matrices, whose whole-vector xcol / yrow tables are
    int32."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    worst = 0.0
    cases = [(rc, (302, 260), 0.08) for rc in F.SUPPORTED_BLOCKS]
    cases += [((2, 4), shape, 3e-3) for shape in WIDE_TALL.values()]
    for rc, (n, m), density in cases:
        rng = np.random.default_rng(10 * rc[0] + rc[1] + n)
        d = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
        mat = F.csr_to_spc5(F.csr_from_dense(d), *rc)
        x = torch.from_numpy(rng.standard_normal(m).astype(np.float32))
        x = x.to(device)
        plans = {(layout, lowering): ops.prepare(
                    mat, layout=layout, lowering=lowering, tune=False,
                    device=device, **geom)
                 for layout, geom in SMALL_GEOM.items()
                 for lowering in ("mask", "descriptor")}
        wide_tall = (n, m) in WIDE_TALL.values()
        if wide_tall:
            table = "desc_xcol" if m > n else "desc_yrow"
            dtype = getattr(plans["whole_vector", "descriptor"], table).dtype
            if dtype != torch.int32:
                raise SmokeFailure(f"small check: {n}x{m} {table} is {dtype}")
        runs = [(name, (layout, lowering), x, lambda p, v, db=db: ops.spmv(
                    p, v, double_buffer=db))
                for name, (layout, lowering, db, _) in KERNELS.items()
                if lowering == "descriptor" or not wide_tall]
        for nvec in (3, 16, 128):
            xm = torch.from_numpy(rng.standard_normal(
                (m, nvec)).astype(np.float32)).to(device)
            spmm = [(name, (layout, "descriptor"), db)
                    for name, (layout, db, _) in DESC_SPMM_KERNELS.items()]
            if not wide_tall:
                spmm += [(name, (layout, "mask"), db)
                         for name, (layout, db, _) in SPMM_KERNELS.items()]
            runs += [(f"{name} nvec={nvec}", key, xm,
                      lambda p, v, db=db: ops.spmm(p, v, double_buffer=db))
                     for name, key, db in spmm]
        for name, key, v, run in runs:
            err = rel_err(run(plans[key], v), plain_y(plans[key], v))
            worst = max(worst, err)
            if not err <= TOL:
                raise SmokeFailure(f"small check: {name} {rc} {n}x{m} rel "
                                   f"err {err}")
    worst = max(worst, small_check_tail(device))
    nkernels = (len(KERNELS) + len(SPMM_KERNELS) + len(DESC_SPMM_KERNELS)
                + 1)
    print(f"small check: {nkernels} kernels: {nkernels - 1} x "
          f"{len(F.SUPPORTED_BLOCKS)} block shapes (SpMM at nvec 3, 16, 128), "
          f"the 7 descriptor kernels on the {' and '.join(WIDE_TALL)} "
          f"matrices (int32 xcol / yrow), {TAIL_KERNEL} on "
          f"{len(TAIL_SMALL)} bucket geometries; all agree with the plain "
          f"versions (worst {worst:.3g} of max|y|)")


#: The tail kernel's small geometries: the reference's tail test
#: (tests/test_plan.py:312-330), nrows % pr != 0, and buckets spanning more
#: than 12,288 columns (48 KB of f32).
TAIL_SMALL = {
    "powerlaw(320)": ("powerlaw", 320, dict(pr=16, xw=32, cb=8)),
    "powerlaw(330)": ("powerlaw", 330, dict(pr=16, xw=32, cb=8)),
    "300x40000": ("wide", 300, dict(pr=64, xw=512, cb=16)),
}


def small_check_tail(device) -> float:
    """``spmv_tail_cuda`` against ``spmv_coo_panels`` on each
    :data:`TAIL_SMALL` geometry in beta(2,4), and the whole test plan's SpMV
    against its plain version. Returns the worst error over max|y|."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.core import matgen
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv_tail as KT
    worst = 0.0
    for label, (kind, n, geom) in TAIL_SMALL.items():
        if kind == "powerlaw":
            csr = matgen.powerlaw(n, 5, seed=17)
        else:
            rng = np.random.default_rng(3)
            m = WIDE_TALL["wide"][1]
            csr = F.csr_from_dense(((rng.random((n, m)) < 3e-3)
                                    * rng.standard_normal((n, m)))
                                   .astype(np.float32))
        plan = ops.prepare(F.csr_to_spc5(csr, *TEST_BLOCK), layout="test",
                           multi_layout="panels", lowering="mask",
                           tune=False, device=device, **geom)
        shape = dict(nrows=plan.nrows, pr=plan.tail_pr, xw=plan.tail_xw,
                     smax=int(plan.single_rows.shape[1]))
        if ((kind == "wide" and plan.tail_xw <= 12_288)
                or (n == 330 and n % plan.tail_pr == 0)):
            raise SmokeFailure(f"small check: tail geometry {label} is "
                               f"{shape}")
        x = torch.from_numpy(np.random.default_rng(5).standard_normal(
            plan.ncols).astype(np.float32)).to(device)
        y = KT.spmv_tail_cuda(plan.tail_xbase, plan.single_rows,
                              plan.single_cols, plan.single_values, x,
                              pr=plan.tail_pr, xw=plan.tail_xw,
                              nrows=plan.nrows,
                              ncols_pad=plan.tail_ncols_pad)
        for what, got, want in (("tail", y, tail_y(plan, x)),
                                ("plan", ops.spmv(plan, x),
                                 plain_y(plan, x))):
            err = rel_err(got, want)
            worst = max(worst, err)
            if tuple(got.shape) != (plan.nrows,) or not err <= TOL:
                raise SmokeFailure(f"small check: {TAIL_KERNEL} {what} "
                                   f"{label} {shape}: rel err {err}")
        print(f"  {TAIL_KERNEL} {label}: {shape}")
    return worst


def make_matrix(dim=MATRIX["dim"]):
    from repro_torch.core import formats as F
    from repro_torch.core import matgen
    t0 = time.perf_counter()
    csr = matgen.fem_blocks(dim, MATRIX["bs"], MATRIX["blocks_per_row"],
                            seed=MATRIX["seed"])
    t1 = time.perf_counter()
    mat = F.csr_to_spc5(csr, *MATRIX["rc"])
    t2 = time.perf_counter()
    print(f"matrix: fem_blocks({dim}, {MATRIX['bs']}, "
          f"{MATRIX['blocks_per_row']}, seed={MATRIX['seed']}) -> beta"
          f"{MATRIX['rc']}: {csr.nnz} nnz, {mat.nblocks} blocks "
          f"(host: generator {t1 - t0:.1f} s, csr_to_spc5 {t2 - t1:.1f} s)")
    return csr, mat


LOWERINGS = ("mask", "descriptor")


def check_auto_lowering(mat, device) -> None:
    """``lowering="auto"`` must resolve to the descriptor lowering by the
    cost model, as the reference resolves it for this matrix."""
    from repro_torch.kernels import ops
    plan = ops.prepare(mat, lowering="auto", tune=False, device=device)
    entry = next(e for e in plan.trace if e["pass"] == "layout")
    print(f"auto lowering: layout pass {json.dumps(entry, sort_keys=True)}")
    if (entry["lowering"], entry.get("lowering_reason")) != ("descriptor",
                                                            "cost-model"):
        raise SmokeFailure(f"lowering='auto' resolved to {entry}")


def print_plan(name, plan) -> None:
    """Geometry, the kernels' dynamic shared memory per CTA (ptxas reports
    only static shared memory, which is 0) and, for a descriptor plan, the
    tables' dtypes and bytes."""
    g = {k: getattr(plan, k) for k in ("cb", "vmax", "pr", "xw", "npanels",
                                       "nchunks", "desc_lane_nbytes")
         if k in dict(plan.meta)}
    if plan.layout == "whole_vector":
        g["nchunks"] = int(plan.chunk_vbase.shape[0])
    for stages in (1, 2):
        g[f"smem_bytes_s{stages}"] = 4 * (
            stages * (plan.vmax + plan.xw) + plan.pr
            if plan.layout == "panels" else stages * plan.vmax)
    if plan.lowering == "descriptor":
        tables = [getattr(plan, f"desc_{t}")
                  for t in ("valid", "vidx", "xcol", "yrow")]
        g["tables"] = "/".join(str(t.dtype).replace("torch.", "")
                               for t in tables)
        g["table_bytes"] = sum(t.numel() * t.element_size() for t in tables)
    g["plan_bytes"] = sum(a.numel() * a.element_size() for a in plan.arrays)
    print(f"plan {name}: {g}, build {plan.trace[-1]['duration_s']:.1f} s")


def drive(mat, x, device):
    """The main path, through the entry points a user calls: both layouts
    and both lowerings. Returns the plans (keyed by layout and lowering),
    each kernel's y and the launch counts of this run alone."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    K.reset_launches()
    KD.reset_launches()
    plans, ys = {}, {}
    for layout, geom in GEOM.items():
        for lowering in LOWERINGS:
            plans[layout, lowering] = ops.prepare(
                mat, layout=layout, lowering=lowering, tune=False,
                device=device, **geom)
    for name, (layout, lowering, db, _) in KERNELS.items():
        ys[name] = ops.spmv(plans[layout, lowering], x, double_buffer=db)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = {**K.LAUNCHES, **KD.LAUNCHES}
    for (layout, lowering), plan in plans.items():
        print_plan(f"{layout} {lowering}", plan)
    return plans, ys, launches


def check_y(name, y, plan, x, y64, launches, path):
    """The kernel launched on its path, and y is finite, of the right shape
    and within tolerance of the plain version and of the f64 product.
    Returns max|y - plain|."""
    import torch
    if launches.get(name, 0) <= 0:
        raise SmokeFailure(f"{name} was not launched on the {path} "
                           f"(counts {launches})")
    if tuple(y.shape) != (plan.nrows,) or not bool(torch.isfinite(y).all()):
        raise SmokeFailure(f"{name}: bad output {tuple(y.shape)}")
    plain = plain_y(plan, x)
    abs_err = float((y - plain).abs().max())
    e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
    print(f"check {name} ({path}): max|y - plain| = {abs_err:.3g} "
          f"({e_plain:.3g} of max|y|), vs f64 scipy {e64:.3g} of max|y|")
    if not (e_plain <= TOL and e64 <= TOL):
        raise SmokeFailure(f"{name} disagrees: {e_plain} / {e64} > {TOL}")
    return abs_err


def check(plans, ys, launches, x, y64):
    """Every kernel launched, and each y checked by :func:`check_y`."""
    return {name: check_y(name, ys[name], plans[layout, lowering], x, y64,
                          launches, "SpMV path")
            for name, (layout, lowering, _, _) in KERNELS.items()}


def cuda_time_ms(fn, device, reps=REPS):
    """Median device time of ``fn`` in ms: CUDA events around each call,
    after warm-up, with the L2 cache flushed (a 512 MiB write) before
    every call. Prints the spread (min and max of the calls)."""
    import torch
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=device)
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del flush
    print(f"    {reps} calls: min {min(times):.4f} ms, median "
          f"{float(np.median(times)):.4f} ms, max {max(times):.4f} ms")
    return float(np.median(times))


def needed_bytes(plan, whole_plan=False):
    """The bytes of the plan that the product must read: every array as
    built, padding included, except that a descriptor plan's ``xcol`` and
    ``yrow`` tables repeat each block's c columns over its r rows and its r
    rows over its c columns, so the product needs only c ``xcol`` and r
    ``yrow`` entries per block (``valid`` and ``vidx`` per lane).
    ``whole_plan`` counts every byte of the plan instead."""
    total = sum(a.numel() * a.element_size() for a in plan.arrays)
    if plan.lowering == "descriptor" and not whole_plan:
        rc = plan.r * plan.c
        for table, kept in (("desc_xcol", plan.c), ("desc_yrow", plan.r)):
            t = getattr(plan, table)
            total -= t.numel() * t.element_size() // rc * (rc - kept)
    return total


def bound(plan, nnz, nvec=1, whole_plan=False):
    """The least time for one SpMV (nvec = 1) or SpMM: the plan bytes the
    product needs (:func:`needed_bytes`) and X read once and Y written
    once, over the HBM rate; 2 flops per nonzero and column over the f32
    rate. Returns (ms, "bytes" | "operations", bytes)."""
    nbytes = (needed_bytes(plan, whole_plan)
              + 4 * nvec * (plan.ncols + plan.nrows))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz * nvec / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def desc_bounds(plan, mask_plan, nnz, nvec=1):
    """A descriptor kernel's two other bounds, printed and kept beside its
    own: the mask plan's for the same product, and one that reads every
    byte of the descriptor plan as built (the repeated ``xcol`` / ``yrow``
    entries too)."""
    out = {"mask_bound_ms": bound(mask_plan, nnz, nvec)[0],
           "plan_bound_ms": bound(plan, nnz, nvec, whole_plan=True)[0]}
    print(f"    mask plan's bound {out['mask_bound_ms']:.4f} ms, bound on "
          f"the whole descriptor plan's bytes {out['plan_bound_ms']:.4f} ms")
    return out


def sparse_csr(csr, device):
    """The CSR as a ``torch.sparse_csr_tensor`` (cuSPARSE, timed only)."""
    import torch
    with warnings.catch_warnings():     # "beta state" / invariant notices
        warnings.simplefilter("ignore", UserWarning)
        return torch.sparse_csr_tensor(
            torch.from_numpy(csr.rowptr.astype(np.int32)),
            torch.from_numpy(csr.colidx.astype(np.int32)),
            torch.from_numpy(csr.values.astype(np.float32)),
            size=csr.shape, device=device)


def kernel_call(name, plan, x):
    """A call of kernel ``name``'s wrapper on the plan's arrays and x."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmm_desc as KDM
    from repro_torch.kernels import spc5_spmv as K
    from repro_torch.kernels import spc5_spmv_desc as KD
    module = ({True: KDM, False: KM} if name.startswith("spmm")
              else {True: KD, False: K})["desc" in name]
    fn = getattr(module, name)
    args = ((plan.chunk_vbase, plan.chunk_xbase) if plan.layout == "panels"
            else (plan.chunk_vbase,))
    if plan.lowering == "descriptor":
        args += (plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
                 plan.desc_yrow, plan.values, x)
    else:
        args += (plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
                 plan.chunk_row, plan.values, x)
    kw = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              nrows=plan.nrows)
    kw.update(dict(xw=plan.xw, pr=plan.pr, ncols_pad=plan.ncols_pad)
              if plan.layout == "panels" else dict(ncols=plan.ncols))
    return lambda: fn(*args, **kw)


def measure(plans, x, csr, launches, errs, timer=cuda_time_ms):
    import torch
    device = x.device
    csr_t = sparse_csr(csr, device)
    print("  timing cuSPARSE CSR (torch.mv on sparse_csr_tensor)")
    library_ms = timer(lambda: torch.mv(csr_t, x), device)
    plain_ms = {}
    for key, plan in plans.items():
        print(f"  timing the plain version, {key[0]} {key[1]}")
        plain_ms[key] = timer(lambda p=plan: plain_y(p, x), device)
    rows = []
    for name, (layout, lowering, db, replaces) in KERNELS.items():
        plan = plans[layout, lowering]
        print(f"  timing {name}")
        ms = timer(kernel_call(name, plan, x), device)
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz)
        print(f"time {name}: {ms:.4f} ms, plain "
              f"{plain_ms[layout, lowering]:.4f} ms, cuSPARSE CSR "
              f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({nbytes} "
              f"bytes)")
        row = {"name": name, "route": "cuda", "source": SOURCE[lowering],
               "replaces": replaces, "launches": launches[name],
               "max_abs_err": errs[name], "ms": ms,
               "plain_ms": plain_ms[layout, lowering], "bound_ms": bound_ms,
               "bound_by": bound_by, "library_ms": library_ms}
        if lowering == "descriptor":
            row.update(desc_bounds(plan, plans[layout, "mask"], csr.nnz))
        rows.append(row)
    return rows


# ----------------------------------------------------------------------------
# SparseLinear path: the yi-6b vocab projection
# ----------------------------------------------------------------------------

def make_vocab():
    """The vocab weight as serve.py's vocab bench draws it (float64 normal
    from ``default_rng(0)``, cast to float32), and its CSR and beta(4,8)
    matrix pruned and converted as ``SparseLinear.from_dense`` does it: the
    CSR feeds the f64 product and cuSPARSE, the matrix the mask layers and
    the token plan."""
    from repro_torch.core import formats as F
    from repro_torch.core.sparse_linear import prune_by_magnitude
    t0 = time.perf_counter()
    w = np.random.default_rng(VOCAB["seed"]).standard_normal(
        (VOCAB["rows"], VOCAB["cols"])).astype(np.float32)
    t1 = time.perf_counter()
    csr = F.csr_from_dense(prune_by_magnitude(w, VOCAB["density"]))
    t2 = time.perf_counter()
    mat = F.csr_to_spc5(csr, *VOCAB["block"])
    t3 = time.perf_counter()
    print(f"vocab weight: {VOCAB['rows']} x {VOCAB['cols']} at density "
          f"{VOCAB['density']} -> beta{VOCAB['block']}: {csr.nnz} nnz, "
          f"{mat.nblocks} blocks, Avg {csr.nnz / mat.nblocks:.3f} (host: "
          f"draw {t1 - t0:.1f} s, prune + CSR {t2 - t1:.1f} s, csr_to_spc5 "
          f"{t3 - t2:.1f} s)")
    return w, csr, mat


def print_spmm_plan(name, plan) -> None:
    """Geometry and each SpMM kernel's column tile, CTAs and dynamic shared
    memory per CTA at every batch (for a descriptor plan also whether vidx
    is staged, and the tables' dtypes and bytes)."""
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmm_desc as KDM
    g = {k: getattr(plan, k) for k in ("cb", "vmax", "pr", "xw", "npanels",
                                       "nchunks", "desc_lane_nbytes")
         if k in dict(plan.meta)}
    panels = plan.layout == "panels"
    units = plan.npanels if panels else int(plan.chunk_vbase.shape[0])
    for nvec in SPMM_NVECS:
        for stages in ((1, 2) if panels else (1,)):
            staged = None
            if plan.lowering == "descriptor":
                tw, staged, nbytes = KDM.smem_plan(
                    stages, plan.cb, plan.r, plan.c, plan.vmax,
                    plan.desc_vidx.element_size(), nvec,
                    pr=plan.pr if panels else 0)
            elif panels:
                def smem(t, s=stages, p=plan):
                    return KM.panels_smem_bytes(s, p.cb, p.vmax, p.pr, t)
                tw = KM.column_tile(nvec, smem)
                nbytes = smem(tw)
            else:
                tw = KM.column_tile(nvec)
                nbytes = KM.whole_smem_bytes(plan.cb, plan.vmax)
            g[f"nvec{nvec}_s{stages}"] = dict(
                tile=tw, ctas=units * -(-nvec // tw), smem_bytes=nbytes,
                **({} if staged is None else {"vidx_staged": staged}))
    if plan.lowering == "descriptor":
        tables = [getattr(plan, f"desc_{t}")
                  for t in ("valid", "vidx", "xcol", "yrow")]
        g["tables"] = "/".join(str(t.dtype).replace("torch.", "")
                               for t in tables)
        g["table_bytes"] = sum(t.numel() * t.element_size() for t in tables)
    g["plan_bytes"] = sum(a.numel() * a.element_size() for a in plan.arrays)
    print(f"  plan {name}: {g}, build {plan.trace[-1]['duration_s']:.1f} s")


def build_layers(w, mat, device):
    """The layers of the path. ``SparseLinear.from_dense(w, density=0.1,
    nvec=128)`` with every other argument at its default, the reference's
    default layer: its layout pass must pick panels (from nvec) and the
    descriptor lowering (by the cost model). Beside it, two mask layers on
    the same converted matrix through ``ops.prepare(lowering="mask")``: the
    auto layout (panels) and whole-vector."""
    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    default = SparseLinear.from_dense(w, density=VOCAB["density"],
                                      nvec=VOCAB["nvec"])
    t1 = time.perf_counter()
    panels = SparseLinear(ops.prepare(mat, lowering="mask",
                                      nvec=VOCAB["nvec"], device=device))
    whole = SparseLinear(ops.prepare(mat, layout="whole_vector",
                                     lowering="mask", nvec=VOCAB["nvec"],
                                     device=device))
    t2 = time.perf_counter()
    print(f"layers: from_dense {t1 - t0:.1f} s (prune, convert, plan), "
          f"the two mask plans {t2 - t1:.1f} s")
    print(f"  default layer's trace: {json.dumps(default.plan.trace)}")
    entry = next(e for e in default.plan.trace if e["pass"] == "layout")
    got = (default.plan.layout, default.plan.lowering, entry["reason"],
           entry.get("lowering_reason"), (default.plan.r, default.plan.c))
    if got != ("panels", "descriptor", "vmem-fit", "cost-model",
               VOCAB["block"]):
        raise SmokeFailure(f"from_dense at its defaults built {got}, not "
                           f"panels + descriptor in beta{VOCAB['block']}")
    if panels.plan.layout != "panels":
        raise SmokeFailure(f"the mask layer's auto layout is "
                           f"{panels.plan.layout!r}, not panels")
    print(f"  default layer: {entry['layout']} ({entry['reason']}) + "
          f"{entry['lowering']} ({entry['lowering_reason']})")
    layers = {("panels", "descriptor"): default, ("panels", "mask"): panels,
              ("whole_vector", "mask"): whole}
    for (layout, lowering), layer in layers.items():
        print_spmm_plan(f"{layout} {lowering}", layer.plan)
    return layers


def layer_key(name):
    """The layer (layout, lowering) SpMM kernel ``name`` runs on."""
    lowering = "descriptor" if name in DESC_SPMM_KERNELS else "mask"
    table = DESC_SPMM_KERNELS if lowering == "descriptor" else SPMM_KERNELS
    return table[name][0], lowering


VOCAB_SPMM = ("spmm_cuda_panels_desc_db", "spmm_cuda_panels_desc",
              "spmm_cuda_panels_db", "spmm_cuda_panels", "spmm_cuda")
BATCH1 = {"spmv_cuda_panels_desc_db": ("panels", "descriptor"),
          "spmv_cuda_panels_db": ("panels", "mask")}


def reset_all_launches():
    from repro_torch.kernels import (spc5_spmm, spc5_spmm_desc, spc5_spmv,
                                     spc5_spmv_desc, spc5_spmv_tail)
    mods = (spc5_spmv, spc5_spmv_desc, spc5_spmm, spc5_spmm_desc,
            spc5_spmv_tail)
    for mod in mods:
        mod.reset_launches()
    return lambda: {k: v for mod in mods for k, v in mod.LAUNCHES.items()}


def drive_vocab(layers, acts, device):
    """The SparseLinear path, through the entry points a user calls: every
    layer's forward on every batch, ``ops.spmm(..., double_buffer=False)``
    on both panel layers, and a batch-1 forward of both panel layers.
    Returns each kernel's Y (rows, nvec) per batch, the batch-1 ys and this
    run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    default = layers["panels", "descriptor"]
    panels, whole = layers["panels", "mask"], layers["whole_vector", "mask"]
    ys = {}
    for nvec, a in acts.items():
        ys["spmm_cuda_panels_desc_db", nvec] = default(a).t()
        ys["spmm_cuda_panels_desc", nvec] = ops.spmm(
            default.plan, a.t().contiguous(), double_buffer=False)
        ys["spmm_cuda_panels_db", nvec] = panels(a).t()
        ys["spmm_cuda_panels", nvec] = ops.spmm(
            panels.plan, a.t().contiguous(), double_buffer=False)
        ys["spmm_cuda", nvec] = whole(a).t()
    x1 = acts[SPMM_NVECS[0]][0]
    y1 = {name: layers[key](x1) for name, key in BATCH1.items()}
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, y1, counts()


def check_spmm(name, y, plan, x, y64, path):
    """Y is finite, of the right shape and within tolerance of the plain
    version and of the f64 product. Returns max|Y - plain|."""
    import torch
    nvec = x.shape[1]
    if (tuple(y.shape) != (plan.nrows, nvec)
            or not bool(torch.isfinite(y).all())):
        raise SmokeFailure(f"{name}: bad output {tuple(y.shape)}")
    plain = plain_y(plan, x)
    abs_err = float((y - plain).abs().max())
    e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
    del plain
    print(f"check {name} nvec={nvec} ({path}): max|Y - plain| = "
          f"{abs_err:.3g} ({e_plain:.3g} of max|Y|), vs f64 scipy "
          f"{e64:.3g} of max|Y|")
    if not (e_plain <= TOL and e64 <= TOL):
        raise SmokeFailure(f"{name} nvec={nvec} disagrees: {e_plain} / "
                           f"{e64} > {TOL}")
    return abs_err


def f64_matrix(csr):
    import scipy.sparse
    return scipy.sparse.csr_matrix((csr.values.astype(np.float64),
                                    csr.colidx, csr.rowptr), shape=csr.shape)


def check_vocab(layers, ys, y1, launches, acts, csr):
    """Every SpMM kernel of the path and both batch-1 SpMV kernels
    launched; each output is checked by :func:`check_spmm` (batch 1 by
    :func:`check_y`)."""
    for name in (*VOCAB_SPMM, *BATCH1):
        if launches.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched on the SparseLinear "
                               f"path (counts {launches})")
    a64 = f64_matrix(csr)
    errs = {}
    for nvec, act in acts.items():
        x = act.t().contiguous()
        y64 = a64 @ x.cpu().double().numpy()
        for name in VOCAB_SPMM:
            err = check_spmm(name, ys[name, nvec], layers[layer_key(name)].plan,
                             x, y64, "SparseLinear path")
            errs[name] = max(errs.get(name, 0.0), err)
    x1 = acts[SPMM_NVECS[0]][0]
    y64 = a64 @ x1.cpu().double().numpy()
    for name, key in BATCH1.items():
        errs[name] = check_y(name, y1[name], layers[key].plan, x1, y64,
                             launches, "SparseLinear path, batch 1")
    return errs


def measure_vocab(layers, acts, csr, timer=cuda_time_ms):
    """cuSPARSE SpMM, each layer's plain version and each SpMM kernel at
    every batch. Returns {(name, nvec): numbers} and cuSPARSE's ms per
    batch."""
    import torch
    device = next(iter(acts.values())).device
    csr_t = sparse_csr(csr, device)
    per, library = {}, {}
    for nvec, act in acts.items():
        x = act.t().contiguous()
        print(f"  nvec={nvec}: timing cuSPARSE SpMM (sparse_csr_tensor @ X)")
        library[nvec] = timer(lambda: csr_t @ x, device)
        if nvec == max(acts):
            dense = csr_t.to_dense()
            print(f"  nvec={nvec}: timing dense torch.matmul of the pruned "
                  f"weight (context only)")
            dense_ms = timer(lambda: dense @ x, device)
            print(f"context: dense f32 matmul {dense_ms:.4f} ms")
            del dense
        plain_ms = {}
        for key, layer in layers.items():
            print(f"  nvec={nvec}: timing the plain version, {key}")
            plain_ms[key] = timer(lambda p=layer.plan: plain_y(p, x), device)
        for name in VOCAB_SPMM:
            key = layer_key(name)
            plan = layers[key].plan
            print(f"  nvec={nvec}: timing {name}")
            ms = timer(kernel_call(name, plan, x), device)
            bound_ms, bound_by, nbytes = bound(plan, csr.nnz, nvec)
            print(f"time {name} nvec={nvec}: {ms:.4f} ms, plain "
                  f"{plain_ms[key]:.4f} ms, cuSPARSE SpMM "
                  f"{library[nvec]:.4f} ms, bound {bound_ms:.4f} ms by "
                  f"{bound_by} ({nbytes} bytes)")
            per[name, nvec] = {"ms": ms, "plain_ms": plain_ms[key],
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": library[nvec]}
            if key[1] == "descriptor":
                per[name, nvec].update(desc_bounds(
                    plan, layers[key[0], "mask"].plan, csr.nnz, nvec))
    for name in VOCAB_SPMM:
        if name in MASK_TWIN:
            for nvec in acts:
                per[name, nvec]["mask_ms"] = per[MASK_TWIN[name], nvec]["ms"]
    return per, library


def spmm_rows(names, per, launches, errs):
    """One JSON row per SpMM kernel: nvec=128 in the main keys, nvec=16
    beside."""
    rows = []
    for name in names:
        desc = name in DESC_SPMM_KERNELS
        replaces = (DESC_SPMM_KERNELS if desc else SPMM_KERNELS)[name][-1]
        rows.append({"name": name, "route": "cuda",
                     "source": DESC_SPMM_SOURCE if desc else SPMM_SOURCE,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name],
                     **per[name, VOCAB["nvec"]], "nvec": VOCAB["nvec"],
                     **{f"nvec_{n}": per[name, n] for n in SPMM_NVECS
                        if n != VOCAB["nvec"]}})
    return rows


# ----------------------------------------------------------------------------
# The whole-vector descriptor plan: one decode token through the vocab
# weight (SpMV), and the same plan's SpMM
# ----------------------------------------------------------------------------

TOKEN_KERNELS = ("spmv_cuda_desc_db", "spmv_cuda_desc")


def build_token_plan(mat, device):
    """``ops.prepare(mat)`` at nvec=1 with the lowering left at its default,
    as a batch-1 caller builds it: the layout pass must pick whole-vector
    and the descriptor lowering (the reference's choice). The host time of
    ``formats.chunk_descriptors`` inside the build is taken by wrapping it
    for this one call."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    seconds = []
    expand = F.chunk_descriptors

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = expand(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    F.chunk_descriptors = timed
    try:
        t0 = time.perf_counter()
        plan = ops.prepare(mat, device=device)
        total = time.perf_counter() - t0
    finally:
        F.chunk_descriptors = expand
    entry = next(e for e in plan.trace if e["pass"] == "layout")
    print(f"token plan: layout pass {json.dumps(entry, sort_keys=True)}; "
          f"prepare {total:.1f} s, of which chunk_descriptors "
          f"{sum(seconds):.1f} s (host)")
    if (plan.layout, plan.lowering, entry.get("lowering_reason")) != (
            "whole_vector", "descriptor", "cost-model"):
        raise SmokeFailure(f"the batch-1 plan is {plan.layout} / "
                           f"{plan.lowering}: {entry}")
    print_plan("vocab whole_vector descriptor", plan)
    print_spmm_plan("vocab whole_vector descriptor", plan)
    return plan


def drive_token(plan, x1, acts, device):
    """``ops.spmv`` with both buffer settings and ``ops.spmm`` at every
    batch on the whole-vector descriptor plan; launch counts of this run."""
    import torch
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    ys = {name: ops.spmv(plan, x1, double_buffer=name.endswith("_db"))
          for name in TOKEN_KERNELS}
    for nvec, a in acts.items():
        ys["spmm_cuda_desc", nvec] = ops.spmm(plan, a.t().contiguous())
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, counts()


def measure_token(plan, mask_plan, x1, acts, csr, launches, errs, vper,
                  library, timer=cuda_time_ms):
    """Each whole-vector descriptor SpMV kernel at batch 1, its plain
    version, cuSPARSE ``torch.mv`` and, for context, the mask kernel with
    the same buffering on the mask plan of the same weight; then
    ``spmm_cuda_desc`` at every batch beside its plain version (cuSPARSE
    SpMM and ``spmm_cuda`` on the mask plan come from
    :func:`measure_vocab`). Returns the SpMV numbers and adds
    ``spmm_cuda_desc``'s to ``vper``."""
    import torch
    device = x1.device
    csr_t = sparse_csr(csr, device)
    print("  token: timing cuSPARSE CSR (torch.mv on sparse_csr_tensor)")
    library_ms = timer(lambda: torch.mv(csr_t, x1), device)
    print("  token: timing the plain version")
    plain_ms = timer(lambda: plain_y(plan, x1), device)
    per = {}
    for name in TOKEN_KERNELS:
        print(f"  token: timing {name}")
        ms = timer(kernel_call(name, plan, x1), device)
        mask_name = name.replace("_desc", "")
        print(f"  token: timing {mask_name} on the mask plan (context)")
        mask_ms = timer(kernel_call(mask_name, mask_plan, x1), device)
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz)
        print(f"time {name} (token): {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cuSPARSE CSR {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"by {bound_by} ({nbytes} bytes), {mask_name} "
              f"{mask_ms:.4f} ms")
        per[name] = {"launches": launches[name], "max_abs_err": errs[name],
                     "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms,
                     **desc_bounds(plan, mask_plan, csr.nnz),
                     "mask_ms": mask_ms}
    name = "spmm_cuda_desc"
    for nvec, act in acts.items():
        x = act.t().contiguous()
        print(f"  nvec={nvec}: timing the plain version, whole_vector "
              f"descriptor")
        spmm_plain_ms = timer(lambda: plain_y(plan, x), device)
        print(f"  nvec={nvec}: timing {name}")
        ms = timer(kernel_call(name, plan, x), device)
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz, nvec)
        mask_ms = vper["spmm_cuda", nvec]["ms"]
        print(f"time {name} nvec={nvec}: {ms:.4f} ms, plain "
              f"{spmm_plain_ms:.4f} ms, cuSPARSE SpMM {library[nvec]:.4f} "
              f"ms, bound {bound_ms:.4f} ms by {bound_by} ({nbytes} bytes), "
              f"spmm_cuda {mask_ms:.4f} ms")
        vper[name, nvec] = {"ms": ms, "plain_ms": spmm_plain_ms,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "library_ms": library[nvec],
                            **desc_bounds(plan, mask_plan, csr.nnz, nvec),
                            "mask_ms": mask_ms}
    return per


# ----------------------------------------------------------------------------
# beta(r,c)_test path: the vocab weight in beta(2,4), singleton blocks split
# off into a COO tail
# ----------------------------------------------------------------------------

def kernel_name(plan, spmm=False, double_buffer=True):
    """The kernel ``ops.spmv`` (or ``ops.spmm``) launches for a whole-vector
    or panel plan (the whole-vector layout has one SpMM kernel)."""
    panels = plan.layout == "panels"
    return ("spmm_cuda" if spmm else "spmv_cuda") + (
        "_panels" if panels else "") + (
        "_desc" if plan.lowering == "descriptor" else "") + (
        "_db" if double_buffer and (panels or not spmm) else "")


def describe_test_plan(name, plan) -> None:
    """The split's numbers and its multi sub-plan's choices."""
    entry = next(e for e in plan.multi.trace if e["pass"] == "layout")
    smax = int(plan.single_rows.shape[1]) if plan.tail_pr else 0
    tail_bytes = sum(a.numel() * a.element_size() for a in plan.arrays)
    print(f"{name}: multi {plan.multi.layout} ({entry['reason']}) + "
          f"{plan.multi.lowering} ({entry.get('lowering_reason')}); "
          f"n_single {plan.n_single} of {plan.nnz} nnz "
          f"({100 * plan.n_single / plan.nnz:.1f} %), multi "
          f"{plan.multi.nblocks} blocks, Avg "
          f"{(plan.nnz - plan.n_single) / max(plan.multi.nblocks, 1):.3f}; "
          f"tail_pr {plan.tail_pr}, tail_xw {plan.tail_xw}, smax {smax}, "
          f"buckets {tuple(plan.single_rows.shape)}, tail {tail_bytes} "
          f"bytes")
    print_spmm_plan(f"{name} multi {plan.multi.layout} "
                    f"{plan.multi.lowering}", plan.multi)


def build_test_layer(w, device):
    """(a) ``SparseLinear.from_dense(w, density=0.1, block=(2, 4),
    layout="test", nvec=128)``: the multi sub-plan must be panels by the
    2 MiB rule (its lowering is the cost model's) and the tail bucketed by
    its panels. The host time of ``formats.split_singletons`` inside the
    build is taken by wrapping it for this one call."""
    from repro_torch.core import formats as F
    from repro_torch.core.sparse_linear import SparseLinear
    seconds = []
    split = F.split_singletons

    def timed(*args, **kw):
        t0 = time.perf_counter()
        out = split(*args, **kw)
        seconds.append(time.perf_counter() - t0)
        return out

    F.split_singletons = timed
    try:
        t0 = time.perf_counter()
        layer = SparseLinear.from_dense(
            w, density=VOCAB["density"], block=TEST_BLOCK, layout="test",
            nvec=VOCAB["nvec"])
        total = time.perf_counter() - t0
    finally:
        F.split_singletons = split
    plan = layer.plan
    print(f"test layer (a): from_dense {total:.1f} s (prune, convert, "
          f"split, plan), of which split_singletons {sum(seconds):.2f} s "
          f"(host)")
    describe_test_plan("test layer (a)", plan)
    entry = next(e for e in plan.multi.trace if e["pass"] == "layout")
    got = (plan.layout, plan.multi.layout, entry["reason"],
           entry.get("lowering_reason"), (plan.multi.r, plan.multi.c))
    if (got != ("test", "panels", "vmem-fit", "cost-model", TEST_BLOCK)
            or plan.tail_pr != plan.multi.pr or not plan.n_single):
        raise SmokeFailure(f"the test layer is {got}, tail_pr "
                           f"{plan.tail_pr}")
    return layer


def build_flat_test_plan(csr, device):
    """(b) ``ops.prepare(beta(2,4), layout="test")`` at nvec = 1: the multi
    sub-plan must be whole-vector, so the tail stays flat."""
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    t0 = time.perf_counter()
    mat = F.csr_to_spc5(csr, *TEST_BLOCK)
    t1 = time.perf_counter()
    plan = ops.prepare(mat, layout="test", device=device)
    t2 = time.perf_counter()
    print(f"flat-tail plan (b): csr_to_spc5 {t1 - t0:.1f} s, prepare "
          f"{t2 - t1:.1f} s (host)")
    describe_test_plan("flat-tail plan (b)", plan)
    if plan.multi.layout != "whole_vector" or plan.tail_pr:
        raise SmokeFailure(f"the flat-tail plan's multi is "
                           f"{plan.multi.layout}, tail_pr {plan.tail_pr}")
    return plan


def drive_test(layer, flat, x1, acts, device):
    """(a) the test layer's forward at batch 1 and at every SpMM batch;
    (b) ``ops.spmv`` on the flat-tail plan. Launch counts of each run."""
    import torch
    from repro_torch.kernels import ops
    counts = reset_all_launches()
    ys = {1: layer(x1)}
    for nvec, a in acts.items():
        ys[nvec] = layer(a).t()
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches_a = counts()
    counts = reset_all_launches()
    y_flat = ops.spmv(flat, x1)
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, y_flat, launches_a, counts()


def check_test(layer, flat, ys, y_flat, launches_a, launches_b, x1, acts,
               csr):
    """(a) launched the tail kernel and the multi SpMV and SpMM kernels,
    (b) the multi SpMV kernel and no tail kernel; every output within
    tolerance of the plain path on the card and of the f64 product."""
    plan = layer.plan
    for name in (TAIL_KERNEL, kernel_name(plan.multi),
                 kernel_name(plan.multi, spmm=True)):
        if launches_a.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched on the test path "
                               f"(counts {launches_a})")
    flat_name = kernel_name(flat.multi)
    if launches_b.get(TAIL_KERNEL, 0) != 0 or launches_b.get(flat_name,
                                                             0) <= 0:
        raise SmokeFailure(f"the flat-tail plan's launches are "
                           f"{launches_b}")
    a64 = f64_matrix(csr)
    y64 = a64 @ x1.cpu().double().numpy()
    check_y(TAIL_KERNEL, ys[1], plan, x1, y64, launches_a,
            f"test path (a), batch 1, with {kernel_name(plan.multi)}")
    for nvec, act in acts.items():
        x = act.t().contiguous()
        check_spmm(f"{kernel_name(plan.multi, spmm=True)} + spmm_coo",
                   ys[nvec], plan, x, a64 @ x.cpu().double().numpy(),
                   "test path (a)")
    check_y(flat_name, y_flat, flat, x1, y64, launches_b,
            "test path (b), with spmv_coo")


def tail_parts(plan):
    """The tail kernel's arguments, and the tail as a host scipy CSR in
    float64 (the padding slots dropped: a singleton's value is never 0)."""
    import scipy.sparse
    args = (plan.tail_xbase, plan.single_rows, plan.single_cols,
            plan.single_values)
    kw = dict(pr=plan.tail_pr, xw=plan.tail_xw, nrows=plan.nrows,
              ncols_pad=plan.tail_ncols_pad)
    rows = plan.single_rows.cpu().numpy().astype(np.int64)
    rows += np.arange(rows.shape[0], dtype=np.int64)[:, None] * plan.tail_pr
    vals = plan.single_values.cpu().numpy()
    keep = vals != 0
    tail = scipy.sparse.csr_matrix(
        (vals[keep].astype(np.float64),
         (rows[keep], plan.single_cols.cpu().numpy()[keep])),
        shape=(plan.nrows, plan.ncols))
    if tail.nnz != plan.n_single:
        raise SmokeFailure(f"the tail holds {tail.nnz} nonzeros, the plan "
                           f"says {plan.n_single}")
    return args, kw, tail


def check_tail(plan, x1):
    """The tail kernel alone against its plain version on the card and the
    f64 product of the tail. Returns max|y - plain| and the tail's CSR."""
    import torch
    from repro_torch.kernels import spc5_spmv_tail as KT
    args, kw, tail = tail_parts(plan)
    y = KT.spmv_tail_cuda(*args, x1, **kw)
    plain = tail_y(plan, x1)
    abs_err = float((y - plain).abs().max())
    y64 = tail @ x1.cpu().double().numpy()
    e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
    print(f"check {TAIL_KERNEL} alone: max|y - plain| = {abs_err:.3g} "
          f"({e_plain:.3g} of max|y|), vs f64 scipy {e64:.3g} of max|y|")
    if not (e_plain <= TOL and e64 <= TOL):
        raise SmokeFailure(f"{TAIL_KERNEL} disagrees: {e_plain} / {e64} > "
                           f"{TOL}")
    return abs_err, tail


def measure_test(layer, flat, default, x1, acts, csr, tail, launches,
                 abs_err, library, timer=cuda_time_ms):
    """The tail kernel beside its bound, its plain version and cuSPARSE on
    the tail alone; the test layer's forwards beside the default layer's
    and cuSPARSE on the whole weight; the parts of each forward; the
    flat-tail plan's SpMV. Returns the kernel's JSON row."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv_tail as KT
    device = x1.device
    plan = layer.plan
    args, kw, _ = tail_parts(plan)
    print(f"  test: timing {TAIL_KERNEL}")
    ms = timer(lambda: KT.spmv_tail_cuda(*args, x1, **kw), device)
    print("  test: timing the plain version (spmv_coo_panels)")
    plain_ms = timer(lambda: tail_y(plan, x1), device)
    tail_t = sparse_csr(F.CSRMatrix(tail.shape, tail.indptr, tail.indices,
                                    tail.data), device)
    print("  test: timing cuSPARSE on the tail alone (torch.mv)")
    library_ms = timer(lambda: torch.mv(tail_t, x1), device)
    slots = plan.single_rows.numel()
    nbytes = 12 * slots + 4 * (plan.tail_xbase.numel() + plan.ncols
                               + plan.nrows)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, 2 * slots / F32_FLOP_PER_S
    bound_ms = 1e3 * max(t_bytes, t_ops)
    bound_by = "bytes" if t_bytes >= t_ops else "operations"
    print(f"time {TAIL_KERNEL}: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"cuSPARSE on the tail {library_ms:.4f} ms, bound {bound_ms:.4f} "
          f"ms by {bound_by} ({nbytes} bytes, {slots} slots)")
    csr_t = sparse_csr(csr, device)
    multi = plan.multi
    parts = {
        "cusparse_batch1": lambda: torch.mv(csr_t, x1),
        "default_batch1": lambda: default(x1),
        "test_batch1": lambda: layer(x1),
        "multi_spmv": kernel_call(kernel_name(multi), multi, x1),
        "flat_spmv": lambda: ops.spmv(flat, x1),
        "flat_multi_spmv": kernel_call(kernel_name(flat.multi), flat.multi,
                                       x1),
        "flat_spmv_coo": lambda: tail_y(flat, x1),
    }
    for nvec, act in acts.items():
        x = act.t().contiguous()
        parts.update({
            f"default_nvec{nvec}": lambda a=act: default(a),
            f"test_nvec{nvec}": lambda a=act: layer(a),
            f"multi_spmm_nvec{nvec}": kernel_call(
                kernel_name(multi, spmm=True), multi, x),
            f"spmm_coo_nvec{nvec}": lambda x=x: tail_y(plan, x)})
    forwards = {}
    for key, fn in parts.items():
        print(f"  test: timing {key}")
        forwards[key] = timer(fn, device)
    print(f"time test layer (a), batch 1: {forwards['test_batch1']:.4f} ms "
          f"({kernel_name(multi)} {forwards['multi_spmv']:.4f} + "
          f"{TAIL_KERNEL} {ms:.4f}); default layer "
          f"{forwards['default_batch1']:.4f} ms; cuSPARSE on the whole "
          f"weight {forwards['cusparse_batch1']:.4f} ms")
    for nvec in acts:
        print(f"time test layer (a), nvec={nvec}: "
              f"{forwards[f'test_nvec{nvec}']:.4f} ms "
              f"({kernel_name(multi, spmm=True)} "
              f"{forwards[f'multi_spmm_nvec{nvec}']:.4f} + spmm_coo "
              f"{forwards[f'spmm_coo_nvec{nvec}']:.4f}); default layer "
              f"{forwards[f'default_nvec{nvec}']:.4f} ms; cuSPARSE SpMM "
              f"{library[nvec]:.4f} ms")
    print(f"time flat-tail plan (b), batch 1: {forwards['flat_spmv']:.4f} "
          f"ms ({kernel_name(flat.multi)} "
          f"{forwards['flat_multi_spmv']:.4f} + spmv_coo "
          f"{forwards['flat_spmv_coo']:.4f})")
    return {"name": TAIL_KERNEL, "route": "cuda", "source": TAIL_SOURCE,
            "replaces": TAIL_REPLACES, "launches": launches[TAIL_KERNEL],
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms, "bound_bytes": nbytes,
            "slots": slots, "n_single": plan.n_single,
            "test_path_ms": forwards}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    print(card_line())
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    try:
        build_kernels()
        small_check(device)
        csr, mat = make_matrix()
        x_host = np.random.default_rng(0).standard_normal(
            mat.ncols).astype(np.float32)
        y64 = f64_matrix(csr) @ x_host.astype(np.float64)
        x = torch.from_numpy(x_host).to(device)
        check_auto_lowering(mat, device)
        plans, ys, launches = drive(mat, x, device)
        print(f"launches on the SpMV path: {launches}")
        errs = check(plans, ys, launches, x, y64)
        rows = measure(plans, x, csr, launches, errs)
        del plans, ys
        w, vcsr, vmat = make_vocab()
        layers = build_layers(w, vmat, device)
        test_layer = build_test_layer(w, device)
        del w
        rng = np.random.default_rng(1)
        acts = {n: torch.from_numpy(rng.standard_normal(
            (n, VOCAB["cols"])).astype(np.float32)).to(device)
            for n in SPMM_NVECS}
        vys, y1, vlaunches = drive_vocab(layers, acts, device)
        print(f"launches on the SparseLinear path: {vlaunches}")
        verrs = check_vocab(layers, vys, y1, vlaunches, acts, vcsr)
        del vys, y1
        vper, library = measure_vocab(layers, acts, vcsr)
        tplan = build_token_plan(vmat, device)
        del vmat
        x1 = acts[SPMM_NVECS[0]][0].contiguous()
        tys, tlaunches = drive_token(tplan, x1, acts, device)
        print(f"launches on the whole-vector descriptor path: {tlaunches}")
        a64 = f64_matrix(vcsr)
        y64 = a64 @ x1.cpu().double().numpy()
        terrs = {name: check_y(name, tys[name], tplan, x1, y64, tlaunches,
                               "token path") for name in TOKEN_KERNELS}
        if tlaunches["spmm_cuda_desc"] <= 0:
            raise SmokeFailure(f"spmm_cuda_desc was not launched on the "
                               f"whole-vector descriptor path ({tlaunches})")
        for nvec, act in acts.items():
            x = act.t().contiguous()
            err = check_spmm("spmm_cuda_desc", tys["spmm_cuda_desc", nvec],
                             tplan, x, a64 @ x.cpu().double().numpy(),
                             "whole-vector descriptor path")
            terrs["spmm_cuda_desc"] = max(terrs.get("spmm_cuda_desc", 0.0),
                                          err)
        del tys
        token = measure_token(tplan, layers["whole_vector", "mask"].plan, x1,
                              acts, vcsr, tlaunches, terrs, vper, library)
        for row in rows:
            if row["name"] in token:
                row["vocab_batch1"] = token[row["name"]]
        rows += spmm_rows(VOCAB_SPMM, vper, vlaunches, verrs)
        rows += spmm_rows(("spmm_cuda_desc",), vper, tlaunches, terrs)
        del tplan
        flat = build_flat_test_plan(vcsr, device)
        ys, y_flat, la, lb = drive_test(test_layer, flat, x1, acts, device)
        print(f"launches on the test path: (a) {la}; (b) {lb}")
        check_test(test_layer, flat, ys, y_flat, la, lb, x1, acts, vcsr)
        del ys, y_flat
        tail_err, tail = check_tail(test_layer.plan, x1)
        rows.append(measure_test(test_layer, flat,
                                 layers["panels", "descriptor"], x1, acts,
                                 vcsr, tail, la, tail_err, library))
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
