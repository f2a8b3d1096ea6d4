#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

What it does, in order, failing (exit code 1, no result line) at the first
phase that goes wrong:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a and prints the build time and each kernel's registers and
   shared memory (``-Xptxas -v``);
3. holds all four kernels against their plain PyTorch versions on small
   matrices of every supported block shape;
4. builds the realistic matrix: ``matgen.fem_blocks(200_000, 4, 12,
   seed=5)``, the SET_A bone010 structure class at 200,000 rows (about
   9.5 M nonzeros), in beta(4,4);
5. drives the main path through ``ops.prepare`` and ``ops.spmv``: both
   layouts (whole-vector, cb=256; panels, pr=512, cb=64, xw=512), each with
   ``double_buffer`` True and False, with every launch counter set to 0
   just before and read just after; every kernel must have launched;
6. checks each y against the kernel's plain version on the card and against
   a float64 scipy product of the CSR on the host, both within
   ``1e-5 * max|y_ref|`` (f32 sums in another order);
7. times each kernel, its plain version and ``torch.sparse_csr_tensor @ x``
   (cuSPARSE; timed only, never used by the port) with CUDA events, after
   warm-up, with L2 flushed before every launch, and computes each kernel's
   bound from the bytes of this run's arrays over 3.35 TB/s;
8. prints the ``{"kernels": [...]}`` line, then, last, the
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
KERNELS = {
    # name: (layout, double_buffer, the Pallas function it replaces)
    "spmv_cuda_db": ("whole_vector", True,
                     "src/repro/kernels/spc5_spmv.py:1000"),
    "spmv_cuda": ("whole_vector", False,
                  "src/repro/kernels/spc5_spmv.py:223"),
    "spmv_cuda_panels_db": ("panels", True,
                            "src/repro/kernels/spc5_spmv.py:490"),
    "spmv_cuda_panels": ("panels", False,
                         "src/repro/kernels/spc5_spmv.py:376"),
}
SOURCE = "src/repro_torch/kernels/csrc/spc5_spmv.cu"


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
                m = re.search(r"(spmv_(?:whole|panels)_kernel)ILi(\d)E",
                              line)
                kernel = f"{m.group(1)}<{m.group(2)}>" if m else \
                    line.split("'")[1]
            elif "Used" in line and kernel:
                print(f"    {kernel}: {line.split(':', 1)[1].strip()}")
    if not _build.BUILD_LOG:
        print("  loaded from an earlier build")


def plain_y(plan, x):
    from repro_torch.core import ref_spmv as R
    if plan.layout == "panels":
        return R.spmv_panels(plan.dev, x, r=plan.r, c=plan.c, pr=plan.pr,
                             nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    return R.spmv(plan.dev, x, r=plan.r, c=plan.c, nrows=plan.nrows,
                  ncols=plan.ncols)


def rel_err(y, y_ref) -> float:
    import torch
    y_ref = torch.as_tensor(y_ref, device=y.device)
    scale = max(float(y_ref.abs().max()), 1.0)
    return float((y.double() - y_ref.double()).abs().max()) / scale


def small_check(device) -> None:
    """All four kernels against their plain versions, every block shape,
    several chunks and panels (302x260, cb=16, pr=xw=64)."""
    import torch
    from repro_torch.core import formats as F
    from repro_torch.kernels import ops
    worst = 0.0
    for rc in F.SUPPORTED_BLOCKS:
        rng = np.random.default_rng(10 * rc[0] + rc[1])
        d = ((rng.random((302, 260)) < 0.08)
             * rng.standard_normal((302, 260))).astype(np.float32)
        mat = F.csr_to_spc5(F.csr_from_dense(d), *rc)
        x = torch.from_numpy(rng.standard_normal(260).astype(np.float32))
        x = x.to(device)
        for name, (layout, db, _) in KERNELS.items():
            geom = dict(pr=64, xw=64, cb=16) if layout == "panels" else \
                dict(cb=16)
            plan = ops.prepare(mat, layout=layout, lowering="mask",
                               tune=False, device=device, **geom)
            err = rel_err(ops.spmv(plan, x, double_buffer=db),
                          plain_y(plan, x))
            worst = max(worst, err)
            if not err <= TOL:
                raise SmokeFailure(f"small check: {name} {rc} rel err {err}")
    print(f"small check: 4 kernels x {len(F.SUPPORTED_BLOCKS)} block shapes "
          f"agree with the plain versions (worst {worst:.3g} of max|y|)")


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


def drive(mat, x, device):
    """The main path, through the entry points a user calls. Returns the
    plans, each kernel's y and the launch counts of this run alone."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmv as K
    K.reset_launches()
    plans, ys = {}, {}
    for layout, geom in GEOM.items():
        plans[layout] = ops.prepare(mat, layout=layout, lowering="mask",
                                    tune=False, device=device, **geom)
    for name, (layout, db, _) in KERNELS.items():
        ys[name] = ops.spmv(plans[layout], x, double_buffer=db)
    if device.type == "cuda":
        torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    for layout, plan in plans.items():
        g = {k: getattr(plan, k) for k in ("cb", "vmax", "pr", "xw",
                                           "npanels", "nchunks")
             if k in dict(plan.meta)}
        if layout == "whole_vector":
            g["nchunks"] = int(plan.chunk_vbase.shape[0])
        for stages in (1, 2):
            # the kernels' dynamic shared memory per CTA (ptxas reports
            # only static shared memory, which is 0)
            g[f"smem_bytes_s{stages}"] = 4 * (
                stages * (plan.vmax + plan.xw) + plan.pr
                if layout == "panels" else stages * plan.vmax)
        print(f"plan {layout}: {g}, build "
              f"{plan.trace[-1]['duration_s']:.1f} s")
    return plans, ys, launches


def check(plans, ys, launches, x, y64):
    """Every kernel launched, and each y is finite, of the right shape and
    within tolerance of its plain version and of the f64 product."""
    import torch
    errs = {}
    for name, (layout, _, _) in KERNELS.items():
        y, plan = ys[name], plans[layout]
        if launches.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched on the main path "
                               f"(counts {launches})")
        if tuple(y.shape) != (plan.nrows,) or not bool(torch.isfinite(y).all()):
            raise SmokeFailure(f"{name}: bad output {tuple(y.shape)}")
        plain = plain_y(plan, x)
        abs_err = float((y - plain).abs().max())
        e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
        print(f"check {name}: max|y - plain| = {abs_err:.3g} "
              f"({e_plain:.3g} of max|y|), vs f64 scipy {e64:.3g} of max|y|")
        if not (e_plain <= TOL and e64 <= TOL):
            raise SmokeFailure(f"{name} disagrees: {e_plain} / {e64} > {TOL}")
        errs[name] = abs_err
    return errs


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


def bound(plan, nnz):
    """The least time for one SpMV: every input array of this run read
    once (the plan's arrays as built, padding included, and x) and y
    written once, over the HBM rate; 2 flops per nonzero over the f32
    rate. Returns (ms, "bytes" | "operations", bytes)."""
    nbytes = (sum(a.numel() * a.element_size() for a in plan.arrays)
              + 4 * plan.ncols + 4 * plan.nrows)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


def measure(plans, x, csr, launches, errs, timer=cuda_time_ms):
    import torch
    from repro_torch.kernels import spc5_spmv as K
    device = x.device
    with warnings.catch_warnings():     # "beta state" / invariant notices
        warnings.simplefilter("ignore", UserWarning)
        csr_t = torch.sparse_csr_tensor(
            torch.from_numpy(csr.rowptr.astype(np.int32)),
            torch.from_numpy(csr.colidx.astype(np.int32)),
            torch.from_numpy(csr.values.astype(np.float32)),
            size=csr.shape, device=device)
    print("  timing cuSPARSE CSR (torch.mv on sparse_csr_tensor)")
    library_ms = timer(lambda: torch.mv(csr_t, x), device)
    plain_ms = {}
    for layout, plan in plans.items():
        print(f"  timing the plain version, {layout}")
        plain_ms[layout] = timer(lambda p=plan: plain_y(p, x), device)
    rows = []
    for name, (layout, db, replaces) in KERNELS.items():
        plan = plans[layout]
        args = ((plan.chunk_vbase, plan.chunk_xbase) if layout == "panels"
                else (plan.chunk_vbase,))
        args += (plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
                 plan.chunk_row, plan.values, x)
        kw = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                  nrows=plan.nrows)
        kw.update(dict(xw=plan.xw, pr=plan.pr, ncols_pad=plan.ncols_pad)
                  if layout == "panels" else dict(ncols=plan.ncols))
        fn = getattr(K, name)
        print(f"  timing {name}")
        ms = timer(lambda f=fn, a=args, k=kw: f(*a, **k), device)
        bound_ms, bound_by, nbytes = bound(plan, csr.nnz)
        print(f"time {name}: {ms:.4f} ms, plain {plain_ms[layout]:.4f} ms, "
              f"cuSPARSE CSR {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({nbytes} bytes)")
        rows.append({"name": name, "route": "cuda", "source": SOURCE,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name], "ms": ms,
                     "plain_ms": plain_ms[layout], "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": library_ms})
    return rows


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
        import scipy.sparse
        y64 = scipy.sparse.csr_matrix(
            (csr.values, csr.colidx, csr.rowptr), shape=csr.shape
        ) @ x_host.astype(np.float64)
        x = torch.from_numpy(x_host).to(device)
        plans, ys, launches = drive(mat, x, device)
        print(f"launches on the main path: {launches}")
        errs = check(plans, ys, launches, x, y64)
        rows = measure(plans, x, csr, launches, errs)
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
