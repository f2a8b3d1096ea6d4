#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py

What it does, in order, failing (exit code 1, no result line) at the first
phase that goes wrong:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a, one nvcc per source, all started together, and prints the
   build time and each kernel's registers (``-Xptxas -v``);
3. holds all seven kernels against their plain PyTorch versions on small
   matrices of every supported block shape (SpMM at nvec 3, 16 and 128);
4. SpMV path: builds ``matgen.fem_blocks(200_000, 4, 12, seed=5)``, the
   SET_A bone010 structure class at 200,000 rows (about 9.5 M nonzeros), in
   beta(4,4), and drives ``ops.prepare`` + ``ops.spmv`` through both
   layouts (whole-vector, cb=256; panels, pr=512, cb=64, xw=512), each with
   ``double_buffer`` True and False;
5. SparseLinear path: the vocab projection of yi-6b (64,000 x 4,096, the
   weight ``serve.py``'s vocab bench draws: ``default_rng(0)``, standard
   normal, float32), magnitude-pruned to density 0.1 in beta(4,8), through
   ``SparseLinear.from_dense(..., nvec=128)`` (layout auto: panels), a
   whole-vector layer on the same matrix, ``ops.spmm(...,
   double_buffer=False)`` and a batch-1 call, at batches of 16 and 128;
6. in each path every launch counter is set to 0 just before and read just
   after, and every kernel of the path must have launched; every output is
   checked against the kernel's plain version on the card and against a
   float64 scipy product on the host, both within ``1e-5 * max|y_ref|``
   (f32 sums in another order);
7. times each kernel, its plain version and the cuSPARSE call on the same
   inputs (``torch.mv`` / ``@`` on a ``torch.sparse_csr_tensor``; timed
   only, never used by the port) with CUDA events, after warm-up, with L2
   flushed before every launch, and computes each kernel's bound from this
   run's bytes over 3.35 TB/s and its flops over 67 TFLOP/s;
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
SPMM_SOURCE = "src/repro_torch/kernels/csrc/spc5_spmm.cu"


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
                m = re.search(r"(sp(?:mv|mm)_(?:whole|panels)_kernel)I"
                              r"((?:Li\d+E)+)E", line)
                if m:
                    targs = re.findall(r"Li(\d+)E", m.group(2))
                    kernel = f"{m.group(1)}<{','.join(targs)}>"
                else:
                    kernel = line.split("'")[1]
            elif "Used" in line and kernel:
                print(f"    {kernel}: {line.split(':', 1)[1].strip()}")
    if not _build.BUILD_LOG:
        print("  loaded from an earlier build")


def plain_y(plan, x):
    """The plain version of the plan's kernel: SpMV for a 1-D x, SpMM for a
    2-D X."""
    from repro_torch.core import ref_spmv as R
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


def small_check(device) -> None:
    """All seven kernels against their plain versions, every block shape,
    several chunks and panels (302x260, cb=16, pr=xw=64); the SpMM kernels
    at nvec 3, 16 and 128."""
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
        plans = {layout: ops.prepare(mat, layout=layout, lowering="mask",
                                     tune=False, device=device, **geom)
                 for layout, geom in (("whole_vector", dict(cb=16)),
                                      ("panels", dict(pr=64, xw=64, cb=16)))}
        runs = [(name, layout, x, lambda p, v, db=db: ops.spmv(
                    p, v, double_buffer=db))
                for name, (layout, db, _) in KERNELS.items()]
        for nvec in (3, 16, 128):
            xm = torch.from_numpy(rng.standard_normal(
                (260, nvec)).astype(np.float32)).to(device)
            runs += [(f"{name} nvec={nvec}", layout, xm,
                      lambda p, v, db=db: ops.spmm(p, v, double_buffer=db))
                     for name, (layout, db, _) in SPMM_KERNELS.items()]
        for name, layout, v, run in runs:
            err = rel_err(run(plans[layout], v), plain_y(plans[layout], v))
            worst = max(worst, err)
            if not err <= TOL:
                raise SmokeFailure(f"small check: {name} {rc} rel err {err}")
    print(f"small check: {len(KERNELS) + len(SPMM_KERNELS)} kernels x "
          f"{len(F.SUPPORTED_BLOCKS)} block shapes (SpMM at nvec 3, 16, 128) "
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


def bound(plan, nnz, nvec=1):
    """The least time for one SpMV (nvec = 1) or SpMM: every input array of
    this run read once (the plan's arrays as built, padding included, and
    X) and Y written once, over the HBM rate; 2 flops per nonzero and
    column over the f32 rate. Returns (ms, "bytes" | "operations",
    bytes)."""
    nbytes = (sum(a.numel() * a.element_size() for a in plan.arrays)
              + 4 * nvec * (plan.ncols + plan.nrows))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * nnz * nvec / F32_FLOP_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations", nbytes)


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
    from repro_torch.kernels import spc5_spmv as K
    fn = getattr(KM if name.startswith("spmm") else K, name)
    args = ((plan.chunk_vbase, plan.chunk_xbase) if plan.layout == "panels"
            else (plan.chunk_vbase,))
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
    for layout, plan in plans.items():
        print(f"  timing the plain version, {layout}")
        plain_ms[layout] = timer(lambda p=plan: plain_y(p, x), device)
    rows = []
    for name, (layout, db, replaces) in KERNELS.items():
        plan = plans[layout]
        print(f"  timing {name}")
        ms = timer(kernel_call(name, plan, x), device)
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


# ----------------------------------------------------------------------------
# SparseLinear path: the yi-6b vocab projection
# ----------------------------------------------------------------------------

def make_vocab():
    """The vocab weight as serve.py's vocab bench draws it (float64 normal
    from ``default_rng(0)``, cast to float32), and its CSR and beta(4,8)
    matrix pruned and converted as ``SparseLinear.from_dense`` does it: the
    CSR feeds the f64 product and cuSPARSE, the matrix the whole-vector
    layer."""
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


def build_layers(w, mat, device):
    """The layers of the path: ``SparseLinear.from_dense`` with the layout
    left to "auto" at nvec=128 (panels), and a whole-vector layer on the
    same converted matrix."""
    from repro_torch.core.sparse_linear import SparseLinear
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmm as KM
    t0 = time.perf_counter()
    auto = SparseLinear.from_dense(w, density=VOCAB["density"],
                                   block=VOCAB["block"], nvec=VOCAB["nvec"],
                                   device=device)
    t1 = time.perf_counter()
    whole = SparseLinear(ops.prepare(mat, layout="whole_vector",
                                     nvec=VOCAB["nvec"], device=device))
    t2 = time.perf_counter()
    print(f"layers: from_dense {t1 - t0:.1f} s (prune, convert, plan), "
          f"whole-vector plan {t2 - t1:.1f} s")
    layout_pass = next(e for e in auto.plan.trace if e["pass"] == "layout")
    if auto.plan.layout != "panels":
        raise SmokeFailure(f"from_dense(nvec={VOCAB['nvec']}) chose "
                           f"{auto.plan.layout!r}, not panels: {layout_pass}")
    print(f"  auto layout: {layout_pass['layout']} ({layout_pass['reason']})")
    for layer in (auto, whole):
        plan = layer.plan
        g = {k: getattr(plan, k) for k in ("cb", "vmax", "pr", "xw",
                                           "npanels", "nchunks")
             if k in dict(plan.meta)}
        units = (plan.npanels if plan.layout == "panels"
                 else int(plan.chunk_vbase.shape[0]))
        for nvec in SPMM_NVECS:
            # each SpMM kernel's column tile, CTAs and shared memory per CTA
            for stages in ((1, 2) if plan.layout == "panels" else (1,)):
                if plan.layout == "panels":
                    def smem(t, s=stages, p=plan):
                        return KM.panels_smem_bytes(s, p.cb, p.vmax, p.pr, t)
                    tw = KM.column_tile(nvec, smem)
                    nbytes = smem(tw)
                else:
                    tw = KM.column_tile(nvec)
                    nbytes = KM.whole_smem_bytes(plan.cb, plan.vmax)
                g[f"nvec{nvec}_s{stages}"] = dict(
                    tile=tw, ctas=units * -(-nvec // tw), smem_bytes=nbytes)
        print(f"  plan {plan.layout}: {g}, build "
              f"{plan.trace[-1]['duration_s']:.1f} s")
    return {"panels": auto, "whole_vector": whole}


def drive_vocab(layers, acts, device):
    """The SparseLinear path, through the entry points a user calls: both
    layers on every batch, ``ops.spmm(..., double_buffer=False)`` on the
    auto layer's plan, and one batch-1 call. Returns each kernel's Y
    (rows, nvec) per batch, the batch-1 y and this run's launch counts."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import spc5_spmm as KM
    from repro_torch.kernels import spc5_spmv as K
    K.reset_launches()
    KM.reset_launches()
    auto, whole = layers["panels"], layers["whole_vector"]
    ys = {}
    for nvec, a in acts.items():
        ys["spmm_cuda_panels_db", nvec] = auto(a).t()
        ys["spmm_cuda", nvec] = whole(a).t()
        ys["spmm_cuda_panels", nvec] = ops.spmm(
            auto.plan, a.t().contiguous(), double_buffer=False)
    y1 = auto(acts[SPMM_NVECS[0]][0])
    if device.type == "cuda":
        torch.cuda.synchronize()
    return ys, y1, {**K.LAUNCHES, **KM.LAUNCHES}


def check_vocab(layers, ys, y1, launches, acts, csr):
    """Every SpMM kernel and the batch-1 SpMV kernel launched; each output
    is finite, of the right shape and within tolerance of its plain version
    and of the f64 product."""
    import scipy.sparse
    import torch
    for name in (*SPMM_KERNELS, "spmv_cuda_panels_db"):
        if launches.get(name, 0) <= 0:
            raise SmokeFailure(f"{name} was not launched on the SparseLinear "
                               f"path (counts {launches})")
    a64 = scipy.sparse.csr_matrix((csr.values.astype(np.float64), csr.colidx,
                                   csr.rowptr), shape=csr.shape)
    errs = {}
    for nvec, act in acts.items():
        x = act.t().contiguous()
        y64 = a64 @ x.cpu().double().numpy()
        for name, (layout, _, _) in SPMM_KERNELS.items():
            y, plan = ys[name, nvec], layers[layout].plan
            if (tuple(y.shape) != (plan.nrows, nvec)
                    or not bool(torch.isfinite(y).all())):
                raise SmokeFailure(f"{name}: bad output {tuple(y.shape)}")
            plain = plain_y(plan, x)
            abs_err = float((y - plain).abs().max())
            e_plain, e64 = rel_err(y, plain), rel_err(y, torch.from_numpy(y64))
            del plain
            print(f"check {name} nvec={nvec}: max|Y - plain| = "
                  f"{abs_err:.3g} ({e_plain:.3g} of max|Y|), vs f64 scipy "
                  f"{e64:.3g} of max|Y|")
            if not (e_plain <= TOL and e64 <= TOL):
                raise SmokeFailure(f"{name} nvec={nvec} disagrees: {e_plain} "
                                   f"/ {e64} > {TOL}")
            errs[name] = max(errs.get(name, 0.0), abs_err)
    x1 = acts[SPMM_NVECS[0]][0]
    plan = layers["panels"].plan
    e_plain = rel_err(y1, plain_y(plan, x1))
    e64 = rel_err(y1, torch.from_numpy(a64 @ x1.cpu().double().numpy()))
    print(f"check batch-1 SparseLinear (spmv_cuda_panels_db): {e_plain:.3g} "
          f"/ {e64:.3g} of max|y| against plain / f64")
    if tuple(y1.shape) != (plan.nrows,) or not (e_plain <= TOL
                                                 and e64 <= TOL):
        raise SmokeFailure(f"batch-1 layer call disagrees: {e_plain} / {e64}")
    return errs


def measure_vocab(layers, acts, csr, launches, errs, timer=cuda_time_ms):
    """Each SpMM kernel, its plain version and cuSPARSE SpMM at every batch;
    the JSON row carries nvec=128 in its main keys and nvec=16 beside."""
    import torch
    device = next(iter(acts.values())).device
    csr_t = sparse_csr(csr, device)
    per = {}
    for nvec, act in acts.items():
        x = act.t().contiguous()
        print(f"  nvec={nvec}: timing cuSPARSE SpMM (sparse_csr_tensor @ X)")
        library_ms = timer(lambda: csr_t @ x, device)
        if nvec == max(acts):
            dense = csr_t.to_dense()
            print(f"  nvec={nvec}: timing dense torch.matmul of the pruned "
                  f"weight (context only)")
            dense_ms = timer(lambda: dense @ x, device)
            print(f"context: dense f32 matmul {dense_ms:.4f} ms")
            del dense
        plain_ms = {}
        for layout, layer in layers.items():
            print(f"  nvec={nvec}: timing the plain version, {layout}")
            plain_ms[layout] = timer(lambda p=layer.plan: plain_y(p, x),
                                     device)
        for name, (layout, _, _) in SPMM_KERNELS.items():
            plan = layers[layout].plan
            print(f"  nvec={nvec}: timing {name}")
            ms = timer(kernel_call(name, plan, x), device)
            bound_ms, bound_by, nbytes = bound(plan, csr.nnz, nvec)
            print(f"time {name} nvec={nvec}: {ms:.4f} ms, plain "
                  f"{plain_ms[layout]:.4f} ms, cuSPARSE SpMM "
                  f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms by "
                  f"{bound_by} ({nbytes} bytes)")
            per[name, nvec] = {"ms": ms, "plain_ms": plain_ms[layout],
                               "bound_ms": bound_ms, "bound_by": bound_by,
                               "library_ms": library_ms}
    rows = []
    for name, (_, _, replaces) in SPMM_KERNELS.items():
        rows.append({"name": name, "route": "cuda", "source": SPMM_SOURCE,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": errs[name],
                     **per[name, VOCAB["nvec"]], "nvec": VOCAB["nvec"],
                     **{f"nvec_{n}": per[name, n] for n in SPMM_NVECS
                        if n != VOCAB["nvec"]}})
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
        print(f"launches on the SpMV path: {launches}")
        errs = check(plans, ys, launches, x, y64)
        rows = measure(plans, x, csr, launches, errs)
        del plans, ys
        w, vcsr, vmat = make_vocab()
        layers = build_layers(w, vmat, device)
        del w, vmat
        rng = np.random.default_rng(1)
        acts = {n: torch.from_numpy(rng.standard_normal(
            (n, VOCAB["cols"])).astype(np.float32)).to(device)
            for n in SPMM_NVECS}
        vys, y1, vlaunches = drive_vocab(layers, acts, device)
        print(f"launches on the SparseLinear path: {vlaunches}")
        verrs = check_vocab(layers, vys, y1, vlaunches, acts, vcsr)
        del vys
        rows += measure_vocab(layers, acts, vcsr, vlaunches, verrs)
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
