"""The port's CUDA kernels (mask SpMV and SpMM, descriptor SpMV and SpMM,
the test split's singleton tail) against their plain PyTorch versions, on
the card.

Every test here needs an NVIDIA GPU with nvcc: it is marked ``gpu`` and
skips from the ``cuda`` fixture where ``torch.cuda.is_available()`` is
False (decided when the test runs, so every pytest-xdist worker collects
the same tests). Run on the card with

    python -m pytest -m gpu tests/test_torch_gpu.py

This file imports only torch, numpy and the port (the card's machine has no
JAX). Tolerance: the kernels sum each row in another f32 order than the
plain version (the whole-vector kernels through global atomics, in an order
that changes from run to run), so outputs agree to ``1e-5 * max|y|`` (per
whole Y for SpMM).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import formats as F
from repro_torch.core import matgen
from repro_torch.core import ref_spmv as R
from repro_torch.core.sparse_linear import SparseLinear
from repro_torch.kernels import ops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD
from repro_torch.kernels import spc5_spmv_tail as KT

pytestmark = pytest.mark.gpu

RTOL = 1e-5

KERNELS = ("spmv_cuda", "spmv_cuda_db", "spmv_cuda_panels",
           "spmv_cuda_panels_db")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu "
                    "tests/test_torch_gpu.py on the card)")
    return torch.device("cuda")


def _matrix(rc, n=300, m=260, density=0.08, seed=0):
    rng = np.random.default_rng(seed + 10 * rc[0] + rc[1])
    d = ((rng.random((n, m)) < density)
         * rng.standard_normal((n, m))).astype(np.float32)
    return F.csr_to_spc5(F.csr_from_dense(d), *rc)


def _run(kernel, mat, x, device, **geom):
    layout = "panels" if "panels" in kernel else "whole_vector"
    plan = ops.prepare(mat, layout=layout, lowering="mask", tune=False,
                       device=device, **geom)
    xt = torch.from_numpy(x).to(device)
    dev = plan.dev
    if layout == "panels":
        plain = R.spmv_panels(dev, xt, r=plan.r, c=plan.c, pr=plan.pr,
                              nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    else:
        plain = R.spmv(dev, xt, r=plan.r, c=plan.c, nrows=plan.nrows,
                       ncols=plan.ncols)
    before = K.LAUNCHES[kernel]
    y = ops.spmv(plan, xt, double_buffer=kernel.endswith("_db"))
    torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == before + 1
    assert y.device.type == "cuda" and y.shape == (mat.nrows,)
    scale = float(plain.abs().max())
    err = float((y - plain).abs().max())
    assert torch.isfinite(y).all()
    assert err <= RTOL * max(scale, 1.0), (err, scale)
    return plan


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_kernel_matches_plain(cuda, kernel, rc):
    """Several chunks and panels (pr=64, xw=64, cb=16), nrows % r != 0 for
    r in (4, 8), and bit-31 masks for 4x8 / 8x4."""
    mat = _matrix(rc, n=302)
    x = np.random.default_rng(1).standard_normal(mat.ncols).astype(np.float32)
    geom = (dict(pr=64, xw=64, cb=16) if "panels" in kernel
            else dict(cb=16))
    plan = _run(kernel, mat, x, cuda, **geom)
    assert plan.npanels > 1 if "panels" in kernel else plan.cb == 16


@pytest.mark.parametrize("kernel", KERNELS)
def test_fem_matrix_default_geometry(cuda, kernel):
    """The chip_smoke matrix class (SET_A bone010) at a small size, with the
    layouts' default geometry."""
    csr = matgen.fem_blocks(8_000, 4, 12, seed=5)
    mat = F.csr_to_spc5(csr, 4, 4)
    x = np.random.default_rng(2).standard_normal(mat.ncols).astype(np.float32)
    _run(kernel, mat, x, cuda)


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("kind", ["empty", "last_row_only", "left_columns"])
def test_edge_matrices(cuda, kernel, kind):
    """No nonzero at all; one nonzero in the last row and column (nrows %
    r != 0); nonzeros only in the first columns (panel ncols_pad < ncols)."""
    d = np.zeros((37, 29), np.float32)
    if kind == "last_row_only":
        d[36, 28] = 2.0
    elif kind == "left_columns":
        d[::3, :9] = np.random.default_rng(6).standard_normal((13, 9))
    mat = F.csr_to_spc5(F.csr_from_dense(d), 8, 4)
    x = np.random.default_rng(7).standard_normal(29).astype(np.float32)
    geom = (dict(pr=16, xw=16, cb=4) if "panels" in kernel else dict(cb=4))
    _run(kernel, mat, x, cuda, **geom)


@pytest.mark.parametrize("kernel", ("spmv_cuda", "spmv_cuda_db"))
def test_cb512_needs_large_shared_memory(cuda, kernel):
    """cb=512 at 4x8 on a dense-ish matrix: vmax is far above 48 KB / 4 B per
    stage, so the launch must opt in to large dynamic shared memory."""
    mat = _matrix((4, 8), n=512, m=512, density=0.9)
    x = np.random.default_rng(3).standard_normal(mat.ncols).astype(np.float32)
    plan = _run(kernel, mat, x, cuda, cb=512)
    stages = 2 if kernel.endswith("_db") else 1
    assert stages * plan.vmax * 4 > 48 * 1024


def test_oversized_shared_memory_raises(cuda):
    mat = _matrix((4, 8), n=1024, m=1024, density=0.95)
    plan = ops.prepare(mat, layout="whole_vector", lowering="mask",
                       cb=2048, tune=False, device=cuda)
    x = torch.zeros(mat.ncols, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spmv(plan, x)


def test_cuda_plan_rejects_cpu_x(cuda):
    plan = ops.prepare(_matrix((2, 4)), layout="panels", lowering="mask",
                       tune=False, device=cuda)
    with pytest.raises(ValueError, match="device"):
        ops.spmv(plan, torch.zeros(plan.ncols))


# ----------------------------------------------------------------------------
# SpMM
# ----------------------------------------------------------------------------

SPMM_KERNELS = ("spmm_cuda", "spmm_cuda_panels", "spmm_cuda_panels_db")


def _run_spmm(kernel, mat, nvec, device, nvt=128, seed=4, **geom):
    layout = "panels" if "panels" in kernel else "whole_vector"
    plan = ops.prepare(mat, layout=layout, lowering="mask", tune=False,
                       device=device, **geom)
    xh = np.random.default_rng(seed).standard_normal(
        (mat.ncols, nvec)).astype(np.float32)
    xt = torch.from_numpy(xh).to(device)
    dev = plan.dev
    if layout == "panels":
        plain = R.spmm_panels(dev, xt, r=plan.r, c=plan.c, pr=plan.pr,
                              nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    else:
        plain = R.spmm(dev, xt, r=plan.r, c=plan.c, nrows=plan.nrows,
                       ncols=plan.ncols)
    before = KM.LAUNCHES[kernel]
    y = ops.spmm(plan, xt, nvt=nvt, double_buffer=kernel.endswith("_db"))
    torch.cuda.synchronize()
    assert KM.LAUNCHES[kernel] == before + 1
    assert y.device.type == "cuda" and y.shape == (mat.nrows, nvec)
    assert torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale)
    return plan


@pytest.mark.parametrize("nvec", [3, 16, 128])
@pytest.mark.parametrize("kernel", SPMM_KERNELS)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_spmm_kernel_matches_plain(cuda, kernel, rc, nvec):
    """Several chunks and panels (pr=64, xw=64, cb=16), nrows % r != 0 for
    r in (4, 8), bit-31 masks, and column tiles of 4 (nvec=3, one idle
    lane), 16 and 32 (four tiles)."""
    mat = _matrix(rc, n=302)
    geom = (dict(pr=64, xw=64, cb=16) if "panels" in kernel
            else dict(cb=16))
    _run_spmm(kernel, mat, nvec, cuda, **geom)


@pytest.mark.parametrize("kernel", SPMM_KERNELS)
def test_spmm_partial_column_tile(cuda, kernel):
    """nvec = 40 with nvt = 8: two column tiles of 32, the second with 24
    idle lanes."""
    _run_spmm(kernel, _matrix((2, 4), n=150, m=90), 40, cuda, nvt=8,
              **(dict(pr=32, xw=32, cb=8) if "panels" in kernel
                 else dict(cb=8)))


@pytest.mark.parametrize("kernel", SPMM_KERNELS)
@pytest.mark.parametrize("kind", ["empty", "last_row_only", "left_columns"])
def test_spmm_edge_matrices(cuda, kernel, kind):
    d = np.zeros((37, 29), np.float32)
    if kind == "last_row_only":
        d[36, 28] = 2.0
    elif kind == "left_columns":
        d[::3, :9] = np.random.default_rng(6).standard_normal((13, 9))
    mat = F.csr_to_spc5(F.csr_from_dense(d), 8, 4)
    geom = (dict(pr=16, xw=16, cb=4) if "panels" in kernel else dict(cb=4))
    _run_spmm(kernel, mat, 5, cuda, **geom)


@pytest.mark.parametrize("kernel", SPMM_KERNELS)
def test_spmm_smoke_geometry(cuda, kernel):
    """The largest geometry chip_smoke.py uses: pr=512, cb=64, xw=512 for
    panels (a (512, 32) Y tile beside two value windows), cb=256 for
    whole-vector, at 4x8 and nvec=128, on a 2,000 x 4,096 slice of the
    density-0.1 vocab weight."""
    w = np.random.default_rng(0).standard_normal((2_000, 4_096), np.float32)
    w = np.where(np.abs(w) >= np.quantile(np.abs(w), 0.9), w, 0.0)
    mat = F.csr_to_spc5(F.csr_from_dense(w.astype(np.float32)), 4, 8)
    geom = (dict(pr=512, xw=512, cb=64) if "panels" in kernel
            else dict(cb=256))
    plan = _run_spmm(kernel, mat, 128, cuda, **geom)
    if "panels" in kernel:
        stages = 2 if kernel.endswith("_db") else 1
        tw = KM.column_tile(128, lambda tw: KM.panels_smem_bytes(
            stages, plan.cb, plan.vmax, plan.pr, tw))
        assert tw == 32


def test_spmm_oversized_shared_memory_raises(cuda):
    mat = _matrix((4, 8), n=1024, m=1024, density=0.95)
    plan = ops.prepare(mat, layout="whole_vector", lowering="mask",
                       cb=2048, tune=False, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spmm(plan, torch.zeros(mat.ncols, 4, device=cuda))


def test_spmm_cuda_plan_rejects_cpu_x(cuda):
    plan = ops.prepare(_matrix((2, 4)), layout="panels", lowering="mask",
                       tune=False, device=cuda)
    with pytest.raises(ValueError, match="device"):
        ops.spmm(plan, torch.zeros(plan.ncols, 4))


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_sparse_linear_on_the_card_matches_the_cpu_layer(cuda, layout):
    """Batch 1 goes to an SpMV kernel, wider batches to an SpMM kernel; the
    card's layer agrees with the same layer built on the CPU."""
    rng = np.random.default_rng(9)
    w = rng.standard_normal((300, 200)).astype(np.float32)
    b = rng.standard_normal(300).astype(np.float32)
    kw = dict(density=0.2, block=(4, 8), bias=b, layout=layout,
              lowering="mask", tune=False)
    on_card = SparseLinear.from_dense(w, device=cuda, **kw)
    on_cpu = SparseLinear.from_dense(w, device="cpu", **kw)
    assert on_card.plan.layout == layout and on_card.bias.device.type == "cuda"
    for shape in [(200,), (1, 200), (5, 200), (2, 3, 200)]:
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        K.reset_launches()
        KM.reset_launches()
        y = on_card(x.to(cuda))
        torch.cuda.synchronize()
        spmv_runs = sum(K.LAUNCHES.values())
        spmm_runs = sum(KM.LAUNCHES.values())
        batch = int(np.prod(shape[:-1]))
        assert (spmv_runs, spmm_runs) == ((1, 0) if batch == 1 else (0, 1))
        ref = on_cpu(x)
        assert y.shape == ref.shape == (*shape[:-1], 300)
        err = float((y.cpu() - ref).abs().max())
        assert err <= RTOL * float(ref.abs().max()), err


# ----------------------------------------------------------------------------
# descriptor SpMV
# ----------------------------------------------------------------------------

DESC_KERNELS = ("spmv_cuda_desc", "spmv_cuda_desc_db",
                "spmv_cuda_panels_desc", "spmv_cuda_panels_desc_db")


def _run_desc(kernel, mat, x, device, **geom):
    layout = "panels" if "panels" in kernel else "whole_vector"
    plan = ops.prepare(mat, layout=layout, lowering="descriptor", tune=False,
                       device=device, **geom)
    xt = torch.from_numpy(x).to(device)
    if layout == "panels":
        plain = R.spmv_panels_desc(plan.dev, xt, pr=plan.pr,
                                   nrows=plan.nrows,
                                   ncols_pad=plan.ncols_pad)
    else:
        plain = R.spmv_desc(plan.dev, xt, nrows=plan.nrows)
    before = KD.LAUNCHES[kernel]
    y = ops.spmv(plan, xt, double_buffer=kernel.endswith("_db"))
    torch.cuda.synchronize()
    assert KD.LAUNCHES[kernel] == before + 1
    assert y.device.type == "cuda" and y.shape == (mat.nrows,)
    assert torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale)
    return plan


@pytest.mark.parametrize("kernel", DESC_KERNELS)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_desc_kernel_matches_plain(cuda, kernel, rc):
    """Several chunks and panels (pr=64, xw=64, cb=16), nrows % r != 0 for
    r in (4, 8), and bit-31 masks for 4x8 / 8x4."""
    mat = _matrix(rc, n=302)
    x = np.random.default_rng(1).standard_normal(mat.ncols).astype(np.float32)
    geom = (dict(pr=64, xw=64, cb=16) if "panels" in kernel
            else dict(cb=16))
    _run_desc(kernel, mat, x, cuda, **geom)


@pytest.mark.parametrize("kernel", DESC_KERNELS)
def test_desc_fem_matrix_default_geometry(cuda, kernel):
    """The chip_smoke matrix class at a small size, default geometry."""
    mat = F.csr_to_spc5(matgen.fem_blocks(8_000, 4, 12, seed=5), 4, 4)
    x = np.random.default_rng(2).standard_normal(mat.ncols).astype(np.float32)
    _run_desc(kernel, mat, x, cuda)


@pytest.mark.parametrize("kernel", DESC_KERNELS)
@pytest.mark.parametrize("kind", ["empty", "last_row_only", "left_columns"])
def test_desc_edge_matrices(cuda, kernel, kind):
    d = np.zeros((37, 29), np.float32)
    if kind == "last_row_only":
        d[36, 28] = 2.0
    elif kind == "left_columns":
        d[::3, :9] = np.random.default_rng(6).standard_normal((13, 9))
    mat = F.csr_to_spc5(F.csr_from_dense(d), 8, 4)
    x = np.random.default_rng(7).standard_normal(29).astype(np.float32)
    geom = (dict(pr=16, xw=16, cb=4) if "panels" in kernel else dict(cb=4))
    _run_desc(kernel, mat, x, cuda, **geom)


def _dense(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def _width_case(table, width, layout):
    """A matrix (beta(4,8) for vidx, beta(2,4) otherwise) and geometry
    whose ``table`` narrows to ``width`` bits: vidx is bounded by vmax
    (cb), xcol by ncols or xw, yrow by nrows or pr."""
    if table == "vidx":
        cb = {8: 4, 16: 16, 32: 1_280}[width]
        d = (_dense((64, 4_096), 1.0, 7) if width == 32
             else _dense((120, 100), 0.3, 7))
        geom = (dict(cb=cb) if layout == "whole_vector"
                else dict(pr=64, xw=1_024 if width == 32 else 64, cb=cb))
        return F.csr_to_spc5(F.csr_from_dense(d), 4, 8), geom
    big = {8: 100, 16: 1_000, 32: 40_000}[width]
    if table == "xcol":
        d = _dense((60, big), min(1.0, 300 / big), 8)
        geom = (dict(cb=16) if layout == "whole_vector"
                else dict(pr=64, xw=big, cb=16))
    else:
        d = _dense((big, 60), min(1.0, 300 / big), 9)
        geom = (dict(cb=16) if layout == "whole_vector"
                else dict(pr=big, xw=64, cb=16))
    return F.csr_to_spc5(F.csr_from_dense(d), 2, 4), geom


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("table", ["vidx", "xcol", "yrow"])
@pytest.mark.parametrize("kernel", DESC_KERNELS)
def test_desc_table_widths(cuda, kernel, table, width):
    """Each index table at each width it can have, read as built. An int32
    vidx needs a value window above 32,768 floats (128 KB) and a panel
    int32 xcol an x window as wide, so the double-buffered kernels, which
    hold two of each, refuse them for want of shared memory."""
    layout = "panels" if "panels" in kernel else "whole_vector"
    mat, geom = _width_case(table, width, layout)
    x = np.random.default_rng(width).standard_normal(
        mat.ncols).astype(np.float32)
    too_big = width == 32 and kernel.endswith("_db") and (
        table == "vidx" or (table == "xcol" and layout == "panels"))
    if too_big:
        plan = ops.prepare(mat, layout=layout, lowering="descriptor",
                           tune=False, device=cuda, **geom)
        assert getattr(plan, f"desc_{table}").dtype == torch.int32
        with pytest.raises(ValueError, match="shared memory"):
            ops.spmv(plan, torch.from_numpy(x).to(cuda))
        return
    plan = _run_desc(kernel, mat, x, cuda, **geom)
    assert getattr(plan, f"desc_{table}").dtype == getattr(
        torch, f"int{width}")


# ----------------------------------------------------------------------------
# descriptor SpMM
# ----------------------------------------------------------------------------

DESC_SPMM_KERNELS = ("spmm_cuda_desc", "spmm_cuda_panels_desc",
                     "spmm_cuda_panels_desc_db")


def _run_desc_spmm(kernel, mat, nvec, device, nvt=128, seed=4, xrows=None,
                   **geom):
    """One ``ops.spmm`` on a descriptor plan through ``kernel``, held
    against the plain version; ``xrows`` cuts X short of the matrix's
    columns (the kernels then add nothing past X, as the reference's zero
    padding adds nothing)."""
    layout = "panels" if "panels" in kernel else "whole_vector"
    plan = ops.prepare(mat, layout=layout, lowering="descriptor", tune=False,
                       device=device, **geom)
    xh = np.random.default_rng(seed).standard_normal(
        (mat.ncols if xrows is None else xrows, nvec)).astype(np.float32)
    xt = torch.from_numpy(xh).to(device)
    if layout == "panels":
        plain = R.spmm_panels_desc(plan.dev, xt, pr=plan.pr,
                                   nrows=plan.nrows,
                                   ncols_pad=plan.ncols_pad)
    else:
        plain = R.spmm_desc(plan.dev, xt, nrows=plan.nrows)
    before = KDM.LAUNCHES[kernel]
    y = ops.spmm(plan, xt, nvt=nvt, double_buffer=kernel.endswith("_db"))
    torch.cuda.synchronize()
    assert KDM.LAUNCHES[kernel] == before + 1
    assert y.device.type == "cuda" and y.shape == (mat.nrows, nvec)
    assert torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale)
    return plan


@pytest.mark.parametrize("nvec", [3, 16, 128])
@pytest.mark.parametrize("kernel", DESC_SPMM_KERNELS)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_desc_spmm_kernel_matches_plain(cuda, kernel, rc, nvec):
    """Several chunks and panels (pr=64, xw=64, cb=16), nrows % r != 0 for
    r in (4, 8), bit-31 masks, and column tiles of 4 (nvec=3, one idle
    lane), 16 and 32 (four tiles)."""
    mat = _matrix(rc, n=302)
    geom = (dict(pr=64, xw=64, cb=16) if "panels" in kernel
            else dict(cb=16))
    _run_desc_spmm(kernel, mat, nvec, cuda, **geom)


@pytest.mark.parametrize("kernel", DESC_SPMM_KERNELS)
def test_desc_spmm_partial_column_tile(cuda, kernel):
    """nvec = 40 with nvt = 8: two column tiles of 32, the second with 24
    idle lanes."""
    _run_desc_spmm(kernel, _matrix((2, 4), n=150, m=90), 40, cuda, nvt=8,
                   **(dict(pr=32, xw=32, cb=8) if "panels" in kernel
                      else dict(cb=8)))


@pytest.mark.parametrize("kernel", DESC_SPMM_KERNELS)
@pytest.mark.parametrize("kind", ["empty", "last_row_only", "left_columns"])
def test_desc_spmm_edge_matrices(cuda, kernel, kind):
    d = np.zeros((37, 29), np.float32)
    if kind == "last_row_only":
        d[36, 28] = 2.0
    elif kind == "left_columns":
        d[::3, :9] = np.random.default_rng(6).standard_normal((13, 9))
    mat = F.csr_to_spc5(F.csr_from_dense(d), 8, 4)
    geom = (dict(pr=16, xw=16, cb=4) if "panels" in kernel else dict(cb=4))
    _run_desc_spmm(kernel, mat, 5, cuda, **geom)


@pytest.mark.parametrize("kernel", ("spmm_cuda_panels_desc",
                                    "spmm_cuda_panels_desc_db"))
def test_desc_spmm_short_x_is_read_in_place(cuda, kernel):
    """X with fewer rows than the panel layout's ncols_pad: nothing is
    read past X and nothing is added for the columns it lacks."""
    mat = _matrix((2, 4), n=130, m=100, density=0.1)
    plan = _run_desc_spmm(kernel, mat, 8, cuda, xrows=90, pr=64, xw=64,
                          cb=16)
    assert plan.ncols_pad > 90


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("table", ["vidx", "xcol", "yrow"])
@pytest.mark.parametrize("kernel", DESC_SPMM_KERNELS)
def test_desc_spmm_table_widths(cuda, kernel, table, width):
    """Each index table at each width it can have, read as built. An int32
    vidx needs a value window above 32,768 floats (128 KB): it is read
    through L1 instead of staged, and the double-buffered kernel, which
    holds two windows, refuses it for want of shared memory."""
    layout = "panels" if "panels" in kernel else "whole_vector"
    mat, geom = _width_case(table, width, layout)
    if width == 32 and table == "vidx" and kernel.endswith("_db"):
        plan = ops.prepare(mat, layout=layout, lowering="descriptor",
                           tune=False, device=cuda, **geom)
        assert plan.desc_vidx.dtype == torch.int32
        with pytest.raises(ValueError, match="shared memory"):
            ops.spmm(plan, torch.zeros(mat.ncols, 16, device=cuda))
        return
    plan = _run_desc_spmm(kernel, mat, 16, cuda, **geom)
    assert getattr(plan, f"desc_{table}").dtype == getattr(
        torch, f"int{width}")


def test_desc_spmm_oversized_shared_memory_raises(cuda):
    """cb=2048 at 4x8 on a dense matrix: a 256 KB value window."""
    mat = _matrix((4, 8), n=1024, m=1024, density=0.95)
    plan = ops.prepare(mat, layout="whole_vector", lowering="descriptor",
                       cb=2048, tune=False, device=cuda)
    before = dict(KDM.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spmm(plan, torch.zeros(mat.ncols, 4, device=cuda))
    assert KDM.LAUNCHES == before


@pytest.mark.parametrize("kernel", DESC_SPMM_KERNELS)
def test_desc_spmm_smoke_geometry(cuda, kernel):
    """The geometry chip_smoke.py uses, on a 2,000 x 4,096 slice of the
    density-0.1 vocab weight in beta(4,8) at nvec=128: the panel kernels
    stage vidx beside a (512, 32) Y tile."""
    w = np.random.default_rng(0).standard_normal((2_000, 4_096), np.float32)
    w = np.where(np.abs(w) >= np.quantile(np.abs(w), 0.9), w, 0.0)
    mat = F.csr_to_spc5(F.csr_from_dense(w.astype(np.float32)), 4, 8)
    geom = (dict(pr=512, xw=512, cb=64) if "panels" in kernel
            else dict(cb=256))
    plan = _run_desc_spmm(kernel, mat, 128, cuda, **geom)
    stages = 2 if kernel.endswith("_db") else 1
    tw, staged, _ = KDM.smem_plan(
        stages, plan.cb, plan.r, plan.c, plan.vmax,
        plan.desc_vidx.element_size(), 128,
        pr=plan.pr if "panels" in kernel else 0)
    assert (tw, staged) == (32, True)


def test_desc_spmm_cuda_plan_rejects_cpu_x(cuda):
    plan = ops.prepare(_matrix((2, 4)), layout="panels",
                       lowering="descriptor", tune=False, device=cuda)
    with pytest.raises(ValueError, match="device"):
        ops.spmm(plan, torch.zeros(plan.ncols, 4))


def test_default_sparse_linear_on_the_card_matches_the_cpu_layer(cuda):
    """``from_dense`` at its defaults on a 3000 x 1200 weight: panels +
    descriptor by the cost model. Batch 1 goes to spmv_cuda_panels_desc_db,
    wider batches to spmm_cuda_panels_desc_db; the card's layer agrees with
    the same layer built on the CPU."""
    rng = np.random.default_rng(10)
    w = rng.standard_normal((3000, 1200)).astype(np.float32)
    on_card = SparseLinear.from_dense(w, density=0.05)
    on_cpu = SparseLinear.from_dense(w, density=0.05, device="cpu")
    assert (on_card.plan.layout, on_card.plan.lowering) == ("panels",
                                                            "descriptor")
    for batch in (1, 4, 16):
        x = torch.from_numpy(rng.standard_normal((batch, 1200)).astype(
            np.float32))
        for mod in (K, KM, KD, KDM):
            mod.reset_launches()
        y = on_card(x.to(cuda))
        torch.cuda.synchronize()
        runs = {**K.LAUNCHES, **KM.LAUNCHES, **KD.LAUNCHES, **KDM.LAUNCHES}
        want = ("spmv_cuda_panels_desc_db" if batch == 1
                else "spmm_cuda_panels_desc_db")
        assert {k: v for k, v in runs.items() if v} == {want: 1}
        ref = on_cpu(x)
        err = float((y.cpu() - ref).abs().max())
        assert err <= RTOL * float(ref.abs().max()), err


# ----------------------------------------------------------------------------
# the beta(r,c)_test split: singleton tail kernel and the test plan
# ----------------------------------------------------------------------------

#: Tail bucket geometries: the reference's tail test (320 rows, pr=16,
#: xw=32, cb=8), nrows % pr != 0, and a 300 x 40,000 matrix whose buckets
#: span more than 12,288 columns (tail_xw wider than 48 KB of f32).
TAIL_CASES = {
    "powerlaw": (lambda: matgen.powerlaw(320, 5, seed=17), dict(pr=16, xw=32,
                                                               cb=8)),
    "ragged": (lambda: matgen.powerlaw(330, 5, seed=17), dict(pr=16, xw=32,
                                                             cb=8)),
    "wide": (lambda: F.csr_from_dense(((np.random.default_rng(3).random(
        (300, 40_000)) < 3e-3) * np.random.default_rng(4).standard_normal(
        (300, 40_000))).astype(np.float32)), dict(pr=64, xw=512, cb=16)),
}


def _tail_plan(case, rc, device, lowering="mask"):
    csr, geom = TAIL_CASES[case]
    return ops.prepare(F.csr_to_spc5(csr(), *rc), layout="test",
                       multi_layout="panels", lowering=lowering, tune=False,
                       device=device, **geom)


def _tail_args(plan):
    return ((plan.tail_xbase, plan.single_rows, plan.single_cols,
             plan.single_values),
            dict(pr=plan.tail_pr, xw=plan.tail_xw, nrows=plan.nrows,
                 ncols_pad=plan.tail_ncols_pad))


@pytest.mark.parametrize("case", TAIL_CASES)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_tail_kernel_matches_plain(cuda, rc, case):
    plan = _tail_plan(case, rc, cuda)
    if not plan.n_single:
        pytest.skip(f"no singleton blocks in beta{rc} for {case}")
    if case == "ragged":
        assert plan.nrows % plan.tail_pr
    if case == "wide":
        assert plan.tail_xw > 12_288
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        plan.ncols).astype(np.float32)).to(cuda)
    args, kw = _tail_args(plan)
    before = KT.LAUNCHES["spmv_tail_cuda"]
    y = KT.spmv_tail_cuda(*args, x, **kw)
    torch.cuda.synchronize()
    assert KT.LAUNCHES["spmv_tail_cuda"] == before + 1
    plain = R.spmv_coo_panels(*args[1:], x, pr=plan.tail_pr,
                              nrows=plan.nrows)
    assert y.shape == (plan.nrows,) and torch.isfinite(y).all()
    err = float((y - plain).abs().max())
    assert err <= RTOL * max(float(plain.abs().max()), 1.0), err


def test_tail_kernel_reads_x_in_place(cuda):
    """Hand-made buckets whose window runs past x's end: a column at or
    past ncols reads 0 (the reference pads x with zeros), a row outside
    [0, pr) is clipped into it, and padding slots multiply like any other
    slot, as in the reference's kernel."""
    rows = torch.tensor([[0, 2, 2, 9], [1, 1, -3, 0]], dtype=torch.int32)
    cols = torch.tensor([[5, 6, 7, 0], [2, 3, 9, 0]], dtype=torch.int32)
    vals = torch.tensor([[1., 2., 3., 4.], [5., 6., 7., 0.]])
    xbase = torch.tensor([4, 0], dtype=torch.int32)
    x = torch.arange(1, 8, dtype=torch.float32)          # ncols = 7
    y = KT.spmv_tail_cuda(xbase.to(cuda), rows.to(cuda), cols.to(cuda),
                          vals.to(cuda), x.to(cuda), pr=4, xw=4, nrows=7,
                          ncols_pad=8)
    # panel 0: x[5]=6 and x[6]=7; col 7 is past x (0); row 9 clips to 3,
    # where col 0 clips to the window start x[4]=5. Panel 1: row -3 clips
    # to 0 and col 9 to the window's last column x[3]=4; the padding slot
    # adds 0 * x[0]
    want = torch.tensor([6., 0., 2 * 7., 4 * 5., 7 * 4., 5 * 3. + 6 * 4., 0.])
    assert torch.equal(y.cpu(), want)


def test_tail_kernel_refuses_other_dtypes(cuda):
    plan = _tail_plan("powerlaw", (2, 4), cuda)
    args, kw = _tail_args(plan)
    x = torch.zeros(plan.ncols, device=cuda)
    with pytest.raises(TypeError, match="float32"):
        KT.spmv_tail_cuda(*args[:3], args[3].double(), x, **kw)
    with pytest.raises(TypeError, match="int32"):
        KT.spmv_tail_cuda(args[0], args[1].long(), *args[2:], x, **kw)


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("multi_layout", ["whole_vector", "panels"])
def test_test_plan_on_the_card_matches_the_cpu_plan(cuda, multi_layout,
                                                    lowering):
    """SpMV (multi kernel + tail: the tail kernel for panel buckets,
    spmv_coo for a flat tail) and SpMM (multi kernel + spmm_coo) of a test
    plan on the card against the same plan on the CPU."""
    mat = F.csr_to_spc5(matgen.powerlaw(2_000, 6, seed=9), 2, 4)
    kw = dict(layout="test", multi_layout=multi_layout, lowering=lowering,
              tune=False, pr=64, xw=64, cb=16)
    card = ops.prepare(mat, device=cuda, **kw)
    cpu = ops.prepare(mat, device="cpu", **kw)
    rng = np.random.default_rng(6)
    KT.reset_launches()
    for shape in ((2_000,), (2_000, 16)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        fn = ops.spmv if len(shape) == 1 else ops.spmm
        y = fn(card, x.to(cuda))
        torch.cuda.synchronize()
        ref = fn(cpu, x)
        err = float((y.cpu() - ref).abs().max())
        assert err <= RTOL * float(ref.abs().max()), err
    assert KT.LAUNCHES["spmv_tail_cuda"] == (multi_layout == "panels")
