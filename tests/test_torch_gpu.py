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
# mask panel SpMV: the split grid, the staged metadata, a block row a thread
# ----------------------------------------------------------------------------

PANEL_MASK = ("spmv_cuda_panels", "spmv_cuda_panels_db")


def _check_panel_mask(kernel, plan, x, **kw):
    """One wrapper call on the plan's arrays (``split`` in kw; the kernel
    gets ``x_kernel`` where given, else x), counted once and held against
    ``spmv_panels`` of x."""
    plain = R.spmv_panels(plan.dev, x, r=plan.r, c=plan.c, pr=plan.pr,
                          nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    before = K.LAUNCHES[kernel]
    y = getattr(K, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col, plan.chunk_mask,
        plan.chunk_voff, plan.chunk_row, plan.values, kw.pop("x_kernel", x),
        r=plan.r, c=plan.c,
        cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
        ncols_pad=plan.ncols_pad, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == before + 1
    assert y.shape == (plan.nrows,) and torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale, kw)


def _mask_split_plan(rc, device, n=302, cb=4):
    """n rows in panels of 64 (302: nrows % pr != 0, and nrows % r != 0 for
    r = 8), cb=4: many chunks a panel, so S can be 1, nchunks, or neither
    and not divide nchunks."""
    plan = ops.prepare(_matrix(rc, n=n, m=700, density=0.05),
                       layout="panels", lowering="mask", tune=False,
                       device=device, pr=64, xw=64, cb=cb)
    assert plan.nrows % plan.pr and plan.nchunks >= 5, plan.nchunks
    return plan


def _x(plan, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        plan.ncols).astype(np.float32)).to(device)


@pytest.mark.parametrize("split", ["one", "chosen", "all", "ragged"])
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("kernel", PANEL_MASK)
def test_panel_mask_split(cuda, kernel, rc, split):
    """S = 1 (plain stores), the wrapper's S, S = nchunks (one chunk a CTA)
    and an S that does not divide nchunks, for every block shape (beta(8,4)
    with nrows % r != 0: its last block row reaches past nrows)."""
    plan = _mask_split_plan(rc, cuda)
    n = plan.nchunks
    s = {"one": 1, "chosen": None, "all": n,
         "ragged": next(k for k in range(3, n) if n % k)}[split]
    _check_panel_mask(kernel, plan, _x(plan, 11, cuda), split=s)


@pytest.mark.parametrize("rc", [(1, 8), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", PANEL_MASK)
def test_panel_mask_x_in_place_or_padded(cuda, kernel, rc):
    """An x of ncols_pad entries or more is read in place, where NaN entries
    past the matrix's columns must not reach y; a shorter one (the matrix's
    ncols, half of them, none) is padded with zeros to ncols_pad, as the
    plain version and the Pallas wrappers pad it. At the wrapper's S and at
    S = 1."""
    plan = _mask_split_plan(rc, cuda)
    assert plan.ncols < plan.ncols_pad
    x = _x(plan, 12, cuda)
    tail = torch.full((plan.ncols_pad,), float("nan"), device=cuda)
    for split in (None, 1):
        _check_panel_mask(kernel, plan, x, split=split,
                          x_kernel=torch.cat([x, tail]))
        for n in (plan.ncols, plan.ncols // 2, 0):
            _check_panel_mask(kernel, plan, x[:n].clone(), split=split)


@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", PANEL_MASK)
def test_panel_mask_cb6_stages_4_byte_pieces(cuda, kernel, rc):
    """cb = 6: a chunk's metadata rows are 24 bytes, so every other one
    starts off a 16-byte boundary and the kernels copy them in 4-byte
    pieces; 6 * r block rows are not whole warps."""
    plan = _mask_split_plan(rc, cuda, cb=6)
    assert K.panel_threads(6, rc[0]) == 32
    for split in (None, 1, 3):
        _check_panel_mask(kernel, plan, _x(plan, 13, cuda), split=split)


@pytest.mark.parametrize("split", [None, 1, 3])
@pytest.mark.parametrize("kernel", PANEL_MASK)
def test_panel_mask_all_padding_panel(cuda, kernel, split):
    """Panels 1 and 3 hold no nonzero, so every chunk of theirs is padding
    (and some CTAs' whole ranges); their rows come out 0 whatever the
    split."""
    d = _dense((300, 400), 0.05, 13)
    d[64:128] = 0.0
    d[192:256] = 0.0
    mat = F.csr_to_spc5(F.csr_from_dense(d), 2, 4)
    plan = ops.prepare(mat, layout="panels", lowering="mask", tune=False,
                       device=cuda, pr=64, xw=64, cb=8)
    assert not bool(plan.chunk_mask[1].any()) and plan.nchunks >= 3
    _check_panel_mask(kernel, plan, _x(plan, 14, cuda), split=split)


@pytest.mark.parametrize("ring", [2, 3])
@pytest.mark.parametrize("rc", [(1, 4), (4, 8), (8, 4)])
def test_panel_mask_db_ring_lengths(cuda, rc, ring, monkeypatch):
    """Rings of 2 (DB_STAGES) and 3 at the wrapper's split and at S =
    nchunks (ranges shorter than the ring); and a dense chunk's 94 KB stage
    (value window and metadata), where a ring of 3 does not fit and
    shortens to 2."""
    monkeypatch.setattr(K, "DB_STAGES", ring)
    plan = _mask_split_plan(rc, cuda)
    x = _x(plan, 15, cuda)
    for split in (None, plan.nchunks):
        _check_panel_mask("spmv_cuda_panels_db", plan, x, split=split)
    cb = 96_000 // (4 * rc[0] * rc[1] + 16)
    mat = F.csr_to_spc5(F.csr_from_dense(_dense((64, 4_096), 1.0, 18)),
                        *rc)
    plan = ops.prepare(mat, layout="panels", lowering="mask", tune=False,
                       device=cuda, pr=64, xw=1_024, cb=cb)
    launch = K.panels_launch(ring, plan.npanels, plan.nchunks, cb=plan.cb,
                             r=plan.r, vmax=plan.vmax, pr=plan.pr,
                             device=cuda)
    assert launch["stages"] == 2 and plan.nchunks >= 2
    x = _x(plan, 16, cuda)
    for split in (None, plan.nchunks):
        _check_panel_mask("spmv_cuda_panels_db", plan, x, split=split)


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("rc", [(1, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", PANEL_MASK)
def test_panel_mask_rows_per_thread(cuda, kernel, rc, rows, monkeypatch):
    """One, two (ROWS_PER_THREAD), four and eight block rows a thread: other
    thread counts, so other splits, and threads that loop over blocks."""
    monkeypatch.setattr(K, "ROWS_PER_THREAD", rows)
    plan = _mask_split_plan(rc, cuda, cb=16)
    for split in (None, 1):
        _check_panel_mask(kernel, plan, _x(plan, 18, cuda), split=split)


#: chip_smoke.py's mask panel plans (cb, vmax, pr): the vocab mask layer and
#: the FEM matrix, a cb = 6 plan, and a ring-shortening geometry.
MASK_SMEM_GEOMETRIES = {
    "vocab": (64, 312, 512),
    "fem": (64, 1_024, 512),
    "cb6": (6, 48, 64),
    "shortened": (640, 20_480, 64),
}


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(MASK_SMEM_GEOMETRIES))
def test_panel_mask_smem_matches_the_kernel(cuda, case, stages):
    """The wrapper's ``panels_smem_bytes`` is the figure the kernel's own
    stage layout gives (a launch whose figure differs is refused)."""
    from repro_torch.kernels import _build
    geom = MASK_SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmv")
    assert lib.spc5_spmv_panels_smem(stages, *geom, 4) == \
        K.panels_smem_bytes(stages, *geom)


def test_panel_mask_launch_refuses_a_wrong_smem_figure(cuda):
    """A shared-memory figure other than the kernel's own layout, or a split
    outside [1, nchunks], is refused with CUDA error 1 and launches
    nothing."""
    from repro_torch.kernels import _build
    plan = _mask_split_plan((2, 4), cuda)
    launch = K.panels_launch(1, plan.npanels, plan.nchunks, cb=plan.cb,
                             r=plan.r, vmax=plan.vmax, pr=plan.pr,
                             device=cuda)
    lib = _build.load_library("spc5_spmv")
    y = torch.full((plan.nrows,), 7.0, device=cuda)
    ptrs = [t.data_ptr() for t in (
        plan.chunk_vbase, plan.chunk_xbase, plan.chunk_col, plan.chunk_mask,
        plan.chunk_voff, plan.chunk_row, plan.values)]
    ptrs += [0] + [t.data_ptr() for t in (_x(plan, 17, cuda), y)]  # no scale
    geom = (plan.npanels, plan.nchunks, plan.cb, plan.vmax, plan.pr,
            plan.nrows, plan.r, plan.c, 4, plan.values.numel())
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for split, smem in ((1, launch["smem_bytes"] + 16),
                        (plan.nchunks + 1, launch["smem_bytes"])):
        err = lib.spc5_spmv_panels_s1(*ptrs, *geom, split, smem,
                                      launch["threads"], 0, stream)
        assert err == 1, (split, smem)
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())


# ----------------------------------------------------------------------------
# whole-vector mask SpMV: contiguous chunk ranges, staged metadata, row runs
# combined in the warp, per-warp y tiles
# ----------------------------------------------------------------------------

WHOLE_MASK = ("spmv_cuda", "spmv_cuda_db")


def _wmask_check(kernel, dev, x, *, geom, x_plain=None, **kw):
    """One wrapper call on the arrays of ``dev`` (an ``SPC5Device``;
    ``grid`` in kw), counted once and held against ``spmv`` (on
    ``x_plain`` where given)."""
    plain = R.spmv(dev, x if x_plain is None else x_plain, r=geom["r"],
                   c=geom["c"], nrows=geom["nrows"], ncols=geom["ncols"])
    before = K.LAUNCHES[kernel]
    y = getattr(K, kernel)(dev.chunk_vbase, dev.chunk_col, dev.chunk_mask,
                           dev.chunk_voff, dev.chunk_row, dev.values, x,
                           **geom, **kw)
    torch.cuda.synchronize()
    assert K.LAUNCHES[kernel] == before + 1
    assert y.shape == (geom["nrows"],) and torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale, kw)


def _wmask_geom(plan):
    return dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                nrows=plan.nrows, ncols=plan.ncols)


def _wmask_chunks(plan):
    return int(plan.chunk_vbase.shape[0])


def _wmask_plan(rc, device, cb=12, **matrix):
    """302 rows (nrows % r != 0 for r = 4 and 8) in chunks of cb blocks:
    many chunks, so G can be 1, nchunks, or neither and not divide
    nchunks."""
    mat = _matrix(rc, **{"n": 302, "m": 700, "density": 0.05, **matrix})
    plan = ops.prepare(mat, layout="whole_vector", lowering="mask",
                       tune=False, device=device, cb=cb)
    assert _wmask_chunks(plan) >= 5, _wmask_chunks(plan)
    return plan


def _wmask_grids(plan):
    """The wrapper's G, one CTA for every chunk and one chunk a CTA."""
    return (None, 1, _wmask_chunks(plan))


@pytest.mark.parametrize("grid", ["one", "chosen", "all", "ragged"])
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_grid(cuda, kernel, rc, grid):
    """One CTA for every chunk, the wrapper's G, one chunk a CTA, and a G
    that does not divide nchunks, for every block shape (nrows % r != 0 and
    padding blocks in the last chunk)."""
    plan = _wmask_plan(rc, cuda)
    assert not bool(plan.chunk_mask[-1].all())    # padding blocks
    n = _wmask_chunks(plan)
    g = {"one": 1, "chosen": None, "all": n,
         "ragged": next(k for k in range(3, n) if n % k)}[grid]
    _wmask_check(kernel, plan.dev, _x(plan, 41, cuda),
                 geom=_wmask_geom(plan), grid=g)


@pytest.mark.parametrize("cb", [4, 16, 256, 512])
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_chunk_sizes(cuda, kernel, rc, cb):
    """cb of 4, 16, 256 and 512 blocks (a chunk longer than a step of the
    CTA's block rows, and shorter), at the wrapper's G, G = 1 and one chunk
    a CTA."""
    mat = _matrix(rc, n=602, m=1_500, density=0.08)
    plan = ops.prepare(mat, layout="whole_vector", lowering="mask",
                       tune=False, device=cuda, cb=cb)
    assert _wmask_chunks(plan) >= 2
    x = _x(plan, 42, cuda)
    for grid in _wmask_grids(plan):
        _wmask_check(kernel, plan.dev, x, geom=_wmask_geom(plan), grid=grid)


@pytest.mark.parametrize("span", ["one_row", "many_rows"])
@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_chunks_span_one_or_many_rows(cuda, kernel, span):
    """Chunks inside one row (beta(1,8) over 4,096 dense columns: a row's 512
    blocks make 32 chunks of 16) and chunks spanning 512 rows (beta(4,4)
    over 8 columns: two blocks a block row), whose rows overrun the warps'
    tiles and move them, at the wrapper's G, G = 1 and one chunk a CTA."""
    if span == "one_row":
        d, rc, cb = _dense((40, 4_096), 1.0, 43), (1, 8), 16
    else:
        d, rc, cb = _dense((2_000, 8), 0.6, 44), (4, 4), 256
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), *rc),
                       layout="whole_vector", lowering="mask", tune=False,
                       device=cuda, cb=cb)
    rows = plan.chunk_row.cpu().numpy()
    real = plan.chunk_mask.cpu().numpy() != 0
    spans = [int(np.ptp(rw[m])) + rc[0] for rw, m in zip(rows, real)
             if m.any()]
    if span == "one_row":
        assert max(spans) == 1 and _wmask_chunks(plan) >= 32 * 40
    else:
        assert min(spans[:-1]) > 100 > K.WHOLE_TILE_ROWS // 2
    x = _x(plan, 45, cuda)
    for grid in _wmask_grids(plan):
        _wmask_check(kernel, plan.dev, x, geom=_wmask_geom(plan), grid=grid)


def _wmask_reordered(plan, order, seed):
    """The plan's arrays with block rows moved: "permuted" takes block row
    p(i) for block row i (rows jump up and down, neighbouring chunks share
    none); "repeated" folds them onto five block rows, so equal rows come
    back after others; "shifted" moves every block row one row down, off
    the multiples of r (the matrix's last block row is empty, so every row
    stays inside it). Padding blocks keep row 0."""
    r = plan.r
    row = plan.chunk_row.long()
    real = plan.chunk_mask != 0
    nblock_rows = -(-plan.nrows // r)
    if order == "permuted":
        perm = torch.from_numpy(np.random.default_rng(seed).permutation(
            nblock_rows)).to(row.device)
        moved = perm[row // r] * r
    elif order == "repeated":
        moved = (row // r) % 5 * r
    else:
        moved = row + 1
    new = torch.where(real, moved, torch.zeros_like(moved)).int()
    return plan.dev._replace(chunk_row=new.contiguous())


@pytest.mark.parametrize("order", ["permuted", "repeated", "shifted"])
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_rows_in_any_order(cuda, kernel, rc, order):
    """Block rows out of order, repeated after others, or off the multiples
    of r: warps whose rows are not sorted add straight into y, and the
    result is the plain version's on the same arrays, at the wrapper's G,
    G = 1 and one chunk a CTA."""
    d = _dense((304, 700), 0.05, 46 + rc[0])
    d[-8:] = 0.0
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), *rc),
                       layout="whole_vector", lowering="mask", tune=False,
                       device=cuda, cb=8)
    dev = _wmask_reordered(plan, order, seed=47)
    if order == "permuted":
        first = dev.chunk_row[:, 0][plan.chunk_mask[:, 0] != 0].cpu()
        assert bool((first.diff() < 0).any())
    x = _x(plan, 48, cuda)
    for grid in _wmask_grids(plan):
        _wmask_check(kernel, dev, x, geom=_wmask_geom(plan), grid=grid)


@pytest.mark.parametrize("tile", [1, 8, 512])
@pytest.mark.parametrize("rc", [(2, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_small_and_large_tiles(cuda, kernel, rc, tile,
                                          monkeypatch):
    """Warp tiles of 1 and 8 rows, which a chunk's rows overrun (added into
    y directly, the tiles moving at every chunk), and of 512 rows."""
    monkeypatch.setattr(K, "WHOLE_TILE_ROWS", tile)
    plan = _wmask_plan(rc, cuda, cb=16)
    x = _x(plan, 49, cuda)
    for grid in _wmask_grids(plan):
        _wmask_check(kernel, plan.dev, x, geom=_wmask_geom(plan), grid=grid)


@pytest.mark.parametrize("rows", [1, 2, 16])
@pytest.mark.parametrize("rc", [(1, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_rows_per_thread(cuda, kernel, rc, rows, monkeypatch):
    """One, two and sixteen block rows a thread (the wrapper takes 4 or 8):
    other thread counts, threads that take several steps a chunk, and lanes
    past cb."""
    monkeypatch.setattr(K, "WHOLE_ROWS_PER_THREAD", rows)
    monkeypatch.setattr(K, "WHOLE_SPARSE_ROWS_PER_THREAD", rows)
    plan = _wmask_plan(rc, cuda, cb=64, n=602, m=1_500, density=0.08)
    x = _x(plan, 50, cuda)
    for grid in (None, 1):
        _wmask_check(kernel, plan.dev, x, geom=_wmask_geom(plan), grid=grid)


@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_cb6_and_offset_metadata(cuda, kernel, rc):
    """cb = 6 (metadata rows of 24 bytes, copied in 4-byte pieces) and, at
    cb = 8, metadata handed over as views 4 bytes past a 16-byte boundary
    (copied in 4-byte pieces too)."""
    plan = _wmask_plan(rc, cuda, cb=6)
    for grid in _wmask_grids(plan):
        _wmask_check(kernel, plan.dev, _x(plan, 51, cuda),
                     geom=_wmask_geom(plan), grid=grid)
    plan = _wmask_plan(rc, cuda, cb=8)
    views = []
    for t in (plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
              plan.chunk_row):
        buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
        v = buf[1:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 and v.data_ptr() % 4 == 0
        views.append(v)
    dev = plan.dev._replace(chunk_col=views[0], chunk_mask=views[1],
                            chunk_voff=views[2], chunk_row=views[3])
    for grid in (None, 1):
        _wmask_check(kernel, dev, _x(plan, 52, cuda),
                     geom=_wmask_geom(plan), grid=grid)


@pytest.mark.parametrize("kernel", WHOLE_MASK)
def test_whole_mask_empty_x_region(cuda, kernel):
    """Columns 350.. hold no nonzero: the kernels read no x there (unset
    lanes gather nothing), so NaN in that region leaves y finite and equal
    to the plain version's on an x zeroed there."""
    d = _dense((302, 700), 0.05, 53)
    d[:, 350:] = 0.0
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), 4, 8),
                       layout="whole_vector", lowering="mask", tune=False,
                       device=cuda, cb=8)
    x = _x(plan, 54, cuda)
    x[350:] = 0.0
    x_nan = x.clone()
    x_nan[350:] = float("nan")
    for grid in (None, 1):
        _wmask_check(kernel, plan.dev, x_nan, geom=_wmask_geom(plan),
                     x_plain=x, grid=grid)


def test_whole_mask_db_ring_that_does_not_fit(cuda):
    """Dense beta(4,8) chunks of 1,024 blocks (a 128 KB value window): the
    synchronous kernel runs (at its G, one CTA and one chunk a CTA); the
    ring of two does not fit a CTA, so ``spmv_cuda_db`` refuses and
    launches nothing."""
    mat = F.csr_to_spc5(F.csr_from_dense(_dense((256, 4_096), 1.0, 55)),
                        4, 8)
    plan = ops.prepare(mat, layout="whole_vector", lowering="mask",
                       tune=False, device=cuda, cb=1_024)
    assert _wmask_chunks(plan) >= 2 and plan.vmax == 1_024 * 32
    x = _x(plan, 56, cuda)
    for grid in _wmask_grids(plan):
        _wmask_check("spmv_cuda", plan.dev, x, geom=_wmask_geom(plan),
                     grid=grid)
    before = dict(K.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spmv(plan, x)
    assert K.LAUNCHES == before


#: chip_smoke.py's whole-vector mask plans (cb, vmax, tile, threads): the
#: vocab whole-vector mask layer and the FEM matrix; and a cb = 6 plan.
WHOLE_MASK_SMEM_GEOMETRIES = {
    "vocab": (256, 1_144, 32, 128),
    "fem": (256, 4_096, 32, 256),
    "cb6": (6, 48, 8, 32),
}


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(WHOLE_MASK_SMEM_GEOMETRIES))
def test_whole_mask_smem_matches_the_kernel(cuda, case, stages):
    """The wrapper's ``whole_smem_bytes`` is the figure the kernel's own
    layout gives (a launch whose figure differs is refused)."""
    from repro_torch.kernels import _build
    geom = WHOLE_MASK_SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmv")
    assert lib.spc5_spmv_whole_smem(stages, *geom, 4) == \
        K.whole_smem_bytes(stages, *geom)


def test_whole_mask_launch_refuses_what_was_not_planned(cuda):
    """A shared-memory figure other than the kernel's own layout, another
    thread count or tile (whose figure differs), a grid outside [1,
    nchunks], threads the kernel cannot take, or two stages where every CTA
    takes one chunk is refused with CUDA error 1 and launches nothing."""
    from repro_torch.kernels import _build
    plan = _wmask_plan((2, 4), cuda)
    lib = _build.load_library("spc5_spmv")
    y = torch.full((plan.nrows,), 7.0, device=cuda)
    ptrs = [t.data_ptr() for t in (
        plan.chunk_vbase, plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
        plan.chunk_row, plan.values)]
    ptrs += [0] + [t.data_ptr() for t in (_x(plan, 57, cuda), y)]  # no scale
    n = _wmask_chunks(plan)
    geom = (n, plan.cb, plan.vmax, plan.nrows, plan.r, plan.c, 4,
            plan.values.numel())
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for stages in (1, 2):
        launch = K.whole_launch(stages, n, cb=plan.cb, r=plan.r,
                                vmax=plan.vmax, device=cuda)
        g, tile, smem, threads = (launch["grid"], launch["tile_rows"],
                                  launch["smem_bytes"], launch["threads"])
        cases = [(g, tile, smem + 16, threads), (g, tile, smem - 16, threads),
                 (g, tile, smem, threads + 32), (g, tile + 1, smem, threads),
                 (0, tile, smem, threads), (n + 1, tile, smem, threads)]
        for t in (16, 288):
            cases.append((g, tile, K.whole_smem_bytes(
                stages, plan.cb, plan.vmax, tile, t), t))
        # one chunk a CTA: the launch holds one stage, so the ring's figure
        # is refused there
        cases.append((n, tile, K.whole_smem_bytes(
            2, plan.cb, plan.vmax, tile, threads), threads))
        entry = getattr(lib, f"spc5_spmv_whole_s{stages}")
        for case in cases:
            err = entry(*ptrs, *geom, *case, 0, stream)
            assert err == 1, (stages, case)
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())


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
    r in (4, 8), bit-31 masks; column tiles of 4 (nvec=3: one column a
    lane, one lane idle), 16 and 128 (four columns a lane), in both
    layouts."""
    mat = _matrix(rc, n=302)
    geom = (dict(pr=64, xw=64, cb=16) if "panels" in kernel
            else dict(cb=16))
    _run_spmm(kernel, mat, nvec, cuda, **geom)


@pytest.mark.parametrize("kernel", SPMM_KERNELS)
def test_spmm_partial_column_tile(cuda, kernel):
    """nvec = 40 with nvt = 8: one tile of 64 columns, 16 lanes of four, six
    of them idle, in both layouts."""
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
    panels (a 128-column tile of 32 lanes of four, four row parts of 128
    rows, 512 threads), cb=256 for whole-vector (a 128-column tile of 32
    lanes of four, 512 threads, a ring of two rounds), at 4x8 and
    nvec=128, on a 2,000 x 4,096 slice of the density-0.1 vocab weight."""
    w = np.random.default_rng(0).standard_normal((2_000, 4_096), np.float32)
    w = np.where(np.abs(w) >= np.quantile(np.abs(w), 0.9), w, 0.0)
    mat = F.csr_to_spc5(F.csr_from_dense(w.astype(np.float32)), 4, 8)
    geom = (dict(pr=512, xw=512, cb=64) if "panels" in kernel
            else dict(cb=256))
    plan = _run_spmm(kernel, mat, 128, cuda, **geom)
    if "panels" in kernel:
        stages = KM.PANEL_DB_STAGES if kernel.endswith("_db") else 1
        launch = KM.panels_launch(stages, plan.npanels, plan.nchunks,
                                  cb=plan.cb, r=4, c=8, vmax=plan.vmax,
                                  pr=plan.pr, nvec=128, vec=4, device=cuda)
        assert (launch["tile_columns"], launch["lanes"], launch["row_parts"],
                launch["threads"]) == (128, 32, 4, 512)
    else:
        launch = KM.whole_launch(int(plan.chunk_vbase.shape[0]), cb=plan.cb,
                                 r=4, c=8, vmax=plan.vmax, nvec=128, vec=4,
                                 device=cuda)
        assert (launch["tile_columns"], launch["lanes"], launch["threads"],
                launch["stages"]) == (128, 32, 512, 2)


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
    if layout == "panels":
        # the split grid at every width too: one chunk per CTA
        _check_panel_desc(kernel, plan, torch.from_numpy(x).to(cuda),
                          split=plan.nchunks)
        if table == "vidx" and width == 32:
            # a whole chunk's int32 tables beside a 160 KB value window do
            # not fit one CTA: the synchronous kernel stages slices of them
            _, nb, _ = KD.panels_stages(1, plan.cb, plan.r, plan.c,
                                        plan.vmax, plan.xw, plan.pr, 4,
                                        plan.desc_xcol.element_size())
            assert nb < plan.cb


# ----------------------------------------------------------------------------
# whole-vector descriptor SpMV: contiguous chunk ranges, staged tables, a y
# tile
# ----------------------------------------------------------------------------

WHOLE_DESC = ("spmv_cuda_desc", "spmv_cuda_desc_db")


def _check_whole_desc(kernel, dev, x, *, geom, x_plain=None, **kw):
    """One wrapper call on the arrays of ``dev`` (an ``SPC5DescDevice``;
    ``grid`` in kw), counted once and held against
    ``spmv_desc`` (on ``x_plain`` where given)."""
    plain = R.spmv_desc(dev, x if x_plain is None else x_plain,
                        nrows=geom["nrows"])
    before = KD.LAUNCHES[kernel]
    y = getattr(KD, kernel)(dev.chunk_vbase, dev.desc_valid, dev.desc_vidx,
                            dev.desc_xcol, dev.desc_yrow, dev.values, x,
                            **geom, **kw)
    torch.cuda.synchronize()
    assert KD.LAUNCHES[kernel] == before + 1
    assert y.shape == (geom["nrows"],) and torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale, kw)


def _chunks(plan):
    return int(plan.chunk_vbase.shape[0])


def _whole_geom(plan):
    return dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                nrows=plan.nrows, ncols=plan.ncols)


def _whole_plan(rc, device, cb=4, **matrix):
    """302 rows (nrows % r != 0) in chunks of cb = 4 blocks: many chunks,
    so G can be 1, nchunks, or neither and not divide nchunks."""
    mat = _matrix(rc, **{"n": 302, "m": 700, "density": 0.05, **matrix})
    plan = ops.prepare(mat, layout="whole_vector", lowering="descriptor",
                       tune=False, device=device, cb=cb)
    assert _chunks(plan) >= 5, _chunks(plan)
    return plan


def _plan_x(plan, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        plan.ncols).astype(np.float32)).to(device)


@pytest.mark.parametrize("grid", ["one", "chosen", "all", "ragged"])
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("kernel", WHOLE_DESC)
def test_whole_desc_grid(cuda, kernel, rc, grid):
    """One CTA for every chunk, the wrapper's G, one chunk a CTA, and a G
    that does not divide nchunks, for every block shape."""
    plan = _whole_plan(rc, cuda)
    n = _chunks(plan)
    g = {"one": 1, "chosen": None, "all": n,
         "ragged": next(k for k in range(3, n) if n % k)}[grid]
    _check_whole_desc(kernel, plan.dev, _plan_x(plan, 21, cuda),
                      geom=_whole_geom(plan), grid=g)


def _dense_ring_cb(rc):
    """The largest cb (a multiple of 32) whose dense chunks (vmax = cb * r *
    c, int16 tables) still fit a ring of two stages."""
    r, c = rc
    fits = [cb for cb in range(64, 4_096, 32)
            if KD.whole_smem_bytes(2, cb, r, c, cb * r * c, KD.WHOLE_TILE_ROWS,
                                   2, 2) <= K.MAX_SMEM_BYTES]
    return fits[-1]


@pytest.mark.parametrize("chunks", ["sparse", "dense"])
@pytest.mark.parametrize("rc", [(1, 4), (2, 4), (4, 8), (8, 4)])
def test_whole_desc_db_rings(cuda, rc, chunks):
    """The ring of two whole chunks on sparse chunks and on dense ones that
    leave the CTA's shared memory all but full, each at the wrapper's G and
    at one chunk a CTA (ranges shorter than the ring)."""
    if chunks == "dense":
        cb = _dense_ring_cb(rc)
        mat = F.csr_to_spc5(F.csr_from_dense(_dense((64, 4_096), 1.0, 22)),
                            *rc)
        plan = ops.prepare(mat, layout="whole_vector", lowering="descriptor",
                           tune=False, device=cuda, cb=cb)
        assert _chunks(plan) >= 2 and plan.vmax == cb * rc[0] * rc[1]
    else:
        plan = _whole_plan(rc, cuda)
    launch = KD.whole_launch(
        KD.WHOLE_DB_STAGES, _chunks(plan), cb=plan.cb, r=plan.r, c=plan.c,
        vmax=plan.vmax, wv=plan.desc_vidx.element_size(),
        wx=plan.desc_xcol.element_size(), device=cuda)
    assert launch["stages"] == 2 and launch["blocks_per_stage"] == plan.cb
    for grid in (None, _chunks(plan)):
        _check_whole_desc("spmv_cuda_desc_db", plan.dev,
                          _plan_x(plan, 23, cuda), geom=_whole_geom(plan),
                          grid=grid)


def test_whole_desc_sliced_stages_and_refusal(cuda):
    """A 160 KB value window (1,280 full beta(4,8) blocks a chunk, int32
    vidx): the synchronous kernel stages the tables in slices of fewer
    blocks (at its G, one CTA and one chunk a CTA); the double-buffered
    kernel, which needs two windows, refuses and launches nothing."""
    mat = F.csr_to_spc5(F.csr_from_dense(_dense((64, 4_096), 1.0, 24)), 4, 8)
    plan = ops.prepare(mat, layout="whole_vector", lowering="descriptor",
                       tune=False, device=cuda, cb=1_280)
    assert plan.desc_vidx.dtype == torch.int32 and _chunks(plan) >= 2
    launch = KD.whole_launch(1, _chunks(plan), cb=plan.cb, r=4, c=8,
                             vmax=plan.vmax, wv=4, wx=2, device=cuda)
    assert launch["blocks_per_stage"] < plan.cb
    x = _plan_x(plan, 25, cuda)
    for grid in (None, 1, _chunks(plan)):
        _check_whole_desc("spmv_cuda_desc", plan.dev, x,
                          geom=_whole_geom(plan), grid=grid)
    before = dict(KD.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spmv(plan, x)
    assert KD.LAUNCHES == before


@pytest.mark.parametrize("rc", [(1, 4), (1, 8), (2, 4)])
@pytest.mark.parametrize("kernel", WHOLE_DESC)
def test_whole_desc_odd_cb_copies_4_byte_pieces(cuda, kernel, rc):
    """cb * r * c not a multiple of 16 (cb = 6 or 5): the valid and vidx
    runs go by 4-byte cp.async instead of bulk copies."""
    cb = 6 if rc[0] * rc[1] == 4 else 5
    plan = _whole_plan(rc, cuda, cb=cb)
    assert (cb * rc[0] * rc[1]) % 16
    for grid in (None, 1, _chunks(plan)):
        _check_whole_desc(kernel, plan.dev, _plan_x(plan, 26, cuda),
                          geom=_whole_geom(plan), grid=grid)


@pytest.mark.parametrize("rc", [(2, 4), (4, 8)])
@pytest.mark.parametrize("kernel", WHOLE_DESC)
def test_whole_desc_tables_at_a_4_byte_offset(cuda, kernel, rc):
    """Tables handed over as views 4 bytes past a 16-byte boundary (as
    ``plan_from_arrays`` may get them) run, copied in 4-byte pieces."""
    plan = _whole_plan(rc, cuda)
    views = []
    for t in (plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
              plan.desc_yrow):
        pad = 4 // t.element_size()
        buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=cuda)
        v = buf[pad:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 and v.data_ptr() % 4 == 0
        views.append(v)
    dev = plan.dev._replace(desc_valid=views[0], desc_vidx=views[1],
                            desc_xcol=views[2], desc_yrow=views[3])
    for grid in (None, 1):
        _check_whole_desc(kernel, dev, _plan_x(plan, 27, cuda),
                          geom=_whole_geom(plan), grid=grid)


def _permuted_dev(rc, device, seed):
    """Whole-vector descriptor arrays of a 304 x 700 matrix whose block
    rows are permuted (chunk_row takes block row p(i) for block row i): a
    chunk's rows jump about, up and down, and neighbouring chunks share
    none."""
    r = rc[0]
    mat = _matrix(rc, n=304, m=700, density=0.05, seed=seed)
    ch = F.to_chunked(mat, cb=8)
    perm = np.random.default_rng(seed).permutation(304 // r)
    real = ch.chunk_mask != 0
    row = np.where(real, perm[ch.chunk_row // r] * r, 0).astype(np.int32)
    d = F.chunk_descriptors(ch.chunk_mask, ch.chunk_voff, ch.chunk_col, row,
                            r=r, c=rc[1], vmax=ch.vmax, xmax=700, ymax=304)
    first = d.yrow[..., 0][real].astype(np.int64)
    assert (np.diff(first) < 0).any() and (np.diff(first) > 0).any()
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
         for a in (ch.values, d.valid, d.vidx, d.xcol, d.yrow,
                   ch.chunk_vbase)]
    geom = dict(r=r, c=rc[1], cb=8, vmax=ch.vmax, nrows=304, ncols=700)
    return R.SPC5DescDevice(*t), geom, ch.nchunks


@pytest.mark.parametrize("tile", [1, 8, 512])
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (8, 4)])
@pytest.mark.parametrize("kernel", WHOLE_DESC)
def test_whole_desc_permuted_rows_and_small_tiles(cuda, kernel, rc, tile,
                                                  monkeypatch):
    """Permuted, non-monotone block rows, and tiles of 1 and 8 rows that a
    chunk's rows overrun (added into y directly), at the wrapper's G, one
    CTA for every chunk (the tile moves many times) and one chunk a CTA."""
    monkeypatch.setattr(KD, "WHOLE_TILE_ROWS", tile)
    dev, geom, nchunks = _permuted_dev(rc, cuda, seed=30 + rc[0])
    x = torch.from_numpy(np.random.default_rng(28).standard_normal(
        700).astype(np.float32)).to(cuda)
    for grid in (None, 1, nchunks):
        _check_whole_desc(kernel, dev, x, geom=geom, grid=grid)


@pytest.mark.parametrize("shape", [(300, 40_000), (40_000, 300)])
@pytest.mark.parametrize("kernel", WHOLE_DESC)
def test_whole_desc_wide_and_tall_tables(cuda, kernel, shape, monkeypatch):
    """int32 xcol (40,000 columns) and int32 yrow (40,000 rows), at the
    wrapper's G and tile, one CTA, and a tile of 8 rows."""
    d = _dense(shape, 3e-3, 29)
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), 2, 4),
                       layout="whole_vector", lowering="descriptor",
                       tune=False, device=cuda, cb=16)
    table = "desc_xcol" if shape[1] > shape[0] else "desc_yrow"
    assert getattr(plan, table).dtype == torch.int32
    x = _plan_x(plan, 31, cuda)
    for grid, tile in ((None, KD.WHOLE_TILE_ROWS), (1, KD.WHOLE_TILE_ROWS),
                       (None, 8)):
        monkeypatch.setattr(KD, "WHOLE_TILE_ROWS", tile)
        _check_whole_desc(kernel, plan.dev, x, geom=_whole_geom(plan),
                          grid=grid)


@pytest.mark.parametrize("kernel", WHOLE_DESC)
def test_whole_desc_empty_x_region(cuda, kernel):
    """Columns 350.. hold no nonzero: the kernels read no x there (unset
    lanes gather nothing), so NaN in that region leaves y finite and equal
    to the plain version's on an x zeroed there."""
    d = _dense((302, 700), 0.05, 32)
    d[:, 350:] = 0.0
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), 4, 8),
                       layout="whole_vector", lowering="descriptor",
                       tune=False, device=cuda, cb=8)
    x = _plan_x(plan, 33, cuda)
    x[350:] = 0.0
    x_nan = x.clone()
    x_nan[350:] = float("nan")
    for grid in (None, 1):
        _check_whole_desc(kernel, plan.dev, x_nan, geom=_whole_geom(plan),
                          x_plain=x, grid=grid)


#: chip_smoke.py's whole-vector descriptor plans (cb, r, c, vmax, tile, vidx
#: and xcol bytes): the vocab token plan and the FEM matrix; and the sliced
#: geometry above.
WHOLE_SMEM_GEOMETRIES = {
    "token": (256, 4, 8, 1_144, 512, 2, 2),
    "fem": (256, 4, 4, 4_096, 512, 2, 4),
    "sliced": (160, 4, 8, 40_960, 8, 4, 2),
}


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(WHOLE_SMEM_GEOMETRIES))
def test_whole_desc_smem_matches_the_kernel(cuda, case, stages):
    """The wrapper's ``whole_smem_bytes`` is the figure the kernel's own
    stage layout gives (a launch whose figure differs is refused)."""
    from repro_torch.kernels import _build
    geom = WHOLE_SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmv_desc")
    assert lib.spc5_spmv_desc_whole_smem(stages, *geom, 4) == \
        KD.whole_smem_bytes(stages, *geom)


def test_whole_desc_launch_refuses_a_wrong_smem_figure(cuda):
    """A shared-memory figure other than the kernel's own layout, a grid
    outside [1, nchunks], or (synchronous entry point) more blocks a stage
    than a chunk holds is refused with CUDA error 1 and launches nothing."""
    from repro_torch.kernels import _build
    plan = _whole_plan((2, 4), cuda)
    wv, wx, wy = (plan.desc_vidx.element_size(),
                  plan.desc_xcol.element_size(),
                  plan.desc_yrow.element_size())
    lib = _build.load_library("spc5_spmv_desc")
    y = torch.full((plan.nrows,), 7.0, device=cuda)
    x = _plan_x(plan, 34, cuda)
    ptrs = [t.data_ptr() for t in (
        plan.chunk_vbase, plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
        plan.desc_yrow, plan.values)] + [0, x.data_ptr(), y.data_ptr()]
    geom = (_chunks(plan), plan.cb, plan.r, plan.c, plan.vmax, 4,
            plan.values.numel(), wv, wx, wy)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for stages in (1, 2):
        launch = KD.whole_launch(stages, _chunks(plan), cb=plan.cb, r=plan.r,
                                 c=plan.c, vmax=plan.vmax, wv=wv, wx=wx,
                                 device=cuda)
        entry = getattr(lib, f"spc5_spmv_desc_whole_s{stages}")
        nb = launch["blocks_per_stage"]
        cases = [(1, nb, launch["smem_bytes"] + 16),
                 (_chunks(plan) + 1, nb, launch["smem_bytes"]),
                 (0, nb, launch["smem_bytes"])]
        if stages == 1:
            cases.append((1, plan.cb + 1, launch["smem_bytes"]))
        for grid, nb, smem in cases:
            per_stage = (nb,) if stages == 1 else ()
            err = entry(*ptrs, *geom, grid, *per_stage, launch["tile_rows"],
                        smem, launch["threads"], 0, stream)
            assert err == 1, (stages, grid, nb, smem)
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())


# ----------------------------------------------------------------------------
# panel descriptor SpMV: the split grid and the staged tables
# ----------------------------------------------------------------------------

PANEL_DESC = ("spmv_cuda_panels_desc", "spmv_cuda_panels_desc_db")


def _check_panel_desc(kernel, plan, x, **kw):
    """One wrapper call on the plan's arrays (``split`` in kw; ``tables``
    replaces the four descriptor tables), counted once and held against
    ``spmv_panels_desc``."""
    plain = R.spmv_panels_desc(plan.dev, x, pr=plan.pr, nrows=plan.nrows,
                               ncols_pad=plan.ncols_pad)
    before = KD.LAUNCHES[kernel]
    tables = kw.pop("tables", (plan.desc_valid, plan.desc_vidx,
                               plan.desc_xcol, plan.desc_yrow))
    y = getattr(KD, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, *tables, plan.values, x,
        r=plan.r, c=plan.c,
        cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
        ncols_pad=plan.ncols_pad, **kw)
    torch.cuda.synchronize()
    assert KD.LAUNCHES[kernel] == before + 1
    assert y.shape == (plan.nrows,) and torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale, kw)


def _split_plan(rc, device):
    """302 rows in panels of 64 (nrows % pr != 0), cb=4: many chunks a
    panel, so S can be 1, nchunks, or neither and not divide nchunks."""
    mat = _matrix(rc, n=302, m=700, density=0.05)
    plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                       tune=False, device=device, pr=64, xw=64, cb=4)
    assert plan.nrows % plan.pr and plan.nchunks >= 5, plan.nchunks
    return plan


@pytest.mark.parametrize("split", ["one", "all", "ragged"])
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("kernel", PANEL_DESC)
def test_panel_desc_split(cuda, kernel, rc, split):
    """S = 1 (plain stores), S = nchunks (one chunk a CTA) and an S that
    does not divide nchunks, for every block shape."""
    plan = _split_plan(rc, cuda)
    n = plan.nchunks
    s = {"one": 1, "all": n,
         "ragged": next(k for k in range(3, n) if n % k)}[split]
    x = torch.from_numpy(np.random.default_rng(11).standard_normal(
        plan.ncols).astype(np.float32)).to(cuda)
    _check_panel_desc(kernel, plan, x, split=s)


@pytest.mark.parametrize("ring", ["full", "shortened"])
@pytest.mark.parametrize("rc", [(1, 4), (2, 4), (4, 8), (8, 4)])
def test_panel_desc_db_ring_lengths(cuda, rc, ring):
    """Both ring lengths of the staged-ahead kernel, at the wrapper's own
    split and at S = nchunks (ranges shorter than the ring): DB_STAGES on
    the split plan, and 2 where a chunk of 10,240 lanes of a dense matrix
    (an 80 KB value window) leaves no room for DB_STAGES."""
    if ring == "full":
        plan = _split_plan(rc, cuda)
    else:
        cb = 10_240 // (rc[0] * rc[1])
        mat = F.csr_to_spc5(F.csr_from_dense(_dense((64, 4_096), 1.0, 18)),
                            *rc)
        plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                           tune=False, device=cuda, pr=64, xw=1_024, cb=cb)
        assert plan.nchunks >= 2
    launch = KD.panels_launch(
        KD.DB_STAGES, plan.npanels, plan.nchunks, cb=plan.cb, r=plan.r,
        c=plan.c, vmax=plan.vmax, xw=plan.xw, pr=plan.pr,
        wv=plan.desc_vidx.element_size(), wx=plan.desc_xcol.element_size(),
        device=cuda)
    assert launch["stages"] == (KD.DB_STAGES if ring == "full" else 2)
    x = torch.from_numpy(np.random.default_rng(12).standard_normal(
        plan.ncols).astype(np.float32)).to(cuda)
    for split in (None, plan.nchunks):
        _check_panel_desc("spmv_cuda_panels_desc_db", plan, x, split=split)


@pytest.mark.parametrize("rc", [(2, 4), (4, 8)])
@pytest.mark.parametrize("kernel", PANEL_DESC)
def test_panel_desc_tables_at_a_4_byte_offset(cuda, kernel, rc):
    """Tables handed over as views 4 bytes past a 16-byte boundary (as
    ``plan_from_arrays`` may get them) run, copied in 4-byte pieces."""
    plan = _split_plan(rc, cuda)
    views = []
    for t in (plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
              plan.desc_yrow):
        pad = 4 // t.element_size()
        buf = torch.empty(t.numel() + pad, dtype=t.dtype, device=cuda)
        v = buf[pad:].view(t.shape)
        v.copy_(t)
        assert v.data_ptr() % 16 and v.data_ptr() % 4 == 0
        views.append(v)
    x = torch.from_numpy(np.random.default_rng(19).standard_normal(
        plan.ncols).astype(np.float32)).to(cuda)
    for split in (None, 1):
        _check_panel_desc(kernel, plan, x, split=split, tables=tuple(views))


#: chip_smoke.py's panel descriptor plans: the default vocab layer, the test
#: layer's multi sub-plan and the FEM matrix (cb, r, c, vmax, xw, pr, vidx
#: and xcol bytes), and the ring-shortening geometry above.
SMEM_GEOMETRIES = {
    "vocab": (64, 4, 8, 312, 512, 512, 2, 2),
    "test_multi": (64, 2, 4, 176, 512, 512, 2, 2),
    "fem": (64, 4, 4, 1_024, 512, 512, 2, 2),
    "shortened": (320, 4, 8, 10_240, 1_024, 64, 2, 2),
}


@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(SMEM_GEOMETRIES))
def test_panel_desc_smem_matches_the_kernel(cuda, case, stages):
    """The wrapper's ``panels_smem_bytes`` is the figure the kernel's own
    stage layout gives (a launch whose figure differs is refused)."""
    from repro_torch.kernels import _build
    geom = SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmv_desc")
    assert lib.spc5_spmv_desc_panels_smem(stages, *geom, 4) == \
        KD.panels_smem_bytes(stages, *geom)


@pytest.mark.parametrize("split", [None, 1, 3])
@pytest.mark.parametrize("kernel", PANEL_DESC)
def test_panel_desc_all_padding_panel(cuda, kernel, split):
    """Panels 1 and 3 hold no nonzero, so every chunk of theirs is padding;
    their rows come out 0 whatever the split."""
    d = _dense((300, 400), 0.05, 13)
    d[64:128] = 0.0
    d[192:256] = 0.0
    mat = F.csr_to_spc5(F.csr_from_dense(d), 2, 4)
    plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                       tune=False, device=cuda, pr=64, xw=64, cb=8)
    assert not bool(plan.desc_valid[1].any()) and plan.nchunks >= 3
    x = torch.from_numpy(np.random.default_rng(14).standard_normal(
        plan.ncols).astype(np.float32)).to(cuda)
    _check_panel_desc(kernel, plan, x, split=split)


def test_panel_desc_shared_memory_refusal(cuda):
    """The formula of ``panels_smem_bytes`` decides: a ring of two 100 KB
    value windows does not fit (the double-buffered kernel refuses and
    launches nothing), one window with its tables in slices does, and a y
    tile of 60,000 rows (240 KB) fits neither."""
    d = _dense((64, 4_096), 1.0, 15)
    mat = F.csr_to_spc5(F.csr_from_dense(d), 4, 8)
    plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                       tune=False, device=cuda, pr=64, xw=1_024, cb=800)
    widths = (plan.desc_vidx.element_size(), plan.desc_xcol.element_size())
    geom = (plan.cb, plan.r, plan.c, plan.vmax, plan.xw, plan.pr, *widths)
    assert KD.panels_smem_bytes(2, *geom) > K.MAX_SMEM_BYTES
    x = torch.from_numpy(np.random.default_rng(16).standard_normal(
        plan.ncols).astype(np.float32)).to(cuda)
    before = dict(KD.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spmv(plan, x)
    assert KD.LAUNCHES == before
    _check_panel_desc("spmv_cuda_panels_desc", plan, x)
    tall = F.csr_to_spc5(F.csr_from_dense(_dense((60_000, 64), 1e-3, 17)),
                         2, 4)
    plan = ops.prepare(tall, layout="panels", lowering="descriptor",
                       tune=False, device=cuda, pr=60_000, xw=64, cb=16)
    x = torch.zeros(plan.ncols, device=cuda)
    for db in (True, False):
        with pytest.raises(ValueError, match="shared memory"):
            ops.spmv(plan, x, double_buffer=db)
    assert KD.LAUNCHES == dict(before, spmv_cuda_panels_desc=before[
        "spmv_cuda_panels_desc"] + 1)


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
    r in (4, 8), bit-31 masks, and column tiles of 4 (nvec=3: one column a
    lane, one lane idle), 16 and 128 (four columns a lane)."""
    mat = _matrix(rc, n=302)
    geom = (dict(pr=64, xw=64, cb=16) if "panels" in kernel
            else dict(cb=16))
    _run_desc_spmm(kernel, mat, nvec, cuda, **geom)


@pytest.mark.parametrize("kernel", DESC_SPMM_KERNELS)
def test_desc_spmm_partial_column_tile(cuda, kernel):
    """nvec = 40 with nvt = 8: one tile of 64 columns, 16 lanes of four, six
    of them idle."""
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
    vidx needs a value window above 32,768 floats (128 KB): the
    whole-vector kernel and the synchronous panel kernel stage the tables
    in slices beside the window, and the double-buffered panel kernel,
    which holds two windows, refuses it for want of shared memory."""
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
    density-0.1 vocab weight in beta(4,8) at nvec=128: the whole-vector
    kernel stages a ring of rounds of one whole chunk beside a 128-column
    Y tile; the panel kernels stage two whole chunks a stage beside a
    (128, 128) Y tile of a quarter panel, four columns a lane."""
    w = np.random.default_rng(0).standard_normal((2_000, 4_096), np.float32)
    w = np.where(np.abs(w) >= np.quantile(np.abs(w), 0.9), w, 0.0)
    mat = F.csr_to_spc5(F.csr_from_dense(w.astype(np.float32)), 4, 8)
    geom = (dict(pr=512, xw=512, cb=64) if "panels" in kernel
            else dict(cb=256))
    plan = _run_desc_spmm(kernel, mat, 128, cuda, **geom)
    if "panels" not in kernel:
        launch = KDM.whole_launch(
            int(plan.chunk_vbase.shape[0]), cb=plan.cb, r=plan.r, c=plan.c,
            vmax=plan.vmax, nvec=128, vec=4,
            wv=plan.desc_vidx.element_size(),
            wx=plan.desc_xcol.element_size(), device=cuda)
        assert (launch["tile_columns"], launch["vector"], launch["stages"],
                launch["chunks_per_stage"], launch["blocks_per_stage"]) == (
            128, 4, 2, 1, plan.cb)
        return
    launch = KDM.panels_launch(
        KDM.PANEL_DB_STAGES if kernel.endswith("_db") else 1, plan.npanels,
        plan.nchunks, cb=plan.cb, r=plan.r, c=plan.c, vmax=plan.vmax,
        pr=plan.pr, nvec=128, vec=4, wv=plan.desc_vidx.element_size(),
        wx=plan.desc_xcol.element_size(), device=cuda)
    assert (launch["tile_columns"], launch["vector"], launch["row_parts"],
            launch["chunks_per_stage"], launch["blocks_per_stage"]) == (
        128, 4, 4, 2, 2 * plan.cb)


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
# panel descriptor SpMM pair: split grid, staged tables, one writer per
# Y-tile row, wide lanes
# ----------------------------------------------------------------------------

PANEL_DESC_SPMM = ("spmm_cuda_panels_desc", "spmm_cuda_panels_desc_db")


def _check_panel_spmm(kernel, plan, x, tables=None, **kw):
    """One wrapper call on the plan's arrays (``tables`` replaces the four
    descriptor tables; ``split`` in kw), counted once and held against
    ``spmm_panels_desc`` on the same tables."""
    tables = tables or (plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
                        plan.desc_yrow)
    plain = R.spmm_panels_desc(
        R.SPC5PanelDescDevice(plan.values, *tables, plan.chunk_vbase,
                              plan.chunk_xbase), x, pr=plan.pr,
        nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    before = KDM.LAUNCHES[kernel]
    y = getattr(KDM, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, *tables, plan.values, x,
        r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
        pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad, **kw)
    torch.cuda.synchronize()
    assert KDM.LAUNCHES[kernel] == before + 1
    assert y.shape == (plan.nrows, x.shape[1]) and torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale, kw)


def _spmm_split_plan(rc, device):
    """302 rows in panels of 64 (nrows % pr != 0), 700 columns, cb=4: many
    chunks a panel, so S can be 1, nchunks, or neither."""
    mat = _matrix(rc, n=302, m=700, density=0.05)
    plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                       tune=False, device=device, pr=64, xw=64, cb=4)
    assert plan.nrows % plan.pr and plan.nchunks >= 5, plan.nchunks
    return plan


def _xmat(rows, nvec, seed, device):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (rows, nvec)).astype(np.float32)).to(device)


@pytest.mark.parametrize("nvec", [1, 3, 4, 16, 128, 256])
@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_panel_spmm_widths(cuda, kernel, rc, nvec):
    """Every block shape at one column a lane (nvec 1 and 3, a group of
    four lanes with one idle) and four (nvec 4: 32 blocks a warp; 16; 128
    and 256: 64-column tiles), at the wrapper's S."""
    plan = _spmm_split_plan(rc, cuda)
    _check_panel_spmm(kernel, plan, _xmat(plan.ncols, nvec, nvec, cuda))


@pytest.mark.parametrize("split", ["one", "all", "ragged"])
@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_panel_spmm_split(cuda, kernel, rc, split):
    """S = 1 (plain stores), S = nchunks (one chunk a CTA) and an S that
    does not divide nchunks, at nvec 16 and 128."""
    plan = _spmm_split_plan(rc, cuda)
    n = plan.nchunks
    s = {"one": 1, "all": n,
         "ragged": next(k for k in range(3, n) if n % k)}[split]
    for nvec in (16, 128):
        _check_panel_spmm(kernel, plan, _xmat(plan.ncols, nvec, 21, cuda),
                          split=s)


def _reordered(plan, order):
    """The plan's tables with each chunk's blocks shuffled ("permuted") or
    each chunk holding its first two blocks in turn ("repeated")."""
    pick = (torch.from_numpy(np.random.default_rng(5).permutation(plan.cb))
            if order == "permuted" else torch.arange(plan.cb) % 2)
    pick = pick.to(plan.desc_valid.device)
    return tuple(t[:, :, pick].contiguous() for t in (
        plan.desc_valid, plan.desc_vidx, plan.desc_xcol, plan.desc_yrow))


@pytest.mark.parametrize("order", ["permuted", "repeated"])
@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_panel_spmm_block_rows_in_any_order(cuda, kernel, rc, order):
    """Block rows shuffled within each chunk, or repeated in every block of
    it (so one lane group walks every block of the stage's rows), at nvec
    3, 4, 16 and 128, at the wrapper's S and at S = 1."""
    plan = _spmm_split_plan(rc, cuda)
    tables = _reordered(plan, order)
    for nvec in (3, 4, 16, 128):
        x = _xmat(plan.ncols, nvec, nvec + 1, cuda)
        for split in (None, 1):
            _check_panel_spmm(kernel, plan, x, tables=tables, split=split)


@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_panel_spmm_reads_no_x_row_it_lacks(cuda, kernel, rc):
    """X 37 rows short of ncols with Inf in its row 0, on a matrix whose
    column 0 is empty: no lane reads X for a column past its rows, an unset
    lane or an empty slot of a batch, so Y stays finite and matches the
    plain version (which pads X with zeros), at nvec 3, 16 and 128, at the
    wrapper's S and at S = 1."""
    d = _dense((302, 700), 0.05, 15)
    d[:, 0] = 0.0
    mat = F.csr_to_spc5(F.csr_from_dense(d), *rc)
    plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                       tune=False, device=cuda, pr=64, xw=64, cb=4)
    for nvec in (3, 16, 128):
        x = _xmat(plan.ncols - 37, nvec, 16, cuda)
        x[0] = float("inf")
        for split in (None, 1):
            _check_panel_spmm(kernel, plan, x, split=split)


@pytest.mark.parametrize("parts", [1, 2, 8])
@pytest.mark.parametrize("tile", [4, 32, 128])
@pytest.mark.parametrize("threads", [32, 128, 512])
@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
def test_panel_spmm_tiles_parts_and_threads(cuda, kernel, threads, tile,
                                            parts, monkeypatch):
    """Narrower tiles (more tiles a panel, narrower lane groups, more
    groups a warp), row parts of a panel (8: 8 rows each) and one to
    sixteen warps a CTA, on repeated block rows."""
    monkeypatch.setattr(KDM, "PANEL_TILE", tile)
    monkeypatch.setattr(KDM, "PANEL_ROW_PARTS", parts)
    monkeypatch.setattr(KDM, "PANEL_THREADS", threads)
    plan = _spmm_split_plan((4, 8), cuda)
    _check_panel_spmm(kernel, plan, _xmat(plan.ncols, 128, 4, cuda),
                      tables=_reordered(plan, "repeated"))


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
@pytest.mark.parametrize("rc", [(2, 4), (4, 8), (8, 4)])
def test_panel_spmm_chunks_a_stage(cuda, kernel, rc, chunks, monkeypatch):
    """Stages of one to four chunks (the last round of a range short, or a
    range shorter than a stage) at the wrapper's S, S = 1 and one chunk a
    CTA, at nvec 16 and 128, on repeated block rows."""
    monkeypatch.setattr(KDM, "PANEL_STAGE_CHUNKS", chunks)
    plan = _spmm_split_plan(rc, cuda)
    tables = _reordered(plan, "repeated")
    for nvec in (16, 128):
        x = _xmat(plan.ncols, nvec, 9, cuda)
        for split in (None, 1, plan.nchunks):
            _check_panel_spmm(kernel, plan, x, tables=tables, split=split)


@pytest.mark.parametrize("split", [None, 1, 3])
@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
def test_panel_spmm_all_padding_panels(cuda, kernel, split):
    """Panels 1 and 3 hold no nonzero (300 rows, so the last is ragged);
    their rows come out 0 whatever the split."""
    d = _dense((300, 400), 0.05, 13)
    d[64:128] = 0.0
    d[192:256] = 0.0
    mat = F.csr_to_spc5(F.csr_from_dense(d), 2, 4)
    plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                       tune=False, device=cuda, pr=64, xw=64, cb=8)
    assert not bool(plan.desc_valid[1].any()) and plan.nchunks >= 3
    for nvec in (3, 16):
        _check_panel_spmm(kernel, plan, _xmat(plan.ncols, nvec, 14, cuda),
                          split=split)


@pytest.mark.parametrize("kernel", PANEL_DESC_SPMM)
def test_panel_spmm_x_in_place_and_misaligned(cuda, kernel):
    """X short of ncols_pad is read in place (nothing past its rows); an X
    that starts 4 bytes past a 16-byte boundary takes one column a lane."""
    plan = _spmm_split_plan((2, 4), cuda)
    x = _xmat(plan.ncols - 37, 16, 6, cuda)
    assert x.shape[0] < plan.ncols_pad
    _check_panel_spmm(kernel, plan, x)
    buf = torch.zeros(plan.ncols * 16 + 1, device=cuda)
    x = buf[1:].view(plan.ncols, 16)
    x.copy_(_xmat(plan.ncols, 16, 7, cuda))
    assert KDM.panels_vector(16, x) == 1
    _check_panel_spmm(kernel, plan, x)


#: (chunks a stage, blocks a stage, r, c, vmax, part rows, tw, vidx bytes,
#: xcol bytes): chip_smoke.py's vocab layer and test multi at their tiles,
#: a one-column-lane tile of three chunks a stage, and the sliced int32
#: window of test_desc_spmm_table_widths.
SPMM_SMEM_GEOMETRIES = {
    "vocab": (2, 128, 4, 8, 312, 128, 128, 2, 2),
    "test_multi": (1, 64, 2, 4, 176, 512, 16, 2, 2),
    "narrow": (3, 12, 8, 4, 40, 64, 1, 1, 1),
    "sliced": (1, 320, 4, 8, 40_960, 64, 16, 4, 2),
}


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(SPMM_SMEM_GEOMETRIES))
def test_panel_spmm_smem_matches_the_kernel(cuda, case, stages):
    """The wrapper's ``panels_smem_bytes`` is the figure the kernel's own
    layout gives (a launch whose figure differs is refused)."""
    from repro_torch.kernels import _build
    geom = SPMM_SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmm_desc")
    assert lib.spc5_spmm_desc_panels_smem(stages, *geom, 4) == \
        KDM.panels_smem_bytes(stages, *geom)


def test_panel_spmm_launch_refuses_a_wrong_smem_figure(cuda, monkeypatch):
    """A launch handed a shared-memory figure 16 bytes off the kernel's is
    refused (CUDA error 1) before it runs, and is not counted."""
    plan = _spmm_split_plan((4, 8), cuda)
    x = _xmat(plan.ncols, 16, 8, cuda)
    real = KDM.panels_launch

    def off(*args, **kw):
        launch = real(*args, **kw)
        return dict(launch, smem_bytes=launch["smem_bytes"] + 16)
    monkeypatch.setattr(KDM, "panels_launch", off)
    before = dict(KDM.LAUNCHES)
    for kernel in PANEL_DESC_SPMM:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            _check_panel_spmm(kernel, plan, x, split=1)
    assert KDM.LAUNCHES == before


# ----------------------------------------------------------------------------
# mask panel SpMM pair: split grid, staged chunks, one writer per Y-tile row,
# wide lanes
# ----------------------------------------------------------------------------

PANEL_MASK_SPMM = ("spmm_cuda_panels", "spmm_cuda_panels_db")


def _mask_arrays(plan, order="plan"):
    """The plan's four metadata arrays (col, mask, voff, row) with each
    chunk's blocks as planned, shuffled ("permuted"), or each block taking
    the row of the chunk's first or second block in turn ("repeated", which
    changes the product: every block row of a stage repeats, as in a chunk
    that spans many block columns, and each chunk's nonzeros still fit its
    window; on a plan of 312 rows, a multiple of every r, every borrowed
    block row lies whole inside the matrix)."""
    arrays = (plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
              plan.chunk_row)
    if order == "plan":
        return arrays
    if order == "repeated":
        pick = (torch.arange(plan.cb) % 2).to(plan.chunk_row.device)
        return arrays[:3] + (plan.chunk_row[:, :, pick].contiguous(),)
    pick = torch.from_numpy(np.random.default_rng(5).permutation(plan.cb))
    pick = pick.to(plan.chunk_col.device)
    return tuple(t[:, :, pick].contiguous() for t in arrays)


def _check_mask_spmm(kernel, plan, x, arrays=None, **kw):
    """One wrapper call on the plan's arrays (``arrays`` replaces the four
    metadata arrays; ``split`` in kw), counted once and held against
    ``spmm_panels`` on the same arrays with X padded with zero rows up to
    the matrix's columns (what the reference's padding gives)."""
    arrays = arrays or _mask_arrays(plan)
    xz = torch.nn.functional.pad(x, (0, 0, 0, max(0, plan.ncols
                                                  - x.shape[0])))
    plain = R.spmm_panels(
        R.SPC5PanelDevice(plan.values, *arrays, plan.chunk_vbase,
                          plan.chunk_xbase), xz, r=plan.r, c=plan.c,
        pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    before = KM.LAUNCHES[kernel]
    y = getattr(KM, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, *arrays, plan.values, x,
        r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
        pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad, **kw)
    torch.cuda.synchronize()
    assert KM.LAUNCHES[kernel] == before + 1
    assert y.shape == (plan.nrows, x.shape[1]) and torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale, kw)


@pytest.mark.parametrize("nvec", [1, 3, 4, 16, 128, 256])
@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_mask_panel_spmm_widths(cuda, kernel, rc, nvec):
    """Every block shape at one column a lane (nvec 1 and 3, a group of
    four lanes with one idle) and four (nvec 4: eight groups a warp; 16;
    128 and 256: 128-column tiles of 32 lanes), at the wrapper's S."""
    plan = _mask_split_plan(rc, cuda)
    _check_mask_spmm(kernel, plan, _xmat(plan.ncols, nvec, nvec, cuda))


@pytest.mark.parametrize("split", ["one", "all", "ragged"])
@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_mask_panel_spmm_split(cuda, kernel, rc, split):
    """S = 1 (plain stores), S = nchunks (one chunk a CTA) and an S that
    does not divide nchunks, at nvec 3, 16 and 128."""
    plan = _mask_split_plan(rc, cuda)
    n = plan.nchunks
    s = {"one": 1, "all": n,
         "ragged": next(k for k in range(3, n) if n % k)}[split]
    for nvec in (3, 16, 128):
        _check_mask_spmm(kernel, plan, _xmat(plan.ncols, nvec, 21, cuda),
                         split=s)


@pytest.mark.parametrize("order", ["permuted", "repeated"])
@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_mask_panel_spmm_block_rows_in_any_order(cuda, kernel, rc, order):
    """Blocks shuffled within each chunk, or two block rows repeated over
    all of its blocks (so one lane group walks every block of a row), at
    nvec 3, 4, 16 and 128, at the wrapper's S and at S = 1."""
    plan = _mask_split_plan(rc, cuda, n=312)
    arrays = _mask_arrays(plan, order)
    for nvec in (3, 4, 16, 128):
        x = _xmat(plan.ncols, nvec, nvec + 1, cuda)
        for split in (None, 1):
            _check_mask_spmm(kernel, plan, x, arrays=arrays, split=split)


@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_mask_panel_spmm_reads_no_x_row_it_lacks(cuda, kernel, rc):
    """X 37 rows short of ncols (and of ncols_pad) with Inf in its row 0, on
    a matrix whose column 0 is empty: no lane reads X for a column past its
    rows, an unset lane or an empty slot of a batch, so Y stays finite and
    matches the plain version on X padded with zeros, at nvec 3, 16 and
    128, at the wrapper's S and at S = 1."""
    d = _dense((302, 700), 0.05, 15)
    d[:, 0] = 0.0
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), *rc),
                       layout="panels", lowering="mask", tune=False,
                       device=cuda, pr=64, xw=64, cb=4)
    for nvec in (3, 16, 128):
        x = _xmat(plan.ncols - 37, nvec, 16, cuda)
        x[0] = float("inf")
        assert x.shape[0] < plan.ncols_pad
        for split in (None, 1):
            _check_mask_spmm(kernel, plan, x, split=split)


@pytest.mark.parametrize("parts", [1, 2, 8])
@pytest.mark.parametrize("tile", [4, 32, 128])
@pytest.mark.parametrize("threads", [32, 128, 512])
@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
def test_mask_panel_spmm_tiles_parts_and_threads(cuda, kernel, threads, tile,
                                                 parts, monkeypatch):
    """Narrower tiles (more tiles a panel, narrower lane groups, more
    groups a warp), row parts of a panel (8: 8 rows each) and one to
    sixteen warps a CTA, on repeated block rows, at the wrapper's S and S =
    1."""
    monkeypatch.setattr(KM, "PANEL_TILE", tile)
    monkeypatch.setattr(KM, "PANEL_ROW_PARTS", parts)
    monkeypatch.setattr(KM, "PANEL_THREADS", threads)
    plan = _mask_split_plan((4, 8), cuda, n=312)
    for split in (None, 1):
        _check_mask_spmm(kernel, plan, _xmat(plan.ncols, 128, 4, cuda),
                         arrays=_mask_arrays(plan, "repeated"), split=split)


@pytest.mark.parametrize("chunks", [1, 2, 3, 4])
@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 8), (8, 4)])
def test_mask_panel_spmm_chunks_a_stage(cuda, kernel, rc, chunks,
                                        monkeypatch):
    """Stages of one to four chunks (the last round of a range short, or a
    range shorter than a stage) at the wrapper's S, S = 1 and one chunk a
    CTA, at nvec 16 and 128, on repeated block rows."""
    monkeypatch.setattr(KM, "PANEL_STAGE_CHUNKS", chunks)
    plan = _mask_split_plan(rc, cuda, n=312)
    arrays = _mask_arrays(plan, "repeated")
    for nvec in (16, 128):
        x = _xmat(plan.ncols, nvec, 9, cuda)
        for split in (None, 1, plan.nchunks):
            _check_mask_spmm(kernel, plan, x, arrays=arrays, split=split)


@pytest.mark.parametrize("cb", [5, 6])
@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
def test_mask_panel_spmm_unaligned_metadata(cuda, kernel, cb):
    """cb 5 and 6: a metadata row is not a multiple of 16 bytes, so it is
    copied by cp.async in 4-byte pieces, not by a bulk copy; one or two
    chunks a stage, at nvec 16 and 128, at the wrapper's S and S = 1."""
    plan = _mask_split_plan((2, 4), cuda, cb=cb)
    for nvec in (16, 128):
        x = _xmat(plan.ncols, nvec, 10, cuda)
        for split in (None, 1):
            _check_mask_spmm(kernel, plan, x, split=split)


@pytest.mark.parametrize("split", [None, 1, 3])
@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
def test_mask_panel_spmm_all_padding_panels(cuda, kernel, split):
    """Panels 1 and 3 hold no nonzero (300 rows, so the last is ragged);
    their rows come out 0 whatever the split."""
    d = _dense((300, 400), 0.05, 13)
    d[64:128] = 0.0
    d[192:256] = 0.0
    mat = F.csr_to_spc5(F.csr_from_dense(d), 2, 4)
    plan = ops.prepare(mat, layout="panels", lowering="mask", tune=False,
                       device=cuda, pr=64, xw=64, cb=8)
    assert not bool(plan.chunk_mask[1].any()) and plan.nchunks >= 3
    for nvec in (3, 16, 128):
        _check_mask_spmm(kernel, plan, _xmat(plan.ncols, nvec, 14, cuda),
                         split=split)


@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
def test_mask_panel_spmm_chunks_spanning_columns(cuda, kernel, monkeypatch):
    """chip_smoke.py's geometry (pr 512, cb 64, xw 512) at density 0.1 on
    1,030 rows: a chunk's blocks span several block columns, so block rows
    repeat within a stage; at nvec 16 and 128, at the wrapper's S, S = 1
    and with eight row parts forced."""
    d = _dense((1_030, 700), 0.1, 17)
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), 4, 8),
                       layout="panels", lowering="mask", tune=False,
                       device=cuda, pr=512, xw=512, cb=64)
    for nvec in (16, 128):
        x = _xmat(plan.ncols, nvec, 18, cuda)
        for split in (None, 1):
            _check_mask_spmm(kernel, plan, x, split=split)
        monkeypatch.setattr(KM, "PANEL_ROW_PARTS", 8)
        _check_mask_spmm(kernel, plan, x)
        monkeypatch.setattr(KM, "PANEL_ROW_PARTS", 1)


@pytest.mark.parametrize("kernel", PANEL_MASK_SPMM)
def test_mask_panel_spmm_x_misaligned(cuda, kernel):
    """An X that starts 4 bytes past a 16-byte boundary takes one column a
    lane; 8 bytes past, two."""
    plan = _mask_split_plan((2, 4), cuda)
    for offset, vec in ((1, 1), (2, 2)):
        buf = torch.zeros(plan.ncols * 16 + offset, device=cuda)
        x = buf[offset:].view(plan.ncols, 16)
        x.copy_(_xmat(plan.ncols, 16, 7, cuda))
        assert KM.panels_vector(16, x) == vec
        _check_mask_spmm(kernel, plan, x)


#: (chunks a stage, cb, vmax, part rows, tw):
#: chip_smoke.py's vocab mask layer at nvec 128 and 16, a one-column-lane
#: tile of three chunks a stage, and cb = 5 (unaligned metadata rows).
MASK_SPMM_SMEM_GEOMETRIES = {
    "vocab128": (2, 64, 312, 128, 128),
    "vocab16": (2, 64, 312, 512, 16),
    "narrow": (3, 4, 40, 64, 1),
    "odd": (1, 5, 24, 8, 4),
}


@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(MASK_SPMM_SMEM_GEOMETRIES))
def test_mask_panel_spmm_smem_matches_the_kernel(cuda, case, stages):
    """The wrapper's ``panels_smem_bytes`` is the figure the kernel's own
    layout gives (a launch whose figure differs is refused)."""
    from repro_torch.kernels import _build
    geom = MASK_SPMM_SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmm")
    assert lib.spc5_spmm_panels_smem(stages, *geom, 4) == \
        KM.panels_smem_bytes(stages, *geom)


def test_mask_panel_spmm_launch_refuses_a_wrong_smem_figure(cuda,
                                                            monkeypatch):
    """A launch handed a shared-memory figure 16 bytes off the kernel's is
    refused (CUDA error 1) before it runs, and is not counted."""
    plan = _mask_split_plan((4, 8), cuda)
    x = _xmat(plan.ncols, 16, 8, cuda)
    real = KM.panels_launch

    def off(*args, **kw):
        launch = real(*args, **kw)
        return dict(launch, smem_bytes=launch["smem_bytes"] + 16)
    monkeypatch.setattr(KM, "panels_launch", off)
    before = dict(KM.LAUNCHES)
    for kernel in PANEL_MASK_SPMM:
        with pytest.raises(RuntimeError, match="CUDA error 1"):
            _check_mask_spmm(kernel, plan, x, split=1)
    assert KM.LAUNCHES == before


# ----------------------------------------------------------------------------
# whole-vector SpMM pair: contiguous chunk ranges, a ring of staged rounds,
# a per-round nonzero list, a Y tile (csrc/spc5_spmm_whole.cuh)
# ----------------------------------------------------------------------------

#: kernel -> (lowering, wrapper module)
WHOLE_SPMM = {"spmm_cuda": ("mask", KM), "spmm_cuda_desc": ("descriptor", KDM)}


def _wspmm_plan(kernel, rc, device, n=302, m=700, density=0.05, cb=8,
                seed=0):
    """A whole-vector plan of the kernel's lowering: 302 x 700 at cb 8, so
    there are many chunks (G can be 1, nchunks or neither) and a chunk's
    blocks span a few block rows."""
    return ops.prepare(_matrix(rc, n=n, m=m, density=density, seed=seed),
                       layout="whole_vector", lowering=WHOLE_SPMM[kernel][0],
                       tune=False, device=device, cb=cb)


def _wspmm_arrays(plan):
    """The plan's arrays the wrapper takes between chunk_vbase and values."""
    if plan.lowering == "descriptor":
        return [plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
                plan.desc_yrow]
    return [plan.chunk_col, plan.chunk_mask, plan.chunk_voff, plan.chunk_row]


def _wspmm_check(kernel, plan, x, arrays=None, **kw):
    """One launch of ``kernel`` on the plan's arrays (or ``arrays``, in
    their place) held against the plain version on the same arrays, within
    1e-5 of max|Y|; returns Y."""
    lowering, mod = WHOLE_SPMM[kernel]
    arrays = _wspmm_arrays(plan) if arrays is None else arrays
    geom = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                nrows=plan.nrows, ncols=plan.ncols)
    before = mod.LAUNCHES[kernel]
    y = getattr(mod, kernel)(plan.chunk_vbase, *arrays, plan.values, x,
                             **geom, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[kernel] == before + 1
    if lowering == "descriptor":
        plain = R.spmm_desc(R.SPC5DescDevice(plan.values, *arrays,
                                             plan.chunk_vbase), x,
                            nrows=plan.nrows)
    else:
        plain = R.spmm(R.SPC5Device(plan.values, *arrays, plan.chunk_vbase),
                       x, r=plan.r, c=plan.c, nrows=plan.nrows,
                       ncols=plan.ncols)
    assert y.shape == (plan.nrows, x.shape[1]) and y.dtype == torch.float32
    assert torch.isfinite(y).all()
    scale = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(scale, 1.0), (err, scale)
    return y


def _wspmm_nchunks(plan):
    return int(plan.chunk_vbase.shape[0])


@pytest.mark.parametrize("nvec", [1, 3, 4, 16, 128, 256])
@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_whole_spmm_widths(cuda, kernel, rc, nvec):
    """Every block shape at one column a lane (nvec 1; 3: a tile of four
    lanes, one idle) and four (nvec 4, 16, 128; 256: two 128-column
    tiles), at the wrapper's launch."""
    plan = _wspmm_plan(kernel, rc, cuda)
    _wspmm_check(kernel, plan, _xmat(plan.ncols, nvec, nvec, cuda))


@pytest.mark.parametrize("grid", ["one", "planned", "all", "ragged"])
@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_whole_spmm_grid(cuda, kernel, rc, grid):
    """G = 1 (one CTA walks every chunk), the planned G, one chunk a CTA and
    a G that divides no range evenly, at nvec 16."""
    plan = _wspmm_plan(kernel, rc, cuda)
    n = _wspmm_nchunks(plan)
    g = {"one": 1, "planned": None, "all": n, "ragged": max(1, n // 3 - 1)}
    _wspmm_check(kernel, plan, _xmat(plan.ncols, 16, 3, cuda),
                 grid=g[grid])


def _wspmm_reordered(plan, order):
    """The plan's metadata (mask) or tables (descriptor) with each chunk's
    blocks shuffled ("shuffled": a chunk's rows no longer sorted), its
    block rows permuted ("permuted": rows jump up and down, chunks share
    none; nrows % r == 0, so every lane of a block row moves with it), or
    each block taking the row of its chunk's first or second block
    ("repeated")."""
    r, cb = plan.r, plan.cb
    arrays = [t.cpu().numpy() for t in _wspmm_arrays(plan)]
    rows = arrays[3]  # chunk_row, or the yrow table
    if order == "shuffled":
        pick = np.random.default_rng(3).permutation(cb)
        arrays = [t[:, pick] for t in arrays]
    elif order == "repeated":
        arrays[3] = rows[:, np.arange(cb) % 2]
    else:
        perm = np.random.default_rng(5).permutation(plan.nrows // r)
        y = rows.astype(np.int64)
        base = (y if y.ndim == 2 else y[..., :1]) // r  # a block's row / r
        arrays[3] = (perm[base] * r + (y - base * r)).astype(rows.dtype)
    return [torch.from_numpy(np.ascontiguousarray(t)).to(plan.device)
            for t in arrays]


@pytest.mark.parametrize("order", ["shuffled", "permuted", "repeated"])
@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_whole_spmm_rows_in_any_order(cuda, kernel, rc, order):
    """Rows out of order or repeated: the list is no longer one segment a
    row, so every run goes straight to Y; at the planned G and at G = 1,
    nvec 16 and 128 (nrows a multiple of r, so permuted block rows stay
    whole: the descriptor kernel reads a block's rows as yrow[0] + k / c,
    the identity chunk_descriptors keeps)."""
    n = 304 if rc[0] in (4, 8) else 302
    assert n % rc[0] == 0
    plan = _wspmm_plan(kernel, rc, cuda, n=n)
    arrays = _wspmm_reordered(plan, order)
    for nvec in (16, 128):
        x = _xmat(plan.ncols, nvec, 11, cuda)
        for grid in (None, 1):
            _wspmm_check(kernel, plan, x, arrays, grid=grid)


@pytest.mark.parametrize("tile", [16, 64])
@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (8, 4)])
def test_whole_spmm_rows_past_the_tile(cuda, kernel, rc, tile, monkeypatch):
    """A tall sparse matrix (3,000 x 60 at density 0.02, cb 64): a chunk
    spans far more rows than a Y tile of 16 or 64 holds, so most of a
    round's rows go straight to Y, and the tile is rebased round after
    round; at G = 1 too."""
    monkeypatch.setattr(KM, "WHOLE_TILE_ROWS", tile)
    plan = _wspmm_plan(kernel, rc, cuda, n=3_000, m=60, density=0.02,
                       cb=64)
    for nvec in (4, 128):
        x = _xmat(plan.ncols, nvec, 12, cuda)
        for grid in (None, 1):
            _wspmm_check(kernel, plan, x, grid=grid)


@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
def test_whole_spmm_x_misaligned_and_inf_where_no_lane_reads(cuda, kernel):
    """An X that starts 4 or 8 bytes past a 16-byte boundary takes one or
    two columns a lane (tiles of 32 or 64 columns at nvec 128); Inf in the
    X rows of the matrix's empty columns reaches no output."""
    d = _dense((302, 700), 0.05, 13)
    d[:, 100:140] = 0.0
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(d), 2, 4),
                       layout="whole_vector", lowering=WHOLE_SPMM[kernel][0],
                       tune=False, device=cuda, cb=8)
    for offset, vec in ((1, 1), (2, 2)):
        buf = torch.zeros(plan.ncols * 128 + offset, device=cuda)
        x = buf[offset:].view(plan.ncols, 128)
        x.copy_(_xmat(plan.ncols, 128, 7, cuda))
        assert KM.panels_vector(128, x) == vec
        _wspmm_check(kernel, plan, x)
    x = _xmat(plan.ncols, 16, 8, cuda)
    x[100:140] = float("inf")
    y = _wspmm_check(kernel, plan, x.clone(), grid=1)
    want = torch.from_numpy(d.astype(np.float64) @ np.nan_to_num(
        x.cpu().double().numpy(), posinf=0.0)).to(cuda)
    assert float((y.double() - want).abs().max()) <= RTOL * float(
        want.abs().max())


@pytest.mark.parametrize("grid", [None, 1, "all"])
@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
def test_whole_spmm_all_padding_chunks(cuda, kernel, grid):
    """A matrix whose nonzeros all lie in its first rows, chunked with cb 4:
    the last chunk is mostly padding; and a matrix with no nonzero (one
    chunk, all padding), which leaves Y zero."""
    d = np.zeros((200, 90), np.float32)
    d[:3] = _dense((3, 90), 0.3, 14)[:3]
    for dense in (d, np.zeros_like(d)):
        plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(dense), 4, 8),
                           layout="whole_vector",
                           lowering=WHOLE_SPMM[kernel][0], tune=False,
                           device=cuda, cb=4)
        g = _wspmm_nchunks(plan) if grid == "all" else grid
        y = _wspmm_check(kernel, plan, _xmat(90, 16, 15, cuda), grid=g)
        if not dense.any():
            assert not bool(y.any())


@pytest.mark.parametrize("knob,value", [
    ("WHOLE_THREADS", 32), ("WHOLE_THREADS", 128), ("WHOLE_THREADS", 512),
    ("WHOLE_STAGE_CHUNKS", 1), ("WHOLE_STAGE_CHUNKS", 3),
    ("WHOLE_TILE", 32), ("WHOLE_DB_STAGES", 1)])
@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
@pytest.mark.parametrize("rc", [(2, 4), (4, 8), (8, 4)])
def test_whole_spmm_knobs(cuda, kernel, rc, knob, value, monkeypatch):
    """Threads (32: one warp, one group at nvec 128), chunks a round (three:
    a last round of fewer), a 32-column tile at nvec 128 (four tiles), and
    one stage a round (no ring), each at nvec 16 and 128."""
    monkeypatch.setattr(KM, knob, value)
    plan = _wspmm_plan(kernel, rc, cuda)
    for nvec in (16, 128):
        _wspmm_check(kernel, plan, _xmat(plan.ncols, nvec, 16, cuda))


@pytest.mark.parametrize("cb", [5, 6])
@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
def test_whole_spmm_unaligned_runs(cuda, kernel, cb):
    """cb 5 or 6: metadata rows and table runs that are not whole 16-byte
    pieces go by cp.async in 4-byte pieces, also in rounds of several
    chunks."""
    plan = _wspmm_plan(kernel, (2, 4), cuda, cb=cb)
    for nvec in (16, 128):
        _wspmm_check(kernel, plan, _xmat(plan.ncols, nvec, 17, cuda))


@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
def test_whole_spmm_smoke_geometry(cuda, kernel):
    """chip_smoke.py's geometry (cb 256, beta(4,8)) on a 2,000 x 4,096 slice
    of the density-0.1 vocab weight: the planned launch at nvec 128 (one
    128-column tile, 32 lanes of four, 512 threads, a ring of two rounds,
    two CTAs an SM), at G = 1 and at one chunk a CTA."""
    w = np.random.default_rng(0).standard_normal((2_000, 4_096), np.float32)
    w = np.where(np.abs(w) >= np.quantile(np.abs(w), 0.9), w, 0.0)
    plan = ops.prepare(F.csr_to_spc5(F.csr_from_dense(w.astype(np.float32)),
                                     4, 8),
                       layout="whole_vector", lowering=WHOLE_SPMM[kernel][0],
                       tune=False, device=cuda, cb=256)
    x = _xmat(plan.ncols, 128, 19, cuda)
    for grid in (None, 1, _wspmm_nchunks(plan)):
        _wspmm_check(kernel, plan, x, grid=grid)
    geom = dict(cb=plan.cb, r=4, c=8, vmax=plan.vmax, nvec=128, vec=4,
                device=cuda)
    if plan.lowering == "descriptor":
        geom.update(wv=plan.desc_vidx.element_size(),
                    wx=plan.desc_xcol.element_size())
    launch = WHOLE_SPMM[kernel][1].whole_launch(_wspmm_nchunks(plan), **geom)
    assert (launch["tile_columns"], launch["vector"], launch["lanes"],
            launch["threads"], launch["stages"]) == (128, 4, 32, 512, 2)
    assert launch["ctas_per_sm"] >= 2


#: (stages, q, nb, r, c, vmax, tw, vec, tile rows, threads): the token plan
#: at nvec 128 and 16, FEM's one-stage round, a sliced int32 window, and a
#: narrow one-column tile.
WHOLE_SPMM_SMEM_GEOMETRIES = {
    "token128": (2, 2, 512, 4, 8, 1144, 128, 4, 32, 512),
    "token16": (2, 1, 256, 4, 8, 1144, 16, 4, 64, 256),
    "fem": (1, 1, 256, 4, 4, 4096, 16, 4, 64, 256),
    "sliced": (1, 1, 160, 4, 8, 40_960, 16, 4, 16, 256),
    "narrow": (2, 3, 12, 8, 4, 40, 1, 1, 16, 32),
}


@pytest.mark.parametrize("widths", [(2, 2), (4, 1)])
@pytest.mark.parametrize("case", sorted(WHOLE_SPMM_SMEM_GEOMETRIES))
def test_whole_spmm_smem_matches_the_kernel(cuda, case, widths):
    """Each wrapper's ``whole_smem_bytes`` is the figure its kernel's own
    layout gives (``spc5_spmm_whole_smem``, ``spc5_spmm_desc_whole_smem``);
    a launch whose figure differs is refused."""
    from repro_torch.kernels import _build
    stages, q, nb, r, c, vmax, tw, vec, rows, threads = \
        WHOLE_SPMM_SMEM_GEOMETRIES[case]
    head = (stages, q, nb, r, c, vmax)
    tail = (tw, vec, rows, threads)
    assert _build.load_library("spc5_spmm").spc5_spmm_whole_smem(
        *head, *tail, 4) == KM.whole_smem_bytes(*head, *tail)
    assert _build.load_library("spc5_spmm_desc").spc5_spmm_desc_whole_smem(
        *head, *widths, *tail, 4) == KDM.whole_smem_bytes(*head, *widths,
                                                          *tail)


@pytest.mark.parametrize("kernel", sorted(WHOLE_SPMM))
def test_whole_spmm_launch_refuses_a_wrong_smem_figure(cuda, kernel,
                                                       monkeypatch):
    """A launch handed a shared-memory figure 16 bytes off the kernel's is
    refused (CUDA error 1) before it runs, and is not counted."""
    mod = WHOLE_SPMM[kernel][1]
    plan = _wspmm_plan(kernel, (4, 8), cuda)
    real = mod.whole_launch

    def off(*args, **kw):
        launch = real(*args, **kw)
        return dict(launch, smem_bytes=launch["smem_bytes"] + 16)
    monkeypatch.setattr(mod, "whole_launch", off)
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _wspmm_check(kernel, plan, _xmat(plan.ncols, 16, 8, cuda), grid=1)
    assert mod.LAUNCHES == before


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
    spmv_coo for a flat tail) and SpMM (multi kernel + tail: the SpMM tail
    kernel for panel buckets, spmm_coo for a flat tail) of a test plan on
    the card against the same plan on the CPU."""
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
    assert KT.LAUNCHES["spmm_tail_cuda"] == (multi_layout == "panels")


# ----------------------------------------------------------------------------
# both tail kernels (spmv_tail_cuda, spmm_tail_cuda): planned and forced
# grids, permuted and misaligned buckets, NaN where no slot reads, refused
# launches
# ----------------------------------------------------------------------------

_TTAIL_PLANS = {}

#: Batches of the SpMM tail: 1 to 256 under the nvt rule (nvec a multiple of
#: min(128, nvec)), four, two and one columns a lane.
_TTAIL_NVECS = (1, 2, 3, 16, 100, 128, 256)


def _ttail_plan(case, rc, cuda):
    """The test plan of a TAIL_CASES geometry on the card, built once."""
    key = (case, rc)
    if key not in _TTAIL_PLANS:
        _TTAIL_PLANS[key] = _tail_plan(case, rc, cuda)
    plan = _TTAIL_PLANS[key]
    if not plan.n_single:
        pytest.skip(f"no singleton blocks in beta{rc} for {case}")
    return plan


def _ttail_spmv(plan, x, **kw):
    """spmv_tail_cuda on the plan's buckets (one launch) and its plain
    version."""
    args, akw = _tail_args(plan)
    before = KT.LAUNCHES["spmv_tail_cuda"]
    y = KT.spmv_tail_cuda(*args, x, **akw, **kw)
    torch.cuda.synchronize()
    assert KT.LAUNCHES["spmv_tail_cuda"] == before + 1
    return y, R.spmv_coo_panels(*args[1:], x, pr=plan.tail_pr,
                                nrows=plan.nrows)


def _ttail_spmm(plan, x, buckets=None, **kw):
    """spmm_tail_cuda on the plan's buckets (or ``buckets``; one launch)
    and its plain version."""
    rows, cols, vals = buckets or (plan.single_rows, plan.single_cols,
                                   plan.single_values)
    before = KT.LAUNCHES["spmm_tail_cuda"]
    y = KT.spmm_tail_cuda(rows, cols, vals, x, pr=plan.tail_pr,
                          nrows=plan.nrows, **kw)
    torch.cuda.synchronize()
    assert KT.LAUNCHES["spmm_tail_cuda"] == before + 1
    return y, R.spmm_coo_panels(rows, cols, vals, x, pr=plan.tail_pr,
                                nrows=plan.nrows)


def _ttail_close(y, plain):
    assert y.shape == plain.shape and torch.isfinite(y).all()
    err = float((y - plain).abs().max())
    assert err <= RTOL * max(float(plain.abs().max()), 1.0), err


def _ttail_x(shape, cuda, seed=5):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32)).to(cuda)


@pytest.mark.parametrize("nvec", _TTAIL_NVECS)
@pytest.mark.parametrize("case", TAIL_CASES)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_spmm_tail_kernel_matches_plain(cuda, rc, case, nvec):
    plan = _ttail_plan(case, rc, cuda)
    x = _ttail_x((plan.ncols, nvec), cuda)
    _ttail_close(*_ttail_spmm(plan, x))


@pytest.mark.parametrize("case", TAIL_CASES)
def test_tail_kernels_at_forced_grids(cuda, case):
    """S = 1 and one group a CTA (SpMV); G = 1 and one group a CTA (SpMM,
    nvec 16 and 128); 128 and 512 SpMV threads, SpMM Y tiles of 16 and 64
    rows."""
    plan = _ttail_plan(case, (2, 4), cuda)
    x = _ttail_x(plan.ncols, cuda)
    smax = plan.single_rows.shape[1]
    groups = KT.tail_groups(smax)
    for split in (1, groups):
        _ttail_close(*_ttail_spmv(plan, x, split=split))
    for threads in (128, 512):
        saved = KT.TAIL_THREADS
        KT.TAIL_THREADS = threads
        try:
            _ttail_close(*_ttail_spmv(plan, x))
        finally:
            KT.TAIL_THREADS = saved
    slots = plan.single_rows.numel()
    for nvec in (16, 128):
        xm = _ttail_x((plan.ncols, nvec), cuda)
        for grid in (1, KT.tail_groups(slots)):
            _ttail_close(*_ttail_spmm(plan, xm, grid=grid))
        for rows in (16, 64):
            saved = KT.SPMM_TAIL_TILE_ROWS
            KT.SPMM_TAIL_TILE_ROWS = rows
            try:
                _ttail_close(*_ttail_spmm(plan, xm))
            finally:
                KT.SPMM_TAIL_TILE_ROWS = saved


@pytest.mark.parametrize("case", TAIL_CASES)
def test_tail_kernels_on_permuted_buckets(cuda, case):
    """Any row order stays right: every bucket's slots (padding included)
    permuted by hand, and the buckets themselves reversed."""
    plan = _ttail_plan(case, (2, 4), cuda)
    npanels, smax = plan.single_rows.shape
    rng = np.random.default_rng(11)
    perm = torch.from_numpy(np.stack([rng.permutation(smax)
                                      for _ in range(npanels)])).to(cuda)
    rows, cols, vals = (a.gather(1, perm).contiguous() for a in (
        plan.single_rows, plan.single_cols, plan.single_values))
    x = _ttail_x(plan.ncols, cuda)
    args, kw = _tail_args(plan)
    y = KT.spmv_tail_cuda(args[0], rows, cols, vals, x, **kw)
    _ttail_close(y, R.spmv_coo_panels(rows, cols, vals, x, pr=plan.tail_pr,
                                      nrows=plan.nrows))
    for nvec in (3, 16, 128):
        xm = _ttail_x((plan.ncols, nvec), cuda)
        _ttail_close(*_ttail_spmm(plan, xm, buckets=(rows, cols, vals)))
        # buckets in reverse order, each keeping its rows: the globalized
        # rows then come down the flattened slots
        rev = tuple(a.flip(0).contiguous() for a in (rows, cols, vals))
        _ttail_close(*_ttail_spmm(plan, xm, buckets=rev))


@pytest.mark.parametrize("case", TAIL_CASES)
def test_tail_kernels_on_misaligned_buckets(cuda, case):
    """Buckets that do not start on a 16-byte boundary take the 4-byte
    loads (SpMV) and 4-byte cp.async pieces (SpMM)."""
    plan = _ttail_plan(case, (2, 4), cuda)
    shape = plan.single_rows.shape

    def shifted(a):
        out = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        out[1:] = a.reshape(-1)
        return out[1:].view(shape)
    rows, cols, vals = (shifted(a) for a in (
        plan.single_rows, plan.single_cols, plan.single_values))
    assert rows.data_ptr() % 16 and vals.data_ptr() % 16
    x = _ttail_x(plan.ncols, cuda)
    args, kw = _tail_args(plan)
    y = KT.spmv_tail_cuda(args[0], rows, cols, vals, x, **kw)
    _ttail_close(y, R.spmv_coo_panels(rows, cols, vals, x, pr=plan.tail_pr,
                                      nrows=plan.nrows))
    for nvec in (1, 16, 128):
        xm = _ttail_x((plan.ncols, nvec), cuda)
        _ttail_close(*_ttail_spmm(plan, xm, buckets=(rows, cols, vals)))


@pytest.mark.parametrize("case", TAIL_CASES)
def test_tail_kernels_read_no_x_where_no_slot_reads(cuda, case):
    """NaN in x / X wherever no slot reads (the padding's column 0 and each
    bucket's window start excepted): both kernels stay finite and match
    their plain versions."""
    plan = _ttail_plan(case, (2, 4), cuda)
    read = set(plan.single_cols.cpu().numpy().ravel().tolist())
    read |= set(plan.tail_xbase.cpu().numpy().tolist()) | {0}
    unread = torch.tensor(sorted(set(range(plan.ncols)) - read),
                          dtype=torch.long, device=cuda)
    assert unread.numel()
    x = _ttail_x(plan.ncols, cuda)
    x[unread] = float("nan")
    _ttail_close(*_ttail_spmv(plan, x))
    for nvec in (1, 16, 128):
        xm = _ttail_x((plan.ncols, nvec), cuda)
        xm[unread] = float("nan")
        _ttail_close(*_ttail_spmm(plan, xm))


def test_spmm_tail_kernel_skips_padding_and_columns_outside_x(cuda):
    """The deliberate difference: slots of value 0 (the padding) and slots
    whose column lies outside X are skipped, reading nothing of X. With
    NaN in X's row 0, read only by the padding, the kernel's Y stays finite
    where the plain version (which multiplies the padding, as the
    reference's spmm_coo does) gives NaN; elsewhere the two agree."""
    rows = torch.tensor([[0, 1, 1, 0], [2, 3, 0, 0]], dtype=torch.int32)
    cols = torch.tensor([[2, 3, 4, 0], [5, 9, 0, 0]], dtype=torch.int32)
    vals = torch.tensor([[1., 2., 3., 0.], [4., 5., 0., 0.]])
    x = torch.arange(1, 13, dtype=torch.float32).reshape(6, 2)
    x[0] = float("nan")
    args = [a.to(cuda) for a in (rows, cols, vals, x)]
    y = KT.spmm_tail_cuda(*args, pr=4, nrows=7).cpu()
    # bucket 0: row 0 += 1 * X[2], row 1 += 2 * X[3] + 3 * X[4]; bucket 1:
    # row 6 += 4 * X[5]; column 9 lies outside X (6 rows): skipped
    want = torch.zeros(7, 2)
    want[0] = x[2]
    want[1] = 2 * x[3] + 3 * x[4]
    want[6] = 4 * x[5]
    assert torch.equal(y, want)
    # the plain version gathers X at every column, so it gets the slot
    # outside X as a padding slot; the padding of both buckets reads NaN
    cols[1, 1], vals[1, 1] = 0, 0.
    plain = R.spmm_coo_panels(rows, cols, vals, x, pr=4, nrows=7)
    assert torch.isnan(plain[0]).all() and torch.isnan(plain[4]).all()
    y = KT.spmm_tail_cuda(*[a.to(cuda) for a in (rows, cols, vals, x)],
                          pr=4, nrows=7).cpu()
    assert torch.equal(y, want)


def test_tail_launchers_refuse_other_plans(cuda):
    """Each launcher refuses a grid, thread count or shared-memory figure
    other than its wrapper's plan (CUDA error 1, nothing launched)."""
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load_library("spc5_spmv_tail")
    plan = _ttail_plan("powerlaw", (2, 4), cuda)
    (xbase, rows, cols, vals), _ = _tail_args(plan)
    npanels, smax = rows.shape
    x = _ttail_x(plan.ncols, cuda)
    y = torch.zeros(plan.nrows, device=cuda)
    launch = KT.tail_launch(npanels, smax, device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    dev = cuda.index or 0

    def spmv(split, threads, smem):
        return lib.spc5_spmv_tail(
            xbase.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), x.data_ptr(), y.data_ptr(), npanels, smax,
            plan.tail_pr, plan.tail_xw, plan.nrows, plan.ncols, 4, split,
            threads, smem, dev, stream)
    assert spmv(launch["split"], launch["threads"], 0) == 0
    for bad in ((launch["split"], launch["threads"], 16),
                (0, launch["threads"], 0),
                (launch["groups"] + 1, launch["threads"], 0),
                (launch["split"], 48, 0), (launch["split"], 1024, 0)):
        assert spmv(*bad) == 1, bad
    xm = _ttail_x((plan.ncols, 16), cuda)
    ym = torch.zeros(plan.nrows, 16, device=cuda)
    m = KT.spmm_tail_launch(npanels * smax, 16, 4, device=cuda)
    assert lib.spc5_spmm_tail_smem(m["tile_columns"], m["vector"],
                                   m["tile_rows"], m["threads"], 4) == \
        m["smem_bytes"] == KT.spmm_tail_smem_bytes(
            m["tile_columns"], m["vector"], m["tile_rows"], m["threads"])

    def spmm(grid, smem, threads=m["threads"]):
        return lib.spc5_spmm_tail(
            rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), xm.data_ptr(),
            ym.data_ptr(), npanels, smax, plan.tail_pr, plan.nrows,
            plan.ncols, 16, m["tile_columns"], m["vector"], 4, grid,
            m["tile_rows"], threads, smem, dev, stream)
    assert spmm(m["grid"], m["smem_bytes"]) == 0
    for bad in ((m["grid"], m["smem_bytes"] + 16),
                (m["grid"], m["smem_bytes"] - 16), (0, m["smem_bytes"]),
                (m["groups"] + 1, m["smem_bytes"]),
                (m["grid"], m["smem_bytes"], 384)):
        assert spmm(*bad) == 1, bad
    torch.cuda.synchronize()
    out = (ctypes.c_int * 2)()
    assert lib.spc5_spmm_tail_occupancy(4, 3, 256, 1024, dev,
                                        ctypes.addressof(out)) == 1


# ----------------------------------------------------------------------------
# quantised values (bf16, int8) in the four panel descriptor kernels, and
# the refusal of every other kernel
# ----------------------------------------------------------------------------

QUANT_KERNELS = ("spmv_cuda_panels_desc", "spmv_cuda_panels_desc_db",
                 "spmm_cuda_panels_desc", "spmm_cuda_panels_desc_db")
QUANT_VDTYPES = ("bf16", "int8")


def _q_plan(rc, vdtype, device, align=8, n=302, m=700, density=0.05, cb=4):
    """A panel descriptor plan at ``vdtype`` (302 rows in panels of 64, cb
    4: many chunks a panel) on ``device``."""
    mat = _matrix(rc, n=n, m=m, density=density)
    return ops.prepare(mat, layout="panels", lowering="descriptor",
                       vdtype=vdtype, tune=False, device=device, pr=64,
                       xw=64, cb=cb, align=align)


def _q_check(kernel, plan, x, **kw):
    """One call of a quantised panel wrapper, counted once and held
    against its plain version (upcast, then the int8 scale) on the card."""
    spmm = kernel.startswith("spmm")
    mod = KDM if spmm else KD
    scale = plan.value_scale if plan.vdtype == "int8" else None
    fn = R.spmm_panels_desc if spmm else R.spmv_panels_desc
    plain = fn(plan.dev, x, None, scale, pr=plan.pr, nrows=plan.nrows,
               ncols_pad=plan.ncols_pad)
    before = mod.LAUNCHES[kernel]
    y = getattr(mod, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid, plan.desc_vidx,
        plan.desc_xcol, plan.desc_yrow, plan.values, x, None, scale,
        r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
        pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[kernel] == before + 1
    assert y.dtype == torch.float32 and y.shape == plain.shape
    assert torch.isfinite(y).all()
    ref = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(ref, 1.0), (err, ref, kw)


def _q_x(kernel, plan, device, nvec=16, seed=21):
    if kernel.startswith("spmm"):
        return _xmat(plan.ncols, nvec, seed, device)
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        plan.ncols).astype(np.float32)).to(device)


@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 4), (4, 8), (8, 4)])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", QUANT_KERNELS)
def test_quantised_panel_desc_block_shapes(cuda, kernel, vdtype, rc):
    """Each of the four kernels at bf16 and int8 on five block shapes, at
    the split its wrapper picks."""
    plan = _q_plan(rc, vdtype, cuda)
    assert plan.values.dtype == {"bf16": torch.bfloat16,
                                 "int8": torch.int8}[vdtype]
    _q_check(kernel, plan, _q_x(kernel, plan, cuda))


@pytest.mark.parametrize("align", [4, 8])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", QUANT_KERNELS)
def test_quantised_windows_off_16_bytes(cuda, kernel, vdtype, align):
    """Value windows that start off a 16-byte boundary (int8 at align 8
    and 4, bf16 at align 4; bf16 windows at align 8 all start on one): the
    kernels stage the aligned span that covers a window and index into
    it."""
    plan = _q_plan((2, 4), vdtype, cuda, align=align)
    itemsize = plan.values.element_size()
    off = bool(((plan.chunk_vbase * itemsize) % 16 != 0).any())
    assert off == (vdtype == "int8" or align == 4)
    _q_check(kernel, plan, _q_x(kernel, plan, cuda))


@pytest.mark.parametrize("split", ["one", "each_chunk"])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", QUANT_KERNELS)
def test_quantised_forced_grids(cuda, kernel, vdtype, split):
    """S = 1 and one chunk a CTA (S = nchunks)."""
    plan = _q_plan((4, 8), vdtype, cuda)
    s = 1 if split == "one" else plan.nchunks
    _q_check(kernel, plan, _q_x(kernel, plan, cuda), split=s)


@pytest.mark.parametrize("nvec", [1, 2, 3, 5, 16, 100, 128, 256])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", QUANT_KERNELS[2:])
def test_quantised_spmm_widths(cuda, kernel, vdtype, nvec):
    """The SpMM pair at nvec 1 to 256 (each a multiple of min(nvt, nvec),
    the reference's rule at nvt = 128)."""
    plan = _q_plan((4, 8), vdtype, cuda)
    _q_check(kernel, plan, _q_x(kernel, plan, cuda, nvec=nvec))


def test_quantised_all_zero_chunks_take_scale_one(cuda):
    """Rows whose values are all zero (kept as nonzeros) make chunks of
    scale 1.0; their rows come out 0 from every kernel."""
    d = _dense((302, 700), 0.05, 23)
    csr = F.csr_from_dense(d)
    csr.values[:csr.rowptr[64]] = 0.0
    mat = F.csr_to_spc5(csr, 2, 4)
    plan = ops.prepare(mat, layout="panels", lowering="descriptor",
                       vdtype="int8", tune=False, device=cuda, pr=64, xw=64,
                       cb=4)
    live = plan.desc_valid[0].reshape(plan.nchunks, -1).any(-1)
    assert bool(live.any()) and bool((plan.value_scale[0][live] == 1.0).all())
    for kernel in QUANT_KERNELS:
        _q_check(kernel, plan, _q_x(kernel, plan, cuda))


@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("stages", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(SMEM_GEOMETRIES))
def test_quantised_panel_desc_smem_matches_the_kernel(cuda, case, stages,
                                                      vsize):
    """The SpMV pair's ``panels_smem_bytes`` at 4-, 2- and 1-byte values is
    the kernel's own figure."""
    from repro_torch.kernels import _build
    geom = SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmv_desc")
    assert lib.spc5_spmv_desc_panels_smem(stages, *geom, vsize) == \
        KD.panels_smem_bytes(stages, *geom, vsize)


@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("stages", [1, 2])
@pytest.mark.parametrize("case", sorted(SPMM_SMEM_GEOMETRIES))
def test_quantised_panel_spmm_smem_matches_the_kernel(cuda, case, stages,
                                                      vsize):
    """The SpMM pair's ``panels_smem_bytes`` at 4-, 2- and 1-byte values is
    the kernel's own figure."""
    from repro_torch.kernels import _build
    geom = SPMM_SMEM_GEOMETRIES[case]
    lib = _build.load_library("spc5_spmm_desc")
    assert lib.spc5_spmm_desc_panels_smem(stages, *geom, vsize) == \
        KDM.panels_smem_bytes(stages, *geom, vsize)


@pytest.mark.parametrize("vdtype", ["f32", *QUANT_VDTYPES])
@pytest.mark.parametrize("kernel", QUANT_KERNELS)
def test_quantised_launch_refuses_a_wrong_smem_figure(cuda, monkeypatch,
                                                      kernel, vdtype):
    """At every value width, a launch handed a shared-memory figure 16
    bytes off the kernel's is refused (CUDA error 1) and not counted."""
    mod = KDM if kernel.startswith("spmm") else KD
    plan = _q_plan((4, 8), vdtype, cuda)
    real = mod.panels_launch

    def off(*args, **kw):
        launch = real(*args, **kw)
        return dict(launch, smem_bytes=launch["smem_bytes"] + 16)
    monkeypatch.setattr(mod, "panels_launch", off)
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _q_check(kernel, plan, _q_x(kernel, plan, cuda))
    assert mod.LAUNCHES == before


#: The whole-vector descriptor wrappers as a plan's entry points reach them:
#: (SpMM, double_buffer) -> wrapper. They raised "queue 2 A" for a quantised
#: store before their kernels took one.
_Q_WHOLE_ENTRY = {
    (False, True): "spmv_cuda_desc_db",
    (False, False): "spmv_cuda_desc",
    (True, True): "spmm_cuda_desc",
}


def _q_launches():
    return {**K.LAUNCHES, **KD.LAUNCHES, **KM.LAUNCHES, **KDM.LAUNCHES,
            **KT.LAUNCHES}


@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("case", sorted(_Q_WHOLE_ENTRY, key=str))
def test_quantised_whole_desc_plans_run_their_kernels(cuda, case, vdtype):
    """A quantised whole-vector descriptor plan through ``ops.spmv`` /
    ``ops.spmm`` launches its kernel once, and nothing else, and agrees
    with the plain version on the card."""
    spmm, db = case
    plan = ops.prepare(_matrix((4, 8)), layout="whole_vector",
                       lowering="descriptor", vdtype=vdtype, tune=False,
                       device=cuda, cb=16)
    x = (_xmat(plan.ncols, 16, 3, cuda) if spmm else
         _plan_x(plan, 3, cuda))
    plain = _qm_plain(plan, x)
    before = _q_launches()
    y = (ops.spmm if spmm else ops.spmv)(plan, x, double_buffer=db)
    torch.cuda.synchronize()
    after = _q_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {_Q_WHOLE_ENTRY[case]: 1}
    err = float((y - plain).abs().max())
    assert err <= RTOL * max(float(plain.abs().max()), 1.0)


@pytest.mark.parametrize("kernel", ["spmv_tail_cuda", "spmm_tail_cuda"])
def test_bf16_tail_buckets_run_the_tail_kernels(cuda, kernel):
    """A bf16 tail (the test layout's, as the reference stores it) on the
    card launches each tail kernel once and agrees with its plain version;
    an int8 plan's tail keeps f32, and int8 buckets are refused before any
    launch (a tail has no scale)."""
    mat = F.csr_to_spc5(matgen.powerlaw(320, 5, seed=17), 2, 4)
    geom = dict(layout="test", multi_layout="panels", lowering="descriptor",
                tune=False, pr=16, xw=32, cb=8)
    plan = ops.prepare(mat, vdtype="bf16", device=cuda, **geom)
    assert plan.single_values.dtype == torch.bfloat16 and plan.tail_pr
    assert ops.prepare(mat, vdtype="int8", device=cuda, **geom) \
        .single_values.dtype == torch.float32
    rows, cols, vals = (plan.single_rows, plan.single_cols,
                        plan.single_values)

    def run(v):
        if kernel == "spmv_tail_cuda":
            x = _ttail_x(plan.ncols, cuda)
            return KT.spmv_tail_cuda(
                plan.tail_xbase, rows, cols, v, x, pr=plan.tail_pr,
                xw=plan.tail_xw, nrows=plan.nrows,
                ncols_pad=plan.tail_ncols_pad), R.spmv_coo_panels(
                rows, cols, v, x, pr=plan.tail_pr, nrows=plan.nrows)
        x = _ttail_x((plan.ncols, 16), cuda)
        return KT.spmm_tail_cuda(rows, cols, v, x, pr=plan.tail_pr,
                                 nrows=plan.nrows), R.spmm_coo_panels(
            rows, cols, v, x, pr=plan.tail_pr, nrows=plan.nrows)
    before = _q_launches()
    y, plain = run(vals)
    torch.cuda.synchronize()
    after = _q_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {kernel: 1}
    _ttail_close(y, plain)
    with pytest.raises(ValueError, match="value_scale"):
        run(vals.float().round().to(torch.int8))
    assert _q_launches() == after


@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
def test_quantised_layer_on_the_card_matches_the_cpu_layer(cuda, vdtype):
    """``SparseLinear`` at a quantised vdtype on the card (panels +
    descriptor: the four kernels) against the same layer on the CPU (the
    plain versions), batch 1 and 16, bit-equal plans."""
    w = np.random.default_rng(5).standard_normal((600, 300)).astype(
        np.float32)
    kw = dict(density=0.2, block=(4, 8), vdtype=vdtype, layout="panels",
              lowering="descriptor", pr=64, xw=64, cb=8, tune=False)
    gpu = SparseLinear.from_dense(w, device=cuda, **kw)
    cpu = SparseLinear.from_dense(w, device="cpu", **kw)
    for a, b in zip(gpu.plan.arrays, cpu.plan.arrays):
        assert torch.equal(a.cpu(), b)
    x = np.random.default_rng(6).standard_normal((16, 300)).astype(np.float32)
    for xb in (x[:1], x):
        y = gpu(torch.from_numpy(xb).to(cuda)).cpu()
        y_ref = cpu(torch.from_numpy(xb))
        assert y.dtype == torch.float32
        err = float((y - y_ref).abs().max())
        assert err <= RTOL * max(float(y_ref.abs().max()), 1.0)


# ----------------------------------------------------------------------------
# quantised values (bf16, int8) in the seven mask kernels, and every narrow
# window's copy kept inside values
# ----------------------------------------------------------------------------

#: The mask wrappers that take quantised values: wrapper -> (module, layout).
QM_KERNELS = {"spmv_cuda": (K, "whole_vector"),
              "spmv_cuda_db": (K, "whole_vector"),
              "spmv_cuda_panels": (K, "panels"),
              "spmv_cuda_panels_db": (K, "panels"),
              "spmm_cuda": (KM, "whole_vector"),
              "spmm_cuda_panels": (KM, "panels"),
              "spmm_cuda_panels_db": (KM, "panels")}
QM_SPMM = ("spmm_cuda", "spmm_cuda_panels", "spmm_cuda_panels_db")


def _qm_plan(rc, vdtype, layout, device, lowering="mask", align=8, n=302,
             m=260, density=0.08, cb=8, mat=None):
    """A mask (or descriptor) plan at ``vdtype``: whole-vector cb 8, or
    panels of 64 rows (many chunks a panel)."""
    mat = _matrix(rc, n=n, m=m, density=density) if mat is None else mat
    geom = (dict(cb=cb) if layout == "whole_vector"
            else dict(pr=64, xw=64, cb=cb))
    return ops.prepare(mat, layout=layout, lowering=lowering, vdtype=vdtype,
                       tune=False, device=device, align=align, **geom)


def _qm_scale(plan):
    return plan.value_scale if plan.vdtype == "int8" else None


def _qm_plain(plan, x):
    """The plain version of the plan's product (upcast, then the int8
    scale) on the card."""
    scale, dev = _qm_scale(plan), plan.dev
    spmm = x.dim() == 2
    if plan.lowering == "descriptor" and plan.layout == "panels":
        fn = R.spmm_panels_desc if spmm else R.spmv_panels_desc
        return fn(dev, x, None, scale, pr=plan.pr, nrows=plan.nrows,
                  ncols_pad=plan.ncols_pad)
    if plan.lowering == "descriptor":
        fn = R.spmm_desc if spmm else R.spmv_desc
        return fn(dev, x, scale, nrows=plan.nrows)
    if plan.layout == "panels":
        fn = R.spmm_panels if spmm else R.spmv_panels
        return fn(dev, x, None, scale, r=plan.r, c=plan.c, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = R.spmm if spmm else R.spmv
    return fn(dev, x, scale, r=plan.r, c=plan.c, nrows=plan.nrows,
              ncols=plan.ncols)


def _qm_call(kernel, plan, x, values=None, **kw):
    """One call of wrapper ``kernel`` on the plan's arrays (``values`` in
    place of the plan's where given), counted once and held against the
    plain version."""
    mod = {**{k: v[0] for k, v in QM_KERNELS.items()},
           "spmv_cuda_panels_desc": KD, "spmv_cuda_panels_desc_db": KD,
           "spmm_cuda_panels_desc": KDM,
           "spmm_cuda_panels_desc_db": KDM, "spmv_cuda_desc": KD,
           "spmv_cuda_desc_db": KD, "spmm_cuda_desc": KDM}[kernel]
    vals = plan.values if values is None else values
    args = ((plan.chunk_vbase, plan.chunk_xbase) if plan.layout == "panels"
            else (plan.chunk_vbase,))
    if plan.lowering == "descriptor":
        args += (plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
                 plan.desc_yrow)
    else:
        args += (plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
                 plan.chunk_row)
    geom = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                nrows=plan.nrows)
    geom.update(dict(xw=plan.xw, pr=plan.pr, ncols_pad=plan.ncols_pad)
                if plan.layout == "panels" else dict(ncols=plan.ncols))
    plain = _qm_plain(plan, x)
    before = mod.LAUNCHES[kernel]
    # the whole-vector descriptor wrappers take no col_map
    col_map = () if (plan.lowering, plan.layout) == (
        "descriptor", "whole_vector") else (None,)
    y = getattr(mod, kernel)(*args, vals, x, *col_map, _qm_scale(plan),
                             **geom, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[kernel] == before + 1
    assert y.dtype == torch.float32 and y.shape == plain.shape
    assert torch.isfinite(y).all()
    ref = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(ref, 1.0), (err, ref, kw)
    return y


def _qm_x(kernel, plan, device, nvec=16, seed=31):
    if kernel.startswith("spmm"):
        return _xmat(plan.ncols, nvec, seed, device)
    return _x(plan, seed, device)


@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", sorted(QM_KERNELS))
def test_quantised_mask_block_shapes(cuda, kernel, vdtype, rc):
    """Each of the seven mask kernels at bf16 and int8 on every block shape,
    at the launch its wrapper plans (SpMM at nvec 16)."""
    plan = _qm_plan(rc, vdtype, QM_KERNELS[kernel][1], cuda)
    assert plan.values.dtype == {"bf16": torch.bfloat16,
                                 "int8": torch.int8}[vdtype]
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))


@pytest.mark.parametrize("force", ["one", "each_chunk"])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", sorted(QM_KERNELS))
def test_quantised_mask_forced_grids(cuda, kernel, vdtype, force):
    """G = 1 or S = 1, and one chunk a CTA (a whole-vector grid of every
    chunk, a panel split of every chunk of a panel)."""
    layout = QM_KERNELS[kernel][1]
    plan = _qm_plan((4, 8), vdtype, layout, cuda)
    n = int(plan.chunk_vbase.shape[-1])
    key = "grid" if layout == "whole_vector" else "split"
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda),
             **{key: 1 if force == "one" else n})


@pytest.mark.parametrize("nvec", [1, 2, 3, 5, 16, 100, 128, 256])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", QM_SPMM)
def test_quantised_mask_spmm_widths(cuda, kernel, vdtype, nvec):
    """The three mask SpMM kernels at nvec 1 to 256 (each a multiple of
    min(nvt, nvec), the reference's rule at nvt = 128)."""
    plan = _qm_plan((2, 4), vdtype, QM_KERNELS[kernel][1], cuda)
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda, nvec=nvec))


@pytest.mark.parametrize("align", [4, 8])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", sorted(QM_KERNELS))
def test_quantised_mask_windows_off_16_bytes(cuda, kernel, vdtype, align):
    """Value windows that start off a 16-byte boundary (int8 at align 8
    and 4, bf16 at align 4): the kernels stage the aligned span that covers
    a window and index into it."""
    plan = _qm_plan((2, 4), vdtype, QM_KERNELS[kernel][1], cuda, align=align)
    itemsize = plan.values.element_size()
    off = bool(((plan.chunk_vbase * itemsize) % 16 != 0).any())
    assert off == (vdtype == "int8" or align == 4)
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))


def test_quantised_mask_all_zero_chunks_take_scale_one(cuda):
    """Rows whose values are all zero (kept as nonzeros) make chunks of
    scale 1.0 in both layouts; every mask kernel gives their rows 0."""
    d = _dense((302, 260), 0.08, 29)
    csr = F.csr_from_dense(d)
    csr.values[:csr.rowptr[64]] = 0.0
    mat = F.csr_to_spc5(csr, 2, 4)
    for layout in ("whole_vector", "panels"):
        plan = _qm_plan((2, 4), "int8", layout, cuda, mat=mat)
        assert bool((plan.value_scale == 1.0).any())
        for kernel, (_, lay) in QM_KERNELS.items():
            if lay == layout:
                _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))


#: Every kernel that stages narrow windows: (layout, lowering).
QM_NARROW = {**{k: (v[1], "mask") for k, v in QM_KERNELS.items()},
             **{k: ("panels", "descriptor") for k in QUANT_KERNELS},
             **{k: ("whole_vector", "descriptor") for k in (
                 "spmv_cuda_desc", "spmv_cuda_desc_db", "spmm_cuda_desc")}}


def _qm_reaching_plan(vdtype, layout, lowering, device):
    """A plan (powerlaw, beta(4,8); bf16 at align 4) whose last window's
    16-byte aligned span reaches past ``values``, and that span's end."""
    vsize = 2 if vdtype == "bf16" else 1
    for seed in range(40):
        mat = F.csr_to_spc5(matgen.powerlaw(200 + 10 * seed, 5, seed=seed),
                            4, 8)
        plan = _qm_plan((4, 8), vdtype, layout, device, lowering=lowering,
                        align=4 if vdtype == "bf16" else 8, mat=mat)
        nvalues = plan.values.numel()
        ends = [K.value_span(vb, plan.vmax, vsize, nvalues)[2]
                for vb in plan.chunk_vbase.flatten().tolist()]
        if max(ends) > nvalues * vsize:
            return plan
    raise AssertionError("no plan's last span reaches past its values")


@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", sorted(QM_NARROW))
def test_narrow_span_at_the_end_of_exact_length_values(cuda, kernel, vdtype):
    """A plan whose last window's aligned span would reach 8 bytes past
    ``values``, its values copied into a tensor of exactly their length:
    each of the fourteen kernels that stage narrow windows (the seven mask
    kernels and the seven descriptor kernels) copies that window without
    its span's last 8 bytes and agrees with the plain version."""
    layout, lowering = QM_NARROW[kernel]
    plan = _qm_reaching_plan(vdtype, layout, lowering, cuda)
    exact = torch.empty(plan.values.numel(), dtype=plan.values.dtype,
                        device=cuda)
    exact.copy_(plan.values)
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda), values=exact)


def _qm_align4_plan(layout, lowering, device):
    """An int8 plan aligned to 4 values (powerlaw, beta(4,8)) whose values
    end 4 or 12 bytes past a 16-byte boundary and whose last window's span
    reaches past them."""
    for seed in range(40):
        mat = F.csr_to_spc5(matgen.powerlaw(200 + 10 * seed, 5, seed=seed),
                            4, 8)
        plan = _qm_plan((4, 8), "int8", layout, device, lowering=lowering,
                        align=4, mat=mat)
        nvalues = plan.values.numel()
        if nvalues % 8 and any(
                K.value_span(vb, plan.vmax, 1, nvalues)[2] > nvalues
                for vb in plan.chunk_vbase.flatten().tolist()):
            return plan
    raise AssertionError("no int8 align-4 plan's span reaches past values")


@pytest.mark.parametrize("kernel", sorted(QM_NARROW))
def test_int8_align4_span_at_the_end_of_exact_length_values(cuda, kernel):
    """An int8 plan aligned to 4 values whose last window's span would
    reach past ``values``, which end 4 or 12 bytes past a 16-byte boundary,
    its values copied into a tensor of exactly their length: each of the
    fourteen narrow-window kernels copies that window up to values' end (a
    4-byte piece after any 8-byte one) and agrees with the plain
    version."""
    layout, lowering = QM_NARROW[kernel]
    plan = _qm_align4_plan(layout, lowering, cuda)
    exact = torch.empty(plan.values.numel(), dtype=plan.values.dtype,
                        device=cuda)
    exact.copy_(plan.values)
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda), values=exact)


def _qm_launch_name(kernel):
    """The module attribute a mask wrapper plans its launch with."""
    layout = QM_KERNELS[kernel][1]
    return "panels_launch" if layout == "panels" else "whole_launch"


@pytest.mark.parametrize("vdtype", ["f32", *QUANT_VDTYPES])
@pytest.mark.parametrize("kernel", sorted(QM_KERNELS))
def test_quantised_mask_launch_refuses_a_wrong_smem_figure(cuda, monkeypatch,
                                                           kernel, vdtype):
    """At every value width, a launch handed a shared-memory figure 16
    bytes off the kernel's is refused (CUDA error 1) and not counted."""
    mod, layout = QM_KERNELS[kernel]
    plan = _qm_plan((4, 8), vdtype, layout, cuda)
    name = _qm_launch_name(kernel)
    real = getattr(mod, name)

    def off(*args, **kw):
        launch = real(*args, **kw)
        return dict(launch, smem_bytes=launch["smem_bytes"] + 16)
    monkeypatch.setattr(mod, name, off)
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("kernel", sorted(QM_KERNELS))
def test_int8_mask_launch_refuses_no_scales(cuda, monkeypatch, kernel):
    """An int8 launch handed no scale pointer is refused by the launcher
    (CUDA error 1) and not counted."""
    mod, layout = QM_KERNELS[kernel]
    plan = _qm_plan((4, 8), "int8", layout, cuda)
    monkeypatch.setattr(mod, "_scale_ptr", lambda scale: 0)
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("layout", ["spmv_panels", "spmv_whole",
                                    "spmm_panels", "spmm_whole"])
def test_quantised_mask_smem_matches_the_kernel(cuda, layout, vsize):
    """Each mask wrapper's shared-memory formula at 4-, 2- and 1-byte values
    is the figure its kernel's own layout gives, on the geometries of the
    f32 tests above."""
    from repro_torch.kernels import _build
    spmv = _build.load_library("spc5_spmv")
    spmm = _build.load_library("spc5_spmm")
    if layout == "spmv_panels":
        for geom in MASK_SMEM_GEOMETRIES.values():
            for stages in (1, 2, 3):
                assert spmv.spc5_spmv_panels_smem(stages, *geom, vsize) == \
                    K.panels_smem_bytes(stages, *geom, vsize)
    elif layout == "spmv_whole":
        for geom in WHOLE_MASK_SMEM_GEOMETRIES.values():
            for stages in (1, 2):
                assert spmv.spc5_spmv_whole_smem(stages, *geom, vsize) == \
                    K.whole_smem_bytes(stages, *geom, vsize)
    elif layout == "spmm_panels":
        for geom in MASK_SPMM_SMEM_GEOMETRIES.values():
            for stages in (1, 2):
                assert spmm.spc5_spmm_panels_smem(stages, *geom, vsize) == \
                    KM.panels_smem_bytes(stages, *geom, vsize)
    else:
        for geom in WHOLE_SPMM_SMEM_GEOMETRIES.values():
            assert spmm.spc5_spmm_whole_smem(*geom, vsize) == \
                KM.whole_smem_bytes(*geom, vsize)


#: The mask wrappers as a plan's entry points reach them, each with a
#: quantised plan: (layout, SpMM, double_buffer) -> wrapper.
_QM_ENTRY = {
    ("whole_vector", False, True): "spmv_cuda_db",
    ("whole_vector", False, False): "spmv_cuda",
    ("panels", False, True): "spmv_cuda_panels_db",
    ("panels", False, False): "spmv_cuda_panels",
    ("whole_vector", True, True): "spmm_cuda",
    ("panels", True, True): "spmm_cuda_panels_db",
    ("panels", True, False): "spmm_cuda_panels",
}


@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("case", sorted(_QM_ENTRY, key=str))
def test_quantised_mask_plans_run_their_kernels(cuda, case, vdtype):
    """A quantised mask plan through ``ops.spmv`` / ``ops.spmm`` launches
    its kernel once, and nothing else, and agrees with the plain version
    (these entry points raised "queue 2 A" before the mask kernels took
    quantised values)."""
    layout, spmm, db = case
    plan = ops.prepare(_matrix((4, 8)), layout=layout, lowering="mask",
                       vdtype=vdtype, tune=False, device=cuda, **(
                           {"cb": 16} if layout == "whole_vector"
                           else {"pr": 64, "xw": 64, "cb": 16}))
    x = _xmat(plan.ncols, 16, 3, cuda) if spmm else _x(plan, 3, cuda)
    plain = _qm_plain(plan, x)
    before = _q_launches()
    y = (ops.spmm if spmm else ops.spmv)(plan, x, double_buffer=db)
    torch.cuda.synchronize()
    after = _q_launches()
    assert {k: after[k] - before[k] for k in after
            if after[k] != before[k]} == {_QM_ENTRY[case]: 1}
    err = float((y - plain).abs().max())
    assert err <= RTOL * max(float(plain.abs().max()), 1.0)


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
def test_quantised_mask_layer_on_the_card_matches_the_cpu_layer(cuda, vdtype,
                                                                layout):
    """``SparseLinear`` at a quantised vdtype with the mask lowering on the
    card (whole-vector: ``spmv_cuda_db`` / ``spmm_cuda``; panels:
    ``spmv_cuda_panels_db`` / ``spmm_cuda_panels_db``) against the same
    layer on the CPU (the plain versions), batch 1 and 16, bit-equal
    plans."""
    w = np.random.default_rng(7).standard_normal((600, 300)).astype(
        np.float32)
    geom = dict(cb=8) if layout == "whole_vector" else dict(pr=64, xw=64,
                                                            cb=8)
    kw = dict(density=0.2, block=(4, 8), vdtype=vdtype, layout=layout,
              lowering="mask", tune=False, **geom)
    gpu = SparseLinear.from_dense(w, device=cuda, **kw)
    cpu = SparseLinear.from_dense(w, device="cpu", **kw)
    for a, b in zip(gpu.plan.arrays, cpu.plan.arrays):
        assert torch.equal(a.cpu(), b)
    x = np.random.default_rng(8).standard_normal((16, 300)).astype(np.float32)
    before = _q_launches()
    for xb in (x[:1], x):
        y = gpu(torch.from_numpy(xb).to(cuda)).cpu()
        y_ref = cpu(torch.from_numpy(xb))
        assert y.dtype == torch.float32
        err = float((y - y_ref).abs().max())
        assert err <= RTOL * max(float(y_ref.abs().max()), 1.0)
    after = _q_launches()
    ran = {k for k in after if after[k] != before[k]}
    assert ran == ({"spmv_cuda_db", "spmm_cuda"} if layout == "whole_vector"
                   else {"spmv_cuda_panels_db", "spmm_cuda_panels_db"})


# ----------------------------------------------------------------------------
# quantised values (bf16, int8) in the three whole-vector descriptor kernels
# and bf16 values in both tail kernels
# ----------------------------------------------------------------------------

#: The whole-vector descriptor wrappers: wrapper -> module.
QW_KERNELS = {"spmv_cuda_desc": KD, "spmv_cuda_desc_db": KD,
              "spmm_cuda_desc": KDM}


def _qw_plan(rc, vdtype, device, **kw):
    """A whole-vector descriptor plan at ``vdtype`` (302 x 260, cb 8: many
    chunks)."""
    return _qm_plan(rc, vdtype, "whole_vector", device, lowering="descriptor",
                    **kw)


@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", sorted(QW_KERNELS))
def test_quantised_whole_desc_block_shapes(cuda, kernel, vdtype, rc):
    """Each whole-vector descriptor kernel at bf16 and int8 on every block
    shape, at the launch its wrapper plans (SpMM at nvec 16)."""
    plan = _qw_plan(rc, vdtype, cuda)
    assert plan.values.dtype == {"bf16": torch.bfloat16,
                                 "int8": torch.int8}[vdtype]
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))


@pytest.mark.parametrize("force", ["one", "each_chunk", "ragged"])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", sorted(QW_KERNELS))
def test_quantised_whole_desc_forced_grids(cuda, kernel, vdtype, force):
    """G = 1, one chunk a CTA, and a G that does not divide the chunks."""
    plan = _qw_plan((4, 8), vdtype, cuda)
    n = int(plan.chunk_vbase.shape[0])
    grid = {"one": 1, "each_chunk": n, "ragged": max(2, n // 3 + 1)}[force]
    _qm_call(kernel, plan, _qm_x(kernel, plan, cuda), grid=grid)


@pytest.mark.parametrize("nvec", [1, 2, 3, 5, 16, 100, 128, 256])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
def test_quantised_whole_desc_spmm_widths(cuda, vdtype, nvec):
    """``spmm_cuda_desc`` at nvec 1 to 256 (each a multiple of min(nvt,
    nvec), the reference's rule at nvt = 128)."""
    plan = _qw_plan((2, 4), vdtype, cuda)
    _qm_call("spmm_cuda_desc", plan, _qm_x("spmm_cuda_desc", plan, cuda,
                                           nvec=nvec))


@pytest.mark.parametrize("align", [4, 8])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", sorted(QW_KERNELS))
def test_quantised_whole_desc_windows_off_16_bytes(cuda, kernel, vdtype,
                                                   align):
    """Value windows that start off a 16-byte boundary (int8 at align 8
    and 4, bf16 at align 4): the kernels stage the aligned span that covers
    a window and index into it, at G = 1 and at the planned G."""
    plan = _qw_plan((2, 4), vdtype, cuda, align=align)
    itemsize = plan.values.element_size()
    off = bool(((plan.chunk_vbase * itemsize) % 16 != 0).any())
    assert off == (vdtype == "int8" or align == 4)
    x = _qm_x(kernel, plan, cuda)
    for grid in (None, 1):
        _qm_call(kernel, plan, x, **({} if grid is None else {"grid": grid}))


@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
def test_quantised_whole_desc_sliced_stages(cuda, vdtype):
    """Chunks whose stage does not fit a CTA at any width (1,280 full
    beta(4,8) blocks, int32 vidx): the synchronous SpMV kernel stages the
    tables in slices of fewer blocks with the window (and its offset and
    scale) staged once a chunk, at its G, one CTA and one chunk a CTA; the
    SpMM kernel rounds of slices; the ring refuses and launches nothing."""
    mat = F.csr_to_spc5(F.csr_from_dense(_dense((64, 4_096), 1.0, 24)), 4, 8)
    plan = ops.prepare(mat, layout="whole_vector", lowering="descriptor",
                       vdtype=vdtype, tune=False, device=cuda, cb=1_280,
                       align=4 if vdtype == "bf16" else 8)
    assert plan.desc_vidx.dtype == torch.int32 and _chunks(plan) >= 2
    launch = KD.whole_launch(1, _chunks(plan), cb=plan.cb, r=4, c=8,
                             vmax=plan.vmax, wv=4, wx=2, device=cuda,
                             vsize=plan.values.element_size())
    assert launch["blocks_per_stage"] < plan.cb
    x = _plan_x(plan, 25, cuda)
    for grid in (None, 1, _chunks(plan)):
        _qm_call("spmv_cuda_desc", plan, x, **(
            {} if grid is None else {"grid": grid}))
    _qm_call("spmm_cuda_desc", plan, _xmat(plan.ncols, 16, 26, cuda))
    before = dict(KD.LAUNCHES)
    with pytest.raises(ValueError, match="shared memory"):
        ops.spmv(plan, x)
    assert KD.LAUNCHES == before


def test_quantised_whole_desc_all_zero_chunks_take_scale_one(cuda):
    """Rows whose values are all zero (kept as nonzeros) make chunks of
    scale 1.0; every whole-vector descriptor kernel gives their rows 0."""
    d = _dense((302, 260), 0.08, 29)
    csr = F.csr_from_dense(d)
    csr.values[:csr.rowptr[64]] = 0.0
    plan = _qw_plan((2, 4), "int8", cuda, mat=F.csr_to_spc5(csr, 2, 4))
    live = plan.desc_valid.reshape(_chunks(plan), -1).any(-1)
    assert bool(((plan.value_scale == 1.0) & live).any())
    for kernel in QW_KERNELS:
        _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))


@pytest.mark.parametrize("vdtype", ["f32", *QUANT_VDTYPES])
@pytest.mark.parametrize("kernel", sorted(QW_KERNELS))
def test_quantised_whole_desc_launch_refuses_a_wrong_smem_figure(
        cuda, monkeypatch, kernel, vdtype):
    """At every value width, a launch handed a shared-memory figure 16
    bytes off the kernel's is refused (CUDA error 1) and not counted."""
    mod = QW_KERNELS[kernel]
    plan = _qw_plan((4, 8), vdtype, cuda)
    real = mod.whole_launch

    def off(*args, **kw):
        launch = real(*args, **kw)
        return dict(launch, smem_bytes=launch["smem_bytes"] + 16)
    monkeypatch.setattr(mod, "whole_launch", off)
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("kernel", sorted(QW_KERNELS))
def test_int8_whole_desc_launch_refuses_no_scales(cuda, monkeypatch, kernel):
    """An int8 launch handed no scale pointer is refused by the launcher
    (CUDA error 1) and not counted."""
    mod = QW_KERNELS[kernel]
    plan = _qw_plan((4, 8), "int8", cuda)
    monkeypatch.setattr(K, "_scale_ptr", lambda scale: 0)
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _qm_call(kernel, plan, _qm_x(kernel, plan, cuda))
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("vsize", [4, 2, 1])
def test_quantised_whole_desc_smem_matches_the_kernel(cuda, vsize):
    """Both whole-vector descriptor wrappers' shared-memory formulas at 4-,
    2- and 1-byte values are the figures their kernels' own layouts give,
    on the geometries of the f32 tests above."""
    from repro_torch.kernels import _build
    spmv = _build.load_library("spc5_spmv_desc")
    spmm = _build.load_library("spc5_spmm_desc")
    for geom in WHOLE_SMEM_GEOMETRIES.values():
        for stages in (1, 2):
            assert spmv.spc5_spmv_desc_whole_smem(stages, *geom, vsize) == \
                KD.whole_smem_bytes(stages, *geom, vsize)
    for geom in WHOLE_SPMM_SMEM_GEOMETRIES.values():
        head, tail = geom[:6], geom[6:]
        for widths in ((2, 2), (4, 1)):
            assert spmm.spc5_spmm_desc_whole_smem(*head, *widths, *tail,
                                                  vsize) == \
                KDM.whole_smem_bytes(*head, *widths, *tail, vsize)


@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
def test_quantised_token_layer_on_the_card_matches_the_cpu_layer(cuda,
                                                                 vdtype):
    """A whole-vector descriptor ``SparseLinear`` at a quantised vdtype on
    the card (``spmv_cuda_desc_db`` / ``spmm_cuda_desc``) against the same
    layer on the CPU (the plain versions), batch 1 and 16, bit-equal
    plans."""
    w = np.random.default_rng(9).standard_normal((600, 300)).astype(
        np.float32)
    kw = dict(density=0.2, block=(4, 8), vdtype=vdtype, layout="whole_vector",
              lowering="descriptor", cb=8, tune=False)
    gpu = SparseLinear.from_dense(w, device=cuda, **kw)
    cpu = SparseLinear.from_dense(w, device="cpu", **kw)
    for a, b in zip(gpu.plan.arrays, cpu.plan.arrays):
        assert torch.equal(a.cpu(), b)
    x = np.random.default_rng(10).standard_normal((16, 300)).astype(
        np.float32)
    before = _q_launches()
    for xb in (x[:1], x):
        y = gpu(torch.from_numpy(xb).to(cuda)).cpu()
        y_ref = cpu(torch.from_numpy(xb))
        assert y.dtype == torch.float32
        err = float((y - y_ref).abs().max())
        assert err <= RTOL * max(float(y_ref.abs().max()), 1.0)
    after = _q_launches()
    assert {k for k in after if after[k] != before[k]} == {
        "spmv_cuda_desc_db", "spmm_cuda_desc"}


def _qt_plan(case, rc, cuda):
    """The bf16 test plan of a TAIL_CASES geometry on the card."""
    csr, geom = TAIL_CASES[case]
    plan = ops.prepare(F.csr_to_spc5(csr(), *rc), layout="test",
                       multi_layout="panels", lowering="mask", tune=False,
                       vdtype="bf16", device=cuda, **geom)
    if not plan.n_single:
        pytest.skip(f"no singleton blocks in beta{rc} for {case}")
    assert plan.single_values.dtype == torch.bfloat16
    return plan


@pytest.mark.parametrize("case", TAIL_CASES)
@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
def test_bf16_tail_kernels_match_plain(cuda, rc, case):
    """Both tail kernels on bf16 buckets of every block shape and bucket
    geometry, at their planned launch (SpMM at nvec 1, 3, 16 and 128)."""
    plan = _qt_plan(case, rc, cuda)
    _ttail_close(*_ttail_spmv(plan, _ttail_x(plan.ncols, cuda)))
    for nvec in (1, 3, 16, 128):
        _ttail_close(*_ttail_spmm(plan, _ttail_x((plan.ncols, nvec), cuda)))


@pytest.mark.parametrize("case", TAIL_CASES)
def test_bf16_tail_kernels_at_forced_grids(cuda, case):
    """S = 1 and one group a CTA (SpMV); G = 1 and one group a CTA (SpMM,
    nvec 16 and 128), on bf16 buckets."""
    plan = _qt_plan(case, (2, 4), cuda)
    x = _ttail_x(plan.ncols, cuda)
    for split in (1, KT.tail_groups(plan.single_rows.shape[1])):
        _ttail_close(*_ttail_spmv(plan, x, split=split))
    for nvec in (16, 128):
        xm = _ttail_x((plan.ncols, nvec), cuda)
        for grid in (1, KT.tail_groups(plan.single_rows.numel())):
            _ttail_close(*_ttail_spmm(plan, xm, grid=grid))


@pytest.mark.parametrize("shift", [1, 4])
@pytest.mark.parametrize("case", TAIL_CASES)
def test_bf16_tail_kernels_on_misaligned_buckets(cuda, case, shift):
    """bf16 buckets one slot off (2-byte values: 2-byte loads and staging)
    and four slots off (the rows and columns 16-byte aligned, the values
    only 8: the 8-byte paths), and permuted buckets."""
    plan = _qt_plan(case, (2, 4), cuda)
    shape = plan.single_rows.shape

    def shifted(a):
        out = torch.empty(a.numel() + shift, dtype=a.dtype, device=a.device)
        out[shift:] = a.reshape(-1)
        return out[shift:].view(shape)
    rows, cols, vals = (shifted(a) for a in (
        plan.single_rows, plan.single_cols, plan.single_values))
    assert (vals.data_ptr() % 8 == 0) == (shift == 4)
    x = _ttail_x(plan.ncols, cuda)
    args, kw = _tail_args(plan)
    y = KT.spmv_tail_cuda(args[0], rows, cols, vals, x, **kw)
    _ttail_close(y, R.spmv_coo_panels(rows, cols, vals, x, pr=plan.tail_pr,
                                      nrows=plan.nrows))
    perm = torch.from_numpy(np.stack([
        np.random.default_rng(12 + p).permutation(shape[1])
        for p in range(shape[0])])).to(cuda)
    moved = tuple(a.gather(1, perm).contiguous() for a in (rows, cols, vals))
    for nvec in (1, 16, 128):
        xm = _ttail_x((plan.ncols, nvec), cuda)
        _ttail_close(*_ttail_spmm(plan, xm, buckets=(rows, cols, vals)))
        _ttail_close(*_ttail_spmm(plan, xm, buckets=moved))


def test_bf16_tail_launchers_refuse_other_plans(cuda):
    """At bf16 each tail launcher refuses another shared-memory figure (the
    SpMV kernel any but 0, the SpMM kernel the f32 CTA's), and both refuse
    a value width they are not built for (int8)."""
    import ctypes

    from repro_torch.kernels import _build
    lib = _build.load_library("spc5_spmv_tail")
    plan = _qt_plan("powerlaw", (2, 4), cuda)
    (xbase, rows, cols, vals), _ = _tail_args(plan)
    npanels, smax = rows.shape
    x = _ttail_x(plan.ncols, cuda)
    y = torch.zeros(plan.nrows, device=cuda)
    launch = KT.tail_launch(npanels, smax, device=cuda, vsize=2)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    dev = cuda.index or 0

    def spmv(vsize, smem):
        return lib.spc5_spmv_tail(
            xbase.data_ptr(), rows.data_ptr(), cols.data_ptr(),
            vals.data_ptr(), x.data_ptr(), y.data_ptr(), npanels, smax,
            plan.tail_pr, plan.tail_xw, plan.nrows, plan.ncols, vsize,
            launch["split"], launch["threads"], smem, dev, stream)
    assert spmv(2, 0) == 0
    assert spmv(2, 16) == 1 and spmv(1, 0) == 1
    xm = _ttail_x((plan.ncols, 16), cuda)
    ym = torch.zeros(plan.nrows, 16, device=cuda)
    m = KT.spmm_tail_launch(npanels * smax, 16, 4, device=cuda, vsize=2)
    f32 = KT.spmm_tail_smem_bytes(m["tile_columns"], m["vector"],
                                  m["tile_rows"], m["threads"])
    assert lib.spc5_spmm_tail_smem(m["tile_columns"], m["vector"],
                                   m["tile_rows"], m["threads"], 2) == \
        m["smem_bytes"] == f32 - 8 * m["threads"]

    def spmm(vsize, smem):
        return lib.spc5_spmm_tail(
            rows.data_ptr(), cols.data_ptr(), vals.data_ptr(), xm.data_ptr(),
            ym.data_ptr(), npanels, smax, plan.tail_pr, plan.nrows,
            plan.ncols, 16, m["tile_columns"], m["vector"], vsize, m["grid"],
            m["tile_rows"], m["threads"], smem, dev, stream)
    assert spmm(2, m["smem_bytes"]) == 0
    assert spmm(2, f32) == 1 and spmm(1, m["smem_bytes"]) == 1
    torch.cuda.synchronize()
    out = (ctypes.c_int * 2)()
    assert lib.spc5_spmv_tail_occupancy(1, 256, dev,
                                        ctypes.addressof(out)) == 1
    assert lib.spc5_spmm_tail_occupancy(1, 4, 256, 1024, dev,
                                        ctypes.addressof(out)) == 1
    assert lib.spc5_spmm_tail_occupancy(2, 4, 256, m["smem_bytes"], dev,
                                        ctypes.addressof(out)) == 0


@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("multi_layout", ["whole_vector", "panels"])
def test_bf16_test_plan_on_the_card_matches_the_cpu_plan(cuda, multi_layout,
                                                         lowering):
    """A bf16 test plan (bf16 multi and tail) on the card against the same
    plan on the CPU, SpMV and SpMM: a panel multi runs both tail kernels on
    its bf16 buckets, a whole-vector multi the plain flat tail."""
    mat = F.csr_to_spc5(matgen.powerlaw(2_000, 6, seed=9), 2, 4)
    kw = dict(layout="test", multi_layout=multi_layout, lowering=lowering,
              vdtype="bf16", tune=False, pr=64, xw=64, cb=16)
    card = ops.prepare(mat, device=cuda, **kw)
    cpu = ops.prepare(mat, device="cpu", **kw)
    assert card.single_values.dtype == torch.bfloat16
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
    assert KT.LAUNCHES["spmm_tail_cuda"] == (multi_layout == "panels")


# ----------------------------------------------------------------------------
# column maps (a reordered plan's fused column permutation) in the four
# panel descriptor kernels, and the mask wrappers' refusal of a map
# ----------------------------------------------------------------------------

CM_KERNELS = QUANT_KERNELS
CM_VDTYPES = ("f32", *QUANT_VDTYPES)


def _cm_plan(rc, vdtype, device, align=8, n=302, m=700, density=0.05, cb=4):
    """A panel descriptor plan (panels of 64 rows, windows of 64 columns,
    cb 4) at ``vdtype`` whose 700 columns are not a multiple of the window:
    the last chunks' windows reach columns at or past ncols."""
    plan = _q_plan(rc, vdtype, device, align=align, n=n, m=m,
                   density=density, cb=cb)
    assert plan.ncols % plan.xw != 0 and plan.ncols_pad > plan.ncols
    return plan


def _cm_map(ncols, device, seed=41):
    return torch.from_numpy(np.random.default_rng(seed).permutation(
        ncols).astype(np.int32)).to(device)


def _cm_call(kernel, plan, x, cmap, values=None, **kw):
    """One call of a panel descriptor wrapper with a column map: counted
    once as ``<kernel>_cmap`` (its no-map count unchanged) and held against
    the plain version with the same map."""
    spmm = kernel.startswith("spmm")
    mod = KDM if spmm else KD
    scale = plan.value_scale if plan.vdtype == "int8" else None
    vals = plan.values if values is None else values
    fn = R.spmm_panels_desc if spmm else R.spmv_panels_desc
    plain = fn(plan.dev, x, cmap, scale, pr=plan.pr, nrows=plan.nrows,
               ncols_pad=plan.ncols_pad)
    before = dict(mod.LAUNCHES)
    y = getattr(mod, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid, plan.desc_vidx,
        plan.desc_xcol, plan.desc_yrow, vals, x, cmap, scale, r=plan.r,
        c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr,
        nrows=plan.nrows, ncols_pad=plan.ncols_pad, **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == {**before, f"{kernel}_cmap":
                            before[f"{kernel}_cmap"] + 1}
    assert y.dtype == torch.float32 and y.shape == plain.shape
    assert torch.isfinite(y).all()
    ref = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(ref, 1.0), (err, ref, kw)
    return y


@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("vdtype", CM_VDTYPES)
@pytest.mark.parametrize("kernel", CM_KERNELS)
def test_cmap_panel_desc_block_shapes(cuda, kernel, vdtype, rc):
    """Each of the four map kernels at f32, bf16 and int8 on every block
    shape, at the split its wrapper picks (SpMM at nvec 16), with a random
    permutation as the map."""
    plan = _cm_plan(rc, vdtype, cuda)
    _cm_call(kernel, plan, _q_x(kernel, plan, cuda), _cm_map(plan.ncols, cuda))


@pytest.mark.parametrize("split", ["one", "each_chunk"])
@pytest.mark.parametrize("vdtype", CM_VDTYPES)
@pytest.mark.parametrize("kernel", CM_KERNELS)
def test_cmap_forced_grids(cuda, kernel, vdtype, split):
    """S = 1 and one chunk a CTA (S = nchunks)."""
    plan = _cm_plan((4, 8), vdtype, cuda)
    s = 1 if split == "one" else plan.nchunks
    _cm_call(kernel, plan, _q_x(kernel, plan, cuda),
             _cm_map(plan.ncols, cuda), split=s)


@pytest.mark.parametrize("nvec", [3, 16, 128])
@pytest.mark.parametrize("vdtype", CM_VDTYPES)
@pytest.mark.parametrize("kernel", CM_KERNELS[2:])
def test_cmap_spmm_widths(cuda, kernel, vdtype, nvec):
    plan = _cm_plan((2, 4), vdtype, cuda)
    _cm_call(kernel, plan, _q_x(kernel, plan, cuda, nvec=nvec),
             _cm_map(plan.ncols, cuda))


@pytest.mark.parametrize("kernel", CM_KERNELS)
def test_cmap_identity_map_matches_the_kernel_without_one(cuda, kernel):
    """With the identity as the map, a map kernel computes what its twin
    without a map computes (x padded by the wrapper there, read in place
    here)."""
    plan = _cm_plan((2, 4), "f32", cuda)
    x = _q_x(kernel, plan, cuda)
    ident = torch.arange(plan.ncols, dtype=torch.int32, device=cuda)
    y = _cm_call(kernel, plan, x, ident)
    mod = KDM if kernel.startswith("spmm") else KD
    y0 = getattr(mod, kernel)(
        plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid, plan.desc_vidx,
        plan.desc_xcol, plan.desc_yrow, plan.values, x, r=plan.r, c=plan.c,
        cb=plan.cb, vmax=plan.vmax, xw=plan.xw, pr=plan.pr, nrows=plan.nrows,
        ncols_pad=plan.ncols_pad)
    assert float((y - y0).abs().max()) <= RTOL * float(y0.abs().max())


@pytest.mark.parametrize("kernel", CM_KERNELS)
def test_cmap_int8_span_at_the_end_of_exact_length_values(cuda, kernel):
    """An int8 plan aligned to 4 values whose last window's span would
    reach past its values (copied into a tensor of exactly their length),
    with a map."""
    plan = _qm_align4_plan("panels", "descriptor", cuda)
    exact = torch.empty(plan.values.numel(), dtype=plan.values.dtype,
                        device=cuda)
    exact.copy_(plan.values)
    _cm_call(kernel, plan, _q_x(kernel, plan, cuda),
             _cm_map(plan.ncols, cuda), values=exact)


# ----------------------------------------------------------------------------
# column maps in the seven mask kernels: each wrapper given a map on the card
# launches its twin (counted as <wrapper>_cmap), which reads x / X in the
# original column order at col_map[j] for a set lane of permuted column j
# ----------------------------------------------------------------------------

MCM_KERNELS = sorted(QM_KERNELS)
MCM_VDTYPES = ("f32", *QUANT_VDTYPES)


def _mcm_plain(plan, x, cmap):
    """The plain version of a mask plan's product with column map ``cmap``
    (the panel layout maps each column through it, :func:`R.pad_cmap`; the
    whole-vector one reads ``x[cmap]``)."""
    scale, dev = _qm_scale(plan), plan.dev
    spmm = x.dim() == 2
    if plan.layout == "panels":
        fn = R.spmm_panels if spmm else R.spmv_panels
        return fn(dev, x, cmap, scale, r=plan.r, c=plan.c, pr=plan.pr,
                  nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = R.spmm if spmm else R.spmv
    return fn(dev, x.index_select(0, cmap), scale, r=plan.r, c=plan.c,
              nrows=plan.nrows, ncols=plan.ncols)


def _mcm_call(kernel, plan, x, cmap, values=None, **kw):
    """One call of mask wrapper ``kernel`` with a column map: counted once
    as ``<kernel>_cmap`` (every other count unchanged) and held against the
    plain version with the same map."""
    mod, layout = QM_KERNELS[kernel]
    vals = plan.values if values is None else values
    args = ((plan.chunk_vbase, plan.chunk_xbase) if layout == "panels"
            else (plan.chunk_vbase,)) + (plan.chunk_col, plan.chunk_mask,
                                         plan.chunk_voff, plan.chunk_row)
    geom = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
                nrows=plan.nrows)
    geom.update(dict(xw=plan.xw, pr=plan.pr, ncols_pad=plan.ncols_pad)
                if layout == "panels" else dict(ncols=plan.ncols))
    plain = _mcm_plain(plan, x, cmap)
    before = dict(mod.LAUNCHES)
    y = getattr(mod, kernel)(*args, vals, x, cmap, _qm_scale(plan), **geom,
                             **kw)
    torch.cuda.synchronize()
    assert mod.LAUNCHES == {**before, f"{kernel}_cmap":
                            before[f"{kernel}_cmap"] + 1}
    assert y.dtype == torch.float32 and y.shape == plain.shape
    assert torch.isfinite(y).all()
    ref = float(plain.abs().max()) if plain.numel() else 0.0
    err = float((y - plain).abs().max()) if y.numel() else 0.0
    assert err <= RTOL * max(ref, 1.0), (err, ref, kw)
    return y


def _mcm_plan(rc, vdtype, kernel, device, **kw):
    """A mask plan of the kernel's layout at ``vdtype`` (302 x 260; panels
    of 64 rows and windows of 64 columns, so the last windows reach columns
    at or past ncols)."""
    plan = _qm_plan(rc, vdtype, QM_KERNELS[kernel][1], device, **kw)
    if plan.layout == "panels":
        assert plan.ncols % plan.xw != 0 and plan.ncols_pad > plan.ncols
    return plan


@pytest.mark.parametrize("rc", F.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("vdtype", MCM_VDTYPES)
@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_cmap_block_shapes(cuda, kernel, vdtype, rc):
    """Each of the seven mask twins at f32, bf16 and int8 on every block
    shape, at the launch its wrapper plans (SpMM at nvec 16), with a random
    permutation as the map."""
    plan = _mcm_plan(rc, vdtype, kernel, cuda)
    _mcm_call(kernel, plan, _qm_x(kernel, plan, cuda),
              _cm_map(plan.ncols, cuda))


@pytest.mark.parametrize("force", ["one", "each_chunk", "ragged"])
@pytest.mark.parametrize("vdtype", MCM_VDTYPES)
@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_cmap_forced_grids(cuda, kernel, vdtype, force):
    """G = 1 or S = 1, one chunk a CTA, and a grid that cuts the chunks
    into ranges of unequal length."""
    plan = _mcm_plan((4, 8), vdtype, kernel, cuda)
    n = int(plan.chunk_vbase.shape[-1])
    key = "grid" if plan.layout == "whole_vector" else "split"
    g = {"one": 1, "each_chunk": n, "ragged": max(1, n // 2 - 1)}[force]
    _mcm_call(kernel, plan, _qm_x(kernel, plan, cuda),
              _cm_map(plan.ncols, cuda), **{key: g})


@pytest.mark.parametrize("nvec", [1, 2, 3, 16, 100, 128, 256])
@pytest.mark.parametrize("vdtype", MCM_VDTYPES)
@pytest.mark.parametrize("kernel", QM_SPMM)
def test_mask_cmap_spmm_widths(cuda, kernel, vdtype, nvec):
    """The three mask SpMM twins at nvec 1 to 256."""
    plan = _mcm_plan((2, 4), vdtype, kernel, cuda)
    _mcm_call(kernel, plan, _qm_x(kernel, plan, cuda, nvec=nvec),
              _cm_map(plan.ncols, cuda))


@pytest.mark.parametrize("align", [4, 8])
@pytest.mark.parametrize("vdtype", QUANT_VDTYPES)
@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_cmap_windows_off_16_bytes(cuda, kernel, vdtype, align):
    """Narrow value windows that start off a 16-byte boundary, with a
    map."""
    plan = _mcm_plan((2, 4), vdtype, kernel, cuda, align=align)
    itemsize = plan.values.element_size()
    assert bool(((plan.chunk_vbase * itemsize) % 16 != 0).any()) == (
        vdtype == "int8" or align == 4)
    _mcm_call(kernel, plan, _qm_x(kernel, plan, cuda),
              _cm_map(plan.ncols, cuda))


@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_cmap_int8_span_at_the_end_of_exact_length_values(cuda, kernel):
    """An int8 plan aligned to 4 values whose last window's span would
    reach past its values (copied into a tensor of exactly their length),
    with a map."""
    plan = _qm_align4_plan(QM_KERNELS[kernel][1], "mask", cuda)
    exact = torch.empty(plan.values.numel(), dtype=plan.values.dtype,
                        device=cuda)
    exact.copy_(plan.values)
    _mcm_call(kernel, plan, _qm_x(kernel, plan, cuda),
              _cm_map(plan.ncols, cuda), values=exact)


def test_mask_cmap_all_zero_chunks(cuda):
    """Rows whose values are all zero (int8 chunks of scale 1.0) through
    every mask twin, in both layouts."""
    d = _dense((302, 260), 0.08, 29)
    csr = F.csr_from_dense(d)
    csr.values[:csr.rowptr[64]] = 0.0
    mat = F.csr_to_spc5(csr, 2, 4)
    for kernel in MCM_KERNELS:
        plan = _mcm_plan((2, 4), "int8", kernel, cuda, mat=mat)
        assert bool((plan.value_scale == 1.0).any())
        _mcm_call(kernel, plan, _qm_x(kernel, plan, cuda),
                  _cm_map(plan.ncols, cuda))


@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_cmap_identity_map_matches_the_kernel_without_one(cuda, kernel):
    """With the identity as the map, a twin computes what its kernel
    without a map computes (x padded by the panel wrappers there, read in
    place here)."""
    plan = _mcm_plan((2, 4), "f32", kernel, cuda)
    x = _qm_x(kernel, plan, cuda)
    ident = torch.arange(plan.ncols, dtype=torch.int32, device=cuda)
    y = _mcm_call(kernel, plan, x, ident)
    y0 = _qm_call(kernel, plan, x)
    assert float((y - y0).abs().max()) <= RTOL * float(y0.abs().max())


@pytest.mark.parametrize("vdtype", MCM_VDTYPES)
@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_cmap_launch_refuses_a_wrong_smem_figure(cuda, monkeypatch,
                                                      kernel, vdtype):
    """A twin's launch handed a shared-memory figure 16 bytes off its
    kernel's is refused (CUDA error 1) and not counted."""
    mod, _ = QM_KERNELS[kernel]
    plan = _mcm_plan((4, 8), vdtype, kernel, cuda)
    name = _qm_launch_name(kernel)
    real = getattr(mod, name)

    def off(*args, **kw):
        assert kw.get("mapped"), kw
        launch = real(*args, **kw)
        return dict(launch, smem_bytes=launch["smem_bytes"] + 16)
    monkeypatch.setattr(mod, name, off)
    before = dict(mod.LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        _mcm_call(kernel, plan, _qm_x(kernel, plan, cuda),
                  _cm_map(plan.ncols, cuda))
    assert mod.LAUNCHES == before


@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_cmap_launchers_refuse_no_map(cuda, kernel):
    """A twin's C entry handed a null map is refused (CUDA error 1) and
    writes nothing."""
    from repro_torch.kernels import _build
    mod, layout = QM_KERNELS[kernel]
    plan = _mcm_plan((2, 4), "f32", kernel, cuda)
    x = _qm_x(kernel, plan, cuda)
    spmm = kernel.startswith("spmm")
    nchunks = int(plan.chunk_vbase.shape[-1])
    y = torch.full((plan.nrows, x.shape[1]) if spmm else (plan.nrows,), 7.0,
                   device=cuda)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    dev_ptrs = [t.data_ptr() for t in (
        (plan.chunk_vbase, plan.chunk_xbase) if layout == "panels"
        else (plan.chunk_vbase,))] + [t.data_ptr() for t in (
            plan.chunk_col, plan.chunk_mask, plan.chunk_voff, plan.chunk_row,
            plan.values)] + [0, x.data_ptr(), y.data_ptr()]
    if spmm:
        lib = _build.load_library("spc5_spmm_cmap")
        vec = KM.panels_vector(x.shape[1], x)
        if layout == "panels":
            st = 1 if kernel == "spmm_cuda_panels" else 2
            ln = KM.panels_launch(st, plan.npanels, plan.nchunks, cb=plan.cb,
                                  r=plan.r, c=plan.c, vmax=plan.vmax,
                                  pr=plan.pr, nvec=x.shape[1], vec=vec,
                                  device=cuda, mapped=True)
            err = getattr(lib, f"spc5_spmm_panels_cmap_s{st}")(
                *dev_ptrs, plan.npanels, plan.nchunks, plan.cb, plan.vmax,
                plan.pr, plan.nrows, x.shape[0], plan.r, plan.c, 4,
                plan.values.numel(), x.shape[1], ln["tile_columns"],
                ln["vector"], ln["row_parts"], ln["part_rows"], ln["split"],
                ln["chunks_per_stage"], ln["smem_bytes"], ln["threads"], 0,
                stream, 0)
        else:
            ln = KM.whole_launch(nchunks, cb=plan.cb, r=plan.r, c=plan.c,
                                 vmax=plan.vmax, nvec=x.shape[1], vec=vec,
                                 device=cuda, mapped=True)
            err = lib.spc5_spmm_whole_cmap(
                *dev_ptrs, nchunks, plan.cb, plan.vmax, plan.nrows,
                x.shape[0], plan.r, plan.c, 4, plan.values.numel(),
                x.shape[1], ln["tile_columns"], ln["vector"], ln["grid"],
                ln["stages"], ln["chunks_per_stage"], ln["blocks_per_stage"],
                ln["tile_rows"], ln["smem_bytes"], ln["threads"], 0, stream,
                0)
    else:
        lib = _build.load_library("spc5_spmv")
        st = 1 if kernel in ("spmv_cuda", "spmv_cuda_panels") else 2
        if layout == "panels":
            ln = K.panels_launch(st if st == 1 else K.DB_STAGES, plan.npanels,
                                 plan.nchunks, cb=plan.cb, r=plan.r,
                                 vmax=plan.vmax, pr=plan.pr, device=cuda,
                                 mapped=True)
            ring = () if st == 1 else (ln["stages"],)
            err = getattr(lib, f"spc5_spmv_panels_cmap_s{st}")(
                *dev_ptrs, plan.npanels, plan.nchunks, plan.cb, plan.vmax,
                plan.pr, plan.nrows, plan.r, plan.c, 4, plan.values.numel(),
                ln["split"], *ring, ln["smem_bytes"], ln["threads"], 0,
                stream, 0)
        else:
            ln = K.whole_launch(st, nchunks, cb=plan.cb, r=plan.r,
                                vmax=plan.vmax, device=cuda, mapped=True)
            err = getattr(lib, f"spc5_spmv_whole_cmap_s{st}")(
                *dev_ptrs, nchunks, plan.cb, plan.vmax, plan.nrows,
                plan.r, plan.c, 4, plan.values.numel(), ln["grid"],
                ln["tile_rows"], ln["smem_bytes"], ln["threads"], 0, stream,
                0)
    assert err == 1
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())


@pytest.mark.parametrize("stages", [1, K.WHOLE_DB_STAGES])
def test_whole_cmap_twins_leave_l1_room(cuda, stages):
    """The whole-vector SpMV twins ask for a smaller shared-memory
    carve-out than the CUDA runtime would pick (L1 then holds x and the
    map): at a CTA of 17.6 KB (the vocab layer's ring) an SM holds fewer of
    them than of their kernels, and at least one."""
    for vsize in (4, 2, 1):
        kernel = K.whole_occupancy(stages, 128, 17_632, cuda, vsize)
        twin = K.whole_occupancy(stages, 128, 17_632, cuda, vsize,
                                 mapped=True)
        assert 1 <= twin[0] < kernel[0] and twin[1] == kernel[1]


@pytest.mark.parametrize("kernel", MCM_KERNELS)
def test_mask_wrappers_launch_their_twin_with_a_map_on_the_card(cuda, kernel):
    """Each mask wrapper given a map with CUDA tensors launches its twin
    once (``<kernel>_cmap``) and matches its plain version; without a map
    the same call launches the kernel without one."""
    mod, _ = QM_KERNELS[kernel]
    plan = _mcm_plan((2, 4), "f32", kernel, cuda)
    x = _qm_x(kernel, plan, cuda)
    _mcm_call(kernel, plan, x, _cm_map(plan.ncols, cuda))
    before = dict(mod.LAUNCHES)
    _qm_call(kernel, plan, x)
    assert mod.LAUNCHES == {**before, kernel: before[kernel] + 1}


@pytest.mark.parametrize("layout,lowering,reorder", [
    ("panels", "descriptor", "rcm"), ("panels", "descriptor", "colwindow"),
    ("whole_vector", "descriptor", "rcm"), ("test", "descriptor", "rcm"),
    ("panels", "mask", "panel_rows"), ("panels", "mask", "rcm"),
    ("whole_vector", "mask", "rcm")])
def test_reordered_plans_on_the_card_match_the_cpu_plans(cuda, layout,
                                                         lowering, reorder):
    """Reordered plans through ``ops`` on the card against the same plans on
    the CPU (SpMV with both buffer settings, SpMM at 16): a kept col_perm
    runs the map kernels (the panel descriptor twins, and the mask twins of
    both layouts), a folded one (whole-vector descriptor) none, and a
    permutation of whole panels (a prebuilt Reordering, rows only) is fused
    into the mask plan, whose kernels run with no map."""
    from repro_torch.core import reorder as RE
    mat = F.csr_to_spc5(matgen.scrambled_banded(3_000, 8, 1.0, seed=42),
                        1, 8)
    rows_only = reorder == "panel_rows"
    if rows_only:
        panels = np.random.default_rng(3).permutation(11)
        rows = np.concatenate([np.arange(p * 256, (p + 1) * 256)
                               for p in panels] + [np.arange(2816, 3000)])
        reorder = RE.Reordering(rows.astype(np.int64),
                                np.arange(3_000, dtype=np.int64), "custom")
    kw = dict(layout=layout, lowering=lowering, tune=False, reorder=reorder,
              pr=256, xw=512, cb=64)
    if layout == "test":
        kw["multi_layout"] = "panels"
    card = ops.prepare(mat, device=cuda, **kw)
    cpu = ops.prepare(mat, device="cpu", **kw)
    assert card.is_reordered
    assert card.rows_fused == (rows_only or layout == "whole_vector")
    mapped = card.col_perm is not None and (layout == "panels"
                                            or lowering == "mask")
    assert mapped == (not rows_only
                      and (layout, lowering) != ("whole_vector", "descriptor")
                      and layout != "test")
    rng = np.random.default_rng(8)
    for mod in (K, KD, KM, KDM):
        mod.reset_launches()
    for shape, db in (((3_000,), True), ((3_000,), False),
                      ((3_000, 16), True)):
        x = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
        fn = ops.spmv if len(shape) == 1 else ops.spmm
        y = fn(card, x.to(cuda), double_buffer=db)
        torch.cuda.synchronize()
        ref = fn(cpu, x)
        err = float((y.cpu() - ref).abs().max())
        assert err <= RTOL * float(ref.abs().max()), err
    maps = sum(v for mod in (K, KD, KM, KDM) for k, v in mod.LAUNCHES.items()
               if k.endswith("_cmap"))
    assert maps == (3 if mapped else 0)


# ----------------------------------------------------------------------------
# the record store, the verifier and use_pallas= / interpret= on the card
# ----------------------------------------------------------------------------

def _card_store(device, best, worse, kernel="2x4"):
    """A store of the card's backend where ``best`` measured faster."""
    from repro_torch.core import selector as S
    store = S.RecordStore()
    r, c = S.kernel_block(kernel)
    for avg in (1.0, 3.0, 6.0):
        f = S.MatrixFeatures(0, 0, 0, 5.0, 2.0, avg, avg / (r * c))
        store.add_measurement(kernel, f, S.PanelConfig(**best), 1, 2.0 + avg,
                              backend=S.backend_of(device))
        store.add_measurement(kernel, f, S.PanelConfig(**worse), 1, 1.0,
                              backend=S.backend_of(device))
    return store


def test_card_records_tune_a_card_plan(cuda):
    """Records of the card's backend tune a plan on the card (and its
    kernels compute it); the same records relabelled "cpu" leave it
    untuned, and tune the CPU plan to the same config instead."""
    from repro_torch.analysis import verify as V
    mat = _matrix((2, 4), n=600, m=500)
    best = dict(layout="panels", pr=64, xw=64, cb=8, lowering="descriptor")
    worse = dict(layout="whole_vector", cb=64)
    store = _card_store(cuda, best, worse)
    plan = ops.prepare(mat, store=store, verify=True, device=cuda)
    assert plan.trace[0]["source"] == "store"
    assert (plan.layout, plan.lowering, plan.pr, plan.cb) == (
        "panels", "descriptor", 64, 8)
    assert V.verify_plan(plan).ok
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        500).astype(np.float32))
    KD.reset_launches()
    y = ops.spmv(plan, x.to(cuda))
    torch.cuda.synchronize()
    assert KD.LAUNCHES["spmv_cuda_panels_desc_db"] == 1
    ref = ops.spmv(plan, x.to(cuda), use_pallas=False)
    assert float((y - ref).abs().max()) <= RTOL * float(ref.abs().max())
    for r in store.records:
        r.backend = "cpu"
    assert ops.prepare(mat, store=store, device=cuda).trace[0]["source"] \
        == "no-store"
    cpu = ops.prepare(mat, store=store, device="cpu")
    assert (cpu.layout, cpu.lowering, cpu.pr) == ("panels", "descriptor", 64)


def test_choose_block_and_from_dense_read_the_cards_records(cuda):
    from repro_torch.core import selector as S
    from repro_torch.core.sparse_linear import choose_block
    store = S.RecordStore()
    for k in S.DEFAULT_KERNELS:
        for avg in (1.0, 4.0, 12.0):
            store.add(k, avg, 1, avg / 10.0 + (2.0 if k == "1x8" else 1.0),
                      layout="whole_vector", cb=64,
                      backend=S.backend_of(cuda))
    w = np.random.default_rng(3).standard_normal((300, 200)).astype(
        np.float32)
    csr = F.csr_from_dense(w)
    assert choose_block(csr, store) == choose_block(csr, store,
                                                    device=cuda) == (1, 8)
    assert choose_block(csr, store, device="cpu") == choose_block(csr)
    layer = SparseLinear.from_dense(w, density=0.2, store=store,
                                    verify=True)
    assert (layer.plan.r, layer.plan.c) == (1, 8)
    assert layer.plan.device.type == "cuda"
    assert layer.plan.trace[0]["source"] == "store"
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (4, 200)).astype(np.float32)).to(cuda)
    y, ref = layer(x), layer(x, use_pallas=False)
    assert float((y - ref).abs().max()) <= RTOL * float(ref.abs().max())


@pytest.mark.parametrize("vdtype", ["auto", "bf16", "int8"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_verify_reports_are_the_same_on_both_devices(cuda, layout, lowering,
                                                     vdtype):
    """The verifier reads a plan's tensors on the host and no card: a plan
    on the card and the same plan on the CPU get the same report."""
    from repro_torch.analysis import verify as V
    mat = _matrix((2, 4))
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype, tune=False,
              cb=8, **({} if layout == "whole_vector" else dict(pr=64,
                                                                xw=64)))
    card = ops.prepare(mat, device=cuda, verify=True, **kw)
    cpu = ops.prepare(mat, device="cpu", **kw)
    for nvec in (1, 128):
        rc, rh = V.verify_plan(card, nvec=nvec), V.verify_plan(cpu,
                                                               nvec=nvec)
        assert rc.violations == rh.violations and rc.checked == rh.checked


@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_use_pallas_false_runs_the_plain_version_on_the_card(cuda, layout):
    """``use_pallas=False`` on a card plan: the plain versions on the card,
    no kernel launched, within RTOL of the kernels' output; ``interpret=True``
    raises there."""
    mat = _matrix((2, 4))
    plan = ops.prepare(mat, device=cuda, layout=layout, lowering="mask",
                       tune=False, cb=8,
                       **({} if layout == "whole_vector" else dict(pr=64,
                                                                   xw=64)))
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal(260).astype(np.float32)).to(
        cuda)
    xs = torch.from_numpy(rng.standard_normal((260, 16)).astype(
        np.float32)).to(cuda)
    y, ys = ops.spmv(plan, x), ops.spmm(plan, xs)
    for mod in (K, KD, KM, KDM, KT):
        mod.reset_launches()
    p, ps = ops.spmv(plan, x, use_pallas=False), ops.spmm(plan, xs,
                                                          use_pallas=False)
    torch.cuda.synchronize()
    assert not any(v for mod in (K, KD, KM, KDM, KT)
                   for v in mod.LAUNCHES.values())
    assert p.device.type == ps.device.type == "cuda"
    for a, b in ((y, p), (ys, ps)):
        assert float((a - b).abs().max()) <= RTOL * float(b.abs().max())
    with pytest.raises(ValueError, match="interpret"):
        ops.spmv(plan, x, interpret=True)
    with pytest.raises(ValueError, match="interpret"):
        ops.spmm(plan, xs, interpret=True)
    assert torch.equal(ops.spmv(plan, x, interpret=False).cpu().isfinite(),
                       torch.ones(mat.nrows, dtype=torch.bool))


# ----------------------------------------------------------------------------
# The serving tier on the card
# ----------------------------------------------------------------------------

def _serve_held(plan, **kw):
    """A server whose gather thread starts only at ``release()``, so every
    request submitted before lands in one coalesced batch."""
    import threading

    from repro_torch.launch import server as SV

    class Held(SV.SPC5Server):
        def __init__(self, *a, **k):
            self._go = threading.Event()
            super().__init__(*a, **k)

        def release(self):
            self._go.set()

        def _gather_once(self):
            self._go.wait(60)
            return super()._gather_once()

    return Held(plan, **kw)


_SERVE_TIERS = {
    # tier: (ServeConfig keywords, its SpMV kernel, its SpMM kernel)
    "token": (dict(lowering="descriptor"), "spmv_cuda_desc_db",
              "spmm_cuda_desc"),
    "mask": (dict(lowering="mask"), "spmv_cuda_db", "spmm_cuda"),
    "panel": (dict(lowering="mask", panel="64,256,8"),
              "spmv_cuda_panels_db", "spmm_cuda_panels_db"),
}


@pytest.mark.parametrize("n", [1, 13, 64, 200])
@pytest.mark.parametrize("tier", sorted(_SERVE_TIERS))
def test_serving_tier_coalesced_results_on_the_card(cuda, tier, n):
    """``server.start`` on the card: n requests held into one batch (at most
    the cap: the plan's xw, 128 without one) run the tier's SpMV kernel
    (n = 1) or its SpMM kernel at the next power of two, and every y is
    within ``1e-5 * max|y|`` of a lone ``ops.spmv`` and of the float64
    product (the kernels add with global atomics: not bit for bit, ROADMAP
    §3)."""
    from repro_torch.launch import server as SV
    kw, spmv_name, spmm_name = _SERVE_TIERS[tier]
    mat = _matrix((4, 8), n=700, m=256, density=0.1, seed=3)
    cfg = SV.ServeConfig(verify=True, cache_mb=64, **kw)
    with SV.start(cfg, mat=mat) as started:
        plan = started.plan
    assert plan.device.type == "cuda"
    n_run = min(n, started.max_batch)
    rng = np.random.default_rng(n)
    xs = [rng.standard_normal(256).astype(np.float32) for _ in range(n_run)]
    for mod in (K, KD, KM, KDM, KT):
        mod.reset_launches()
    srv = _serve_held(plan, cache=started.cache)
    try:
        futs = [srv.submit(x) for x in xs]
        srv.release()
        ys = [f.result(timeout=60) for f in futs]
        st = srv.stats()
    finally:
        srv.close()
    launches = {k: v for mod in (K, KD, KM, KDM, KT)
                for k, v in mod.LAUNCHES.items() if v}
    assert launches == {spmv_name if n_run == 1 else spmm_name: 1}
    assert st["degraded"] == 0 and st["batches"] == 1
    assert st["widest_batch"] == n_run
    dense = F.spc5_to_csr(mat).to_dense().astype(np.float64)
    for x, y in zip(xs, ys):
        assert y.device.type == "cuda" and y.dtype == torch.float32
        lone = ops.spmv(plan, torch.from_numpy(x).to(cuda))
        assert float((y - lone).abs().max()) <= RTOL * float(
            lone.abs().max())
        y64 = dense @ x.astype(np.float64)
        assert float(np.abs(y.cpu().double().numpy() - y64).max()) <= \
            RTOL * float(np.abs(y64).max())


def test_a_refused_dispatch_on_the_card_fails_its_callers(cuda):
    """On the card only an injected fault takes the oracle rung (ROADMAP
    §3): a cap of 192 makes 150 held requests an SpMM at nvec 192, which
    the SpMM wrapper refuses (the nvt rule); the callers get its
    ValueError, no batch is degraded and no kernel launches. The CPU
    serves the same batch on the oracle rung, as the reference does."""
    from repro_torch.launch import server as SV
    mat = _matrix((4, 8), n=700, m=256, density=0.1, seed=3)
    cfg = SV.ServeConfig(lowering="mask", cache_mb=64)
    with SV.start(cfg, mat=mat) as started:
        plan = started.plan
    rng = np.random.default_rng(150)
    xs = [rng.standard_normal(256).astype(np.float32) for _ in range(150)]
    for mod in (K, KD, KM, KDM, KT):
        mod.reset_launches()
    srv = _serve_held(plan, cache=started.cache, max_batch=192)
    try:
        futs = [srv.submit(x) for x in xs]
        srv.release()
        for f in futs:
            with pytest.raises(ValueError, match="not divisible"):
                f.result(timeout=60)
        st = srv.stats()
    finally:
        srv.close()
    assert st["degraded"] == 0 and st["batches"] == 0
    assert not any(v for mod in (K, KD, KM, KDM, KT)
                   for v in mod.LAUNCHES.values())


# ----------------------------------------------------------------------------
# Sharded SpMV: every shard's local SpMV through the layout's kernel
# ----------------------------------------------------------------------------

_SHARD_KERNELS = {("whole_vector", "mask"): "spmv_cuda_db",
                  ("whole_vector", "descriptor"): "spmv_cuda_desc_db",
                  ("panels", "mask"): "spmv_cuda_panels_db",
                  ("panels", "descriptor"): "spmv_cuda_panels_desc_db"}


@pytest.mark.parametrize("vdtype", ["f32", "bf16"])
@pytest.mark.parametrize("layout,lowering", sorted(_SHARD_KERNELS))
def test_sharded_spmv_runs_each_shard_through_its_kernel(cuda, layout,
                                                         lowering, vdtype):
    """8 shards of a FEM matrix on the card, one after another: each
    shard's ``local_execute_spmv`` launches the kernel ``ops.spmv`` runs
    for the layout and lowering (8 launches, no other kernel), and y
    assembled from the slabs is held to ``ops.spmv`` of the unsharded plan
    and to the float64 product (bf16 to the dequantised values'
    product)."""
    from repro_torch.core import distributed as D
    from repro_torch.core import plan as PL
    csr = matgen.fem_blocks(2_000, 4, 6, seed=4)
    mat = F.csr_to_spc5(csr, 4, 4)
    geom = dict(cb=64) if layout == "whole_vector" else dict(pr=128, cb=16,
                                                             xw=128)
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype, tune=False,
              **geom)
    sh = D.shard_matrix(mat, 8, device=cuda, **kw)
    plan = ops.prepare(mat, device=cuda, **kw)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        mat.ncols).astype(np.float32)).to(cuda)
    for mod in (K, KD, KM, KDM, KT):
        mod.reset_launches()
    slabs = torch.stack([PL.local_execute_spmv(sh, sh.local(k), x)
                         for k in range(sh.ndev)])
    y = D._assemble(slabs, sh.row_start, sh.nrows)
    torch.cuda.synchronize()
    launches = {k: v for mod in (K, KD, KM, KDM, KT)
                for k, v in mod.LAUNCHES.items() if v}
    assert launches == {_SHARD_KERNELS[layout, lowering]: 8}
    y_plan = ops.spmv(plan, x)
    scale = float(y_plan.abs().max())
    assert float((y - y_plan).abs().max()) <= RTOL * scale
    vals = csr.values.astype(np.float64)
    if vdtype == "bf16":
        vals = torch.from_numpy(csr.values.astype(np.float32)).to(
            torch.bfloat16).double().numpy()
    import scipy.sparse
    a64 = scipy.sparse.csr_matrix((vals, csr.colidx, csr.rowptr),
                                  shape=csr.shape)
    y64 = a64 @ x.cpu().double().numpy()
    assert float(np.abs(y.cpu().double().numpy() - y64).max()) <= \
        RTOL * float(np.abs(y64).max())


# ----------------------------------------------------------------------------
# The LM decoder on the card (ROADMAP queue 1 item 13), every family: the
# same params and tokens on the card and on the CPU. The decoder has no
# kernel of its own (dense products, einsums, scans and scatters). The
# limits and checks are chip_smoke.py's (``lm_hold``): f32 logits to 1e-4 of
# max|logits| at every step; with an int8 KV cache, to 1e-4 up to the step
# where the quantised keys part (a key at a rounding tie landing one step
# apart), 5e-3 after it; the quantiser the same function on both devices,
# the int8 cache entries at most one step apart in under 2e-2 of them; a
# MoE token routed to other experts only at a near-tie, the CPU then
# replayed on the card's experts and held to the same limits.
# ----------------------------------------------------------------------------

_LM_ARCHS = ("yi-6b", "gemma-2b", "glm4-9b", "deepseek-67b", "internvl2-26b",
             "phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m", "mamba2-370m",
             "recurrentgemma-9b", "seamless-m4t-medium")


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _lm_pair(arch, cuda, seed=0):
    """(cfg, params on the card, params on the CPU): one draw on the host,
    carried to both devices through ``convert.params_from_numpy``."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import convert as CV
    from repro_torch.models import model as MD
    cfg = get_smoke_config(arch)
    host = MD.init_params(cfg, torch.Generator().manual_seed(seed))
    tree = CV.tree_map(lambda t: t.numpy(), host)
    return (cfg, CV.params_from_numpy(tree, cuda),
            CV.params_from_numpy(tree, "cpu"))


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_decode_on_the_card_matches_the_cpu(cuda, arch, kv):
    S_ = _chip_smoke()
    cfg, pc, ph = _lm_pair(arch, cuda)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)))
    if kv not in S_.lm_kv_dtypes(cfg):
        kv = "bfloat16"        # no attention cache, or the enc-dec's own

    def run(params, dev, forced=None):
        calls, routes = [], []
        return (*S_._lm_decode(params, cfg, toks.to(dev), kv, calls, routes,
                               forced), calls, routes)
    card = run(pc, cuda)
    assert card[0].device.type == "cuda"
    assert card[0].dtype == torch.float32
    case = S_.lm_hold(card, run(ph, "cpu"), kv, cuda,
                      replay=lambda picks: run(ph, "cpu", picks))
    assert ("routing" in case) == bool(cfg.n_experts)


@pytest.mark.parametrize("arch", _LM_ARCHS)
def test_lm_prefill_on_the_card_matches_the_cpu(cuda, arch):
    from repro_torch.models import model as MD
    cfg, pc, ph = _lm_pair(arch, cuda, seed=3)
    rng = np.random.default_rng(4)
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (2, 16)))}
    if cfg.frontend == "patches":
        batch["prefix"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.n_prefix, cfg.d_model)).astype(np.float32))
    if cfg.is_encdec:
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (2, 20, cfg.d_model)).astype(np.float32))
    yh, _ = MD.prefill(ph, batch, cfg)
    yc, _ = MD.prefill(pc, {k: v.to(cuda) for k, v in batch.items()}, cfg)
    S_ = _chip_smoke()
    assert S_.lm_err(yc, yh) <= S_.LM_SMOKE_TOL["bfloat16"]


def test_lm_serve_cli_decodes_on_the_card_then_runs_the_spmv_kernel(
        cuda, capsys):
    """``serve.main`` with no device: the decode loop on the card, then the
    vocab bench, whose SparseLinear launches an SpMV kernel."""
    from repro_torch.launch import serve
    for mod in (K, KD, KM, KDM, KT):
        mod.reset_launches()
    serve.main(["--arch", "gemma-2b", "--batch", "2", "--tokens", "8",
                "--kv-dtype", "int8", "--vocab-spmv", "0.1"])
    torch.cuda.synchronize()
    out = capsys.readouterr().out
    assert "gemma-2b: 2x8 tokens" in out and "(kv=int8, mesh=1 device)" in out
    assert "vocab_spmv[256x64@0.1]" in out
    launches = {k: v for mod in (K, KD, KM, KDM, KT)
                for k, v in mod.LAUNCHES.items() if v}
    assert launches and all(k.startswith("spmv") for k in launches)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "mamba2-370m",
                                  "recurrentgemma-9b"])
def test_lm_serve_cli_decodes_every_decoder_family_on_the_card(cuda, arch,
                                                                capsys):
    """A MoE, an SSM and the RG-LRU hybrid through ``serve.main`` on the
    card: the reference's tok/s line, then the vocab bench's SpMV
    launches; an encoder-decoder exits with the reference's message."""
    from repro_torch.launch import serve
    for mod in (K, KD, KM, KDM, KT):
        mod.reset_launches()
    serve.main(["--arch", arch, "--batch", "2", "--tokens", "8",
                "--vocab-spmv", "0.1"])
    torch.cuda.synchronize()
    out = capsys.readouterr().out
    assert f"{arch}: 2x8 tokens" in out
    launches = {k: v for mod in (K, KD, KM, KDM, KT)
                for k, v in mod.LAUNCHES.items() if v}
    assert launches and all(k.startswith("spmv") for k in launches)
    with pytest.raises(SystemExit, match="enc-dec serving path"):
        serve.main(["--arch", "seamless-m4t-medium"])
