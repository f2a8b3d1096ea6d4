"""The port's plain PyTorch SpMM, its kernel wrappers and the SpMM plan path
on the CPU, against the JAX package's Pallas SpMM kernels.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode (``use_pallas=True, interpret=True``, both buffer settings)
and the jnp oracle (``use_pallas=False``). Both packages get the same
matrix and the same X, made with numpy from a seed, and build their plans
with explicit ``layout=``, ``lowering="mask"`` and ``tune=False``.

Tolerance: ``rtol=1e-5`` and ``atol=1e-5 * max|Y_ref|``, because the two
sides add the f32 products of each row in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import plan as TP
from repro_torch.core import ref_spmv as TR
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM

RTOL = 1e-5
GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=64, xw=64, cb=16)}


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))


def _inputs(rc, nvec, seed=0):
    """302x260 random matrix (nrows % r != 0 for r in (4, 8)) and X."""
    rng = np.random.default_rng(seed + 10 * rc[0] + rc[1])
    d = ((rng.random((302, 260)) < 0.08)
         * rng.standard_normal((302, 260))).astype(np.float32)
    x = rng.standard_normal((260, nvec)).astype(np.float32)
    return d, x


@pytest.mark.parametrize("nvec,nvt", [(1, 128), (3, 128), (8, 4)])
@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_plain_spmm_matches_pallas(rc, layout, double_buffer, nvec, nvt):
    """The plain version on the layout's bytes, and ``ops.spmm`` through the
    plan, against the Pallas kernel (interpret mode, the same ``nvt`` and
    buffer setting; nvec=8 with nvt=4 runs two column tiles) and the jnp
    oracle. The whole-vector layout has one SpMM kernel in both packages,
    so there ``double_buffer`` must change nothing."""
    d, x = _inputs(rc, nvec)
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
                         layout=layout, lowering="mask", tune=False,
                         **GEOM[layout])
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                         layout=layout, lowering="mask", tune=False,
                         device="cpu", **GEOM[layout])
    xt = torch.from_numpy(x)
    if layout == "panels":
        assert tplan.npanels > 1 and tplan.nchunks > 1
        plain = TR.spmm_panels(tplan.dev, xt, r=rc[0], c=rc[1], pr=tplan.pr,
                               nrows=302, ncols_pad=tplan.ncols_pad)
    else:
        plain = TR.spmm(tplan.dev, xt, r=rc[0], c=rc[1], nrows=302,
                        ncols=260)
    y = tops.spmm(tplan, xt, nvt=nvt, double_buffer=double_buffer)
    assert y.dtype == torch.float32 and y.shape == (302, nvec)
    assert torch.equal(y, plain)
    xj = jnp.asarray(x)
    assert_close(y, jops.spmm(jplan, xj, use_pallas=True, interpret=True,
                              nvt=nvt, double_buffer=double_buffer))
    assert_close(y, jops.spmm(jplan, xj, use_pallas=False))
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("kind", ["empty", "last_row_only", "left_columns"])
def test_edge_matrices_match_pallas(kind, layout):
    """No nonzero at all; one nonzero in the last row and column (nrows %
    r != 0); nonzeros only in the first columns, so the panel layout's
    ncols_pad (16) is below ncols (29)."""
    d = np.zeros((37, 29), np.float32)
    if kind == "last_row_only":
        d[36, 28] = 2.0
    elif kind == "left_columns":
        d[::3, :9] = np.random.default_rng(6).standard_normal((13, 9))
    x = np.random.default_rng(7).standard_normal((29, 5)).astype(np.float32)
    geom = dict(pr=16, xw=16, cb=4) if layout == "panels" else dict(cb=4)
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), 8, 4),
                         layout=layout, lowering="mask", tune=False, **geom)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), 8, 4),
                         layout=layout, lowering="mask", tune=False,
                         device="cpu", **geom)
    if kind == "left_columns" and layout == "panels":
        assert tplan.ncols_pad < 29
    y = tops.spmm(tplan, torch.from_numpy(x))
    y_pal = jops.spmm(jplan, jnp.asarray(x), use_pallas=True, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(y.numpy(), d.astype(np.float64) @ x,
                               rtol=RTOL, atol=RTOL)


def test_plain_spmm_slices_wide_batches(monkeypatch):
    """The plain version cuts X's columns into slices once set lanes x
    columns pass its limit; the slices give the same Y."""
    d, x = _inputs((2, 4), 12)
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), 2, 4),
                        layout="panels", lowering="mask", tune=False,
                        device="cpu", **GEOM["panels"])
    whole = tops.spmm(plan, torch.from_numpy(x))
    monkeypatch.setattr(TR, "_SLICE_ELEMS", int(np.count_nonzero(d)) * 5)
    assert torch.equal(tops.spmm(plan, torch.from_numpy(x)), whole)


# ----------------------------------------------------------------------------
# wrappers on the CPU
# ----------------------------------------------------------------------------

KERNELS = ("spmm_cuda", "spmm_cuda_panels", "spmm_cuda_panels_db")


def _wrapper_args(kernel, nvec=6, rc=(4, 8)):
    d, x = _inputs(rc, nvec, seed=2)
    mat = TF.csr_to_spc5(TF.csr_from_dense(d), *rc)
    x = torch.from_numpy(x)
    if "panels" in kernel:
        pan = TF.to_panels(mat, pr=64, cb=16, xw=64)
        dev = TR.device_put_panels(pan, "cpu")
        args = (dev.chunk_vbase, dev.chunk_xbase, dev.chunk_col,
                dev.chunk_mask, dev.chunk_voff, dev.chunk_row, dev.values)
        kw = dict(r=rc[0], c=rc[1], cb=16, vmax=pan.vmax, xw=pan.xw,
                  pr=pan.pr, nrows=pan.nrows, ncols_pad=pan.ncols_pad)
        plain = TR.spmm_panels(dev, x, r=rc[0], c=rc[1], pr=pan.pr,
                               nrows=pan.nrows, ncols_pad=pan.ncols_pad)
    else:
        ch = TF.to_chunked(mat, cb=16)
        dev = TR.device_put(ch, "cpu")
        args = (dev.chunk_vbase, dev.chunk_col, dev.chunk_mask,
                dev.chunk_voff, dev.chunk_row, dev.values)
        kw = dict(r=rc[0], c=rc[1], cb=16, vmax=ch.vmax, nrows=ch.nrows,
                  ncols=ch.ncols)
        plain = TR.spmm(dev, x, r=rc[0], c=rc[1], nrows=ch.nrows,
                        ncols=ch.ncols)
    return args, x, kw, plain


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_on_cpu_runs_plain_version_and_launches_nothing(kernel):
    args, x, kw, plain = _wrapper_args(kernel)
    before = dict(KM.LAUNCHES)
    y = getattr(KM, kernel)(*args, x, **kw)
    assert torch.equal(y, plain)
    assert KM.LAUNCHES == before


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_rejects_unported_operands(kernel):
    args, x, kw, _ = _wrapper_args(kernel)
    fn = getattr(KM, kernel)
    # a column map, once refused, is taken on the CPU: the plain version
    # reads x[col_map[column]], what the unmapped call reads of x[col_map]
    cmap = torch.arange(x.shape[0] - 1, -1, -1, dtype=torch.int32)
    assert torch.equal(fn(*args, x, cmap, **kw),
                       fn(*args, x[cmap.long()].contiguous(), **kw))
    with pytest.raises(NotImplementedError, match="int8"):
        fn(*args, x, None, torch.ones(1), **kw)


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_checks_dtype_shape_and_contiguity(kernel):
    args, x, kw, _ = _wrapper_args(kernel)
    fn = getattr(KM, kernel)
    with pytest.raises(TypeError, match="float32"):
        fn(*args, x.double(), **kw)
    with pytest.raises(TypeError, match="int32"):
        fn(*args[:-2], args[-2].long(), args[-1], x, **kw)
    with pytest.raises(ValueError, match="shape"):
        fn(*args, x, **dict(kw, cb=kw["cb"] * 2))
    with pytest.raises(ValueError, match="2-D"):
        fn(*args, x[:, 0].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fn(*args, x.t().contiguous().t(), **kw)
    if kernel == "spmm_cuda":
        with pytest.raises(ValueError, match="shape"):
            fn(*args, x[:-1].contiguous(), **kw)


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_keeps_the_reference_tile_rule(kernel):
    """nvec must be a multiple of min(nvt, nvec), as in the reference: 6
    columns take nvt 128 (one tile of 6), 3 and 2, not 4."""
    args, x, kw, plain = _wrapper_args(kernel, nvec=6)
    fn = getattr(KM, kernel)
    for nvt in (128, 3, 2):
        assert torch.equal(fn(*args, x, nvt=nvt, **kw), plain)
    with pytest.raises(ValueError, match="not divisible by tile 4"):
        fn(*args, x, nvt=4, **kw)


# ----------------------------------------------------------------------------
# the plan path: executor, auto layout with nvec
# ----------------------------------------------------------------------------

def test_spmm_wants_x_on_the_plans_device():
    d, x = _inputs((2, 8), 4)
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), 2, 8),
                        tune=False, device="cpu")
    with pytest.raises(ValueError, match="device"):
        tops.spmm(plan, x)
    with pytest.raises(ValueError, match="device"):
        tops.spmm(plan, torch.zeros(260, 4, device="meta"))


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


@pytest.mark.parametrize("nvec,want", [(1, "whole_vector"), (128, "panels")])
def test_auto_layout_budgets_nvec_like_the_reference(nvec, want):
    """(nrows + ncols) * itemsize * min(nvec, 128) against the 2 MiB
    budget: a 3000 x 1200 f32 matrix needs 16.8 KB at nvec=1 and 2.15 MB at
    nvec=128, so the two widths land on either side of the rule."""
    rng = np.random.default_rng(11)
    d = ((rng.random((3000, 1200)) < 0.01)
         * rng.standard_normal((3000, 1200))).astype(np.float32)
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), 4, 4),
                         lowering="mask", tune=False, nvec=nvec)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), 4, 4),
                         lowering="mask", tune=False, nvec=nvec,
                         device="cpu")
    assert tplan.layout == jplan.layout == want
    assert _strip(tplan.trace) == _strip(jplan.trace)
    x = rng.standard_normal((1200, 4)).astype(np.float32)
    assert_close(tops.spmm(tplan, torch.from_numpy(x)),
                 jops.spmm(jplan, jnp.asarray(x), use_pallas=False))


def test_fits_whole_vector_matches_reference_with_nvec():
    for n, m, item, nvec in [(3000, 1200, 4, 1), (3000, 1200, 4, 128),
                             (3000, 1200, 4, 512), (1000, 1000, 8, 64),
                             (4096, 4096, 4, 32), (4096, 4096, 4, 33)]:
        assert TP.fits_whole_vector(n, m, item, nvec=nvec) == \
            jops.fits_whole_vector(n, m, item, nvec=nvec)
    # the fourth positional argument is the budget, as in the reference
    assert TP.fits_whole_vector(10, 10, 4, 50) is False
    assert jops.fits_whole_vector(10, 10, 4, 50) is False
