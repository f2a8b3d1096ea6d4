"""The port's plain PyTorch SpMV and its kernel wrappers on the CPU, against
the JAX package's Pallas kernels.

The JAX side runs as its own tests run it on the CPU: the Pallas kernels in
interpret mode (``use_pallas=True, interpret=True``, both buffer settings)
and the jnp oracle (``use_pallas=False``). Both packages get the same
layout bytes and the same x, made with numpy from a seed.

Tolerance: ``rtol=1e-5`` and ``atol=1e-5 * max|y_ref|``, because the two
sides add the f32 products of each row in a different order.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import ref_spmv as TR
from repro_torch.kernels import spc5_spmv as K

RTOL = 1e-5


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))


def _inputs(rc, seed=0):
    """302x260 random matrix (nrows % r != 0 for r in (4, 8)) and x."""
    rng = np.random.default_rng(seed + 10 * rc[0] + rc[1])
    d = ((rng.random((302, 260)) < 0.08)
         * rng.standard_normal((302, 260))).astype(np.float32)
    x = rng.standard_normal(260).astype(np.float32)
    return d, x


def _jax_y(d, x, rc, layout, geom, double_buffer):
    h = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc), layout=layout,
                     lowering="mask", tune=False, **geom)
    xj = jnp.asarray(x)
    return (jops.spmv(h, xj, use_pallas=True, interpret=True,
                      double_buffer=double_buffer),
            jops.spmv(h, xj, use_pallas=False))


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_plain_spmv_matches_pallas(rc, double_buffer):
    d, x = _inputs(rc)
    ch = TF.to_chunked(TF.csr_to_spc5(TF.csr_from_dense(d), *rc), cb=16)
    y = TR.spmv(TR.device_put(ch, "cpu"), torch.from_numpy(x), r=rc[0],
                c=rc[1], nrows=ch.nrows, ncols=ch.ncols)
    y_pal, y_ora = _jax_y(d, x, rc, "whole_vector", dict(cb=16),
                          double_buffer)
    assert y.dtype == torch.float32 and y.shape == (302,)
    assert_close(y, y_pal)
    assert_close(y, y_ora)
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_plain_spmv_panels_matches_pallas(rc, double_buffer):
    d, x = _inputs(rc, seed=1)
    pan = TF.to_panels(TF.csr_to_spc5(TF.csr_from_dense(d), *rc), pr=64,
                       cb=16, xw=64)
    assert pan.npanels > 1 and pan.nchunks > 1
    y = TR.spmv_panels(TR.device_put_panels(pan, "cpu"), torch.from_numpy(x),
                       r=rc[0], c=rc[1], pr=pan.pr, nrows=pan.nrows,
                       ncols_pad=pan.ncols_pad)
    y_pal, y_ora = _jax_y(d, x, rc, "panels", dict(pr=64, xw=64, cb=16),
                          double_buffer)
    assert y.dtype == torch.float32 and y.shape == (302,)
    assert_close(y, y_pal)
    assert_close(y, y_ora)


def _wrapper_args(kernel, rc=(4, 8)):
    d, x = _inputs(rc, seed=2)
    mat = TF.csr_to_spc5(TF.csr_from_dense(d), *rc)
    if "panels" in kernel:
        pan = TF.to_panels(mat, pr=64, cb=16, xw=64)
        dev = TR.device_put_panels(pan, "cpu")
        args = (dev.chunk_vbase, dev.chunk_xbase, dev.chunk_col,
                dev.chunk_mask, dev.chunk_voff, dev.chunk_row, dev.values)
        kw = dict(r=rc[0], c=rc[1], cb=16, vmax=pan.vmax, xw=pan.xw,
                  pr=pan.pr, nrows=pan.nrows, ncols_pad=pan.ncols_pad)
        plain = TR.spmv_panels(dev, torch.from_numpy(x), r=rc[0], c=rc[1],
                               pr=pan.pr, nrows=pan.nrows,
                               ncols_pad=pan.ncols_pad)
    else:
        ch = TF.to_chunked(mat, cb=16)
        dev = TR.device_put(ch, "cpu")
        args = (dev.chunk_vbase, dev.chunk_col, dev.chunk_mask,
                dev.chunk_voff, dev.chunk_row, dev.values)
        kw = dict(r=rc[0], c=rc[1], cb=16, vmax=ch.vmax, nrows=ch.nrows,
                  ncols=ch.ncols)
        plain = TR.spmv(dev, torch.from_numpy(x), r=rc[0], c=rc[1],
                        nrows=ch.nrows, ncols=ch.ncols)
    return args, torch.from_numpy(x), kw, plain


KERNELS = ("spmv_cuda", "spmv_cuda_db", "spmv_cuda_panels",
           "spmv_cuda_panels_db")


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_on_cpu_runs_plain_version_and_launches_nothing(kernel):
    args, x, kw, plain = _wrapper_args(kernel)
    before = dict(K.LAUNCHES)
    y = getattr(K, kernel)(*args, x, **kw)
    assert torch.equal(y, plain)
    assert K.LAUNCHES == before


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_rejects_unported_operands(kernel):
    args, x, kw, _ = _wrapper_args(kernel)
    fn = getattr(K, kernel)
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
    fn = getattr(K, kernel)
    with pytest.raises(TypeError, match="float32"):
        fn(*args, x.double(), **kw)
    with pytest.raises(TypeError, match="int32"):
        fn(*args[:-2], args[-2].long(), args[-1], x, **kw)
    bad = dict(kw, cb=kw["cb"] * 2)
    with pytest.raises(ValueError, match="shape"):
        fn(*args, x, **bad)
    strided = torch.zeros(args[-1].shape[0] * 2)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        fn(*args[:-1], strided, x, **kw)


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
    x = np.random.default_rng(7).standard_normal(29).astype(np.float32)
    geom = dict(pr=16, xw=16, cb=4) if layout == "panels" else dict(cb=4)
    mat = TF.csr_to_spc5(TF.csr_from_dense(d), 8, 4)
    if layout == "panels":
        pan = TF.to_panels(mat, **geom)
        y = TR.spmv_panels(TR.device_put_panels(pan, "cpu"),
                           torch.from_numpy(x), r=8, c=4, pr=pan.pr,
                           nrows=37, ncols_pad=pan.ncols_pad)
        if kind == "left_columns":
            assert pan.ncols_pad < 29
    else:
        ch = TF.to_chunked(mat, **geom)
        y = TR.spmv(TR.device_put(ch, "cpu"), torch.from_numpy(x), r=8, c=4,
                    nrows=37, ncols=29)
    y_pal, _ = _jax_y(d, x, (8, 4), layout, geom, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(y.numpy(), d.astype(np.float64) @ x,
                               rtol=RTOL, atol=RTOL)
