"""Products of reordered plans and column maps on the CPU, against the JAX
package.

* Every kernel that takes a column map, through its wrapper on the CPU (the
  plain version) against the reference's Pallas kernel in interpret mode
  with ``col_map``, the same random permutation, on byte-equal plans whose
  width is not a multiple of the window (so windows reach columns at or
  past ncols), at f32, bf16 and int8: the four panel descriptor kernels
  (``spmv_pallas_panels_desc[_db]``, ``spmm_pallas_panels_desc[_db]``) and
  the mask ones (``spmv_pallas[_db]``, ``spmv_pallas_panels[_db]``,
  ``spmm_pallas``, ``spmm_pallas_panels[_db]``).
* ``execute_spmv`` / ``execute_spmm`` on reordered port plans of every
  layout and lowering against the reference's executors (``use_pallas=
  False``) and the contract ``A' @ x[col_perm] == (A @ x)[row_perm]``.
* Reordered reference plans and layers carried across by
  ``plan_from_arrays`` and ``SparseLinear.from_arrays``, and the layer's
  ``reorder=``.
* The fuse choice: a panel plan past the reference's 2 MiB budget still
  hands its map to the kernel wrapper.

Tolerance: f32 within ``1e-5 * max|y_ref|`` (f32 sums in another order);
against the f64 dense product, bf16 and int8 within ``tests/test_vdtype.
py``'s pins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import reorder as JR
from repro.core import sparse_linear as JL
from repro.kernels import ops as jops
from repro.kernels import spc5_spmm as JKM
from repro.kernels import spc5_spmv as JK
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import ref_spmv as TR
from repro_torch.core import reorder as TRE
from repro_torch.core import sparse_linear as TL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5
VDTYPES = ("f32", "bf16", "int8")

#: wrapper: (port module, reference module, layout, lowering)
MAP_KERNELS = {
    "spmv_cuda_panels_desc": (KD, JK, "panels", "descriptor"),
    "spmv_cuda_panels_desc_db": (KD, JK, "panels", "descriptor"),
    "spmm_cuda_panels_desc": (KDM, JKM, "panels", "descriptor"),
    "spmm_cuda_panels_desc_db": (KDM, JKM, "panels", "descriptor"),
    "spmv_cuda": (K, JK, "whole_vector", "mask"),
    "spmv_cuda_db": (K, JK, "whole_vector", "mask"),
    "spmv_cuda_panels": (K, JK, "panels", "mask"),
    "spmv_cuda_panels_db": (K, JK, "panels", "mask"),
    "spmm_cuda": (KM, JKM, "whole_vector", "mask"),
    "spmm_cuda_panels": (KM, JKM, "panels", "mask"),
    "spmm_cuda_panels_db": (KM, JKM, "panels", "mask"),
}


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def assert_close(y, y_ref):
    y, y_ref = np.asarray(y, dtype=np.float64), np.asarray(y_ref,
                                                           dtype=np.float64)
    np.testing.assert_allclose(y, y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


def error_bound(dense, x, vdtype):
    """``tests/test_vdtype.py``'s elementwise pin on |y - A @ x|."""
    absA, absx = np.abs(dense).astype(np.float64), np.abs(x)
    if vdtype == "bf16":
        return (2.0 ** -7) * (absA @ absx) + 1e-5
    smax = absA.max() / 127.0
    return 0.5 * smax * ((absA > 0).astype(np.float64) @ absx) + 1e-5


def _jnp(a):
    """A port tensor for the reference: bf16 as ml_dtypes' bfloat16."""
    if a.dtype == torch.bfloat16:
        import ml_dtypes
        return jnp.asarray(a.view(torch.int16).numpy().view(
            ml_dtypes.bfloat16))
    return jnp.asarray(a.numpy())


# ----------------------------------------------------------------------------
# the wrappers with a map, against the reference's Pallas kernels
# ----------------------------------------------------------------------------

def _pair_plans(layout, lowering, vdtype, rc=(2, 4), shape=(130, 150),
                seed=3):
    """Byte-equal plans of both packages (panels: pr 32, xw 32, cb 4,
    150 columns, 150 % 32 != 0; whole-vector: cb 8)."""
    d = _random(shape, 0.12, seed)
    geom = (dict(pr=32, xw=32, cb=4) if layout == "panels" else dict(cb=8))
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype, tune=False,
              **geom)
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc), **kw)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                         device="cpu", **kw)
    return tplan, jplan, d


def _args(kernel, plan):
    """The wrapper's array arguments before x, from the port plan."""
    layout, lowering = MAP_KERNELS[kernel][2:]
    head = ((plan.chunk_vbase, plan.chunk_xbase) if layout == "panels"
            else (plan.chunk_vbase,))
    if lowering == "descriptor":
        tabs = (plan.desc_valid, plan.desc_vidx, plan.desc_xcol,
                plan.desc_yrow)
    else:
        tabs = (plan.chunk_col, plan.chunk_mask, plan.chunk_voff,
                plan.chunk_row)
    return head + tabs + (plan.values,)


def _geom(kernel, plan):
    layout = MAP_KERNELS[kernel][2]
    kw = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax,
              nrows=plan.nrows)
    kw.update(dict(xw=plan.xw, pr=plan.pr, ncols_pad=plan.ncols_pad)
              if layout == "panels" else dict(ncols=plan.ncols))
    return kw


@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("kernel", sorted(MAP_KERNELS))
def test_wrapper_with_a_map_matches_pallas(kernel, vdtype):
    """The port's wrapper on the CPU and the reference's Pallas kernel in
    interpret mode, both with the same column map (SpMM at nvec 4); no
    launch is counted on the CPU. Also the f64 product of the permuted
    dense matrix (within the pins at bf16 and int8)."""
    mod, jmod, layout, lowering = MAP_KERNELS[kernel]
    tplan, jplan, d = _pair_plans(layout, lowering, vdtype)
    ncols = d.shape[1]
    assert layout != "panels" or tplan.ncols % tplan.xw != 0
    cmap = np.random.default_rng(7).permutation(ncols).astype(np.int32)
    spmm = kernel.startswith("spmm")
    x = np.random.default_rng(8).standard_normal(
        (ncols, 4) if spmm else ncols).astype(np.float32)
    scale = tplan.value_scale if vdtype == "int8" else None
    before = dict(mod.LAUNCHES)
    y = getattr(mod, kernel)(*_args(kernel, tplan), torch.from_numpy(x),
                             torch.from_numpy(cmap), scale,
                             **_geom(kernel, tplan))
    assert mod.LAUNCHES == before
    ref_name = kernel.replace("_cuda", "_pallas")
    jargs = [_jnp(a) for a in _args(kernel, tplan)]
    y_pal = getattr(jmod, ref_name)(
        *jargs, jnp.asarray(x), jnp.asarray(cmap),
        None if scale is None else jnp.asarray(scale.numpy()),
        interpret=True, **_geom(kernel, tplan))
    assert_close(y, y_pal)
    # x[cmap] read at permuted column j: the product of A with x mapped
    xm = x[cmap].astype(np.float64)
    want = d.astype(np.float64) @ xm
    if vdtype == "f32":
        assert_close(y, want)
    else:
        bound = error_bound(d, np.abs(xm), vdtype)
        assert (np.abs(y.numpy() - want) <= bound).all()


@pytest.mark.parametrize("kernel", sorted(MAP_KERNELS))
def test_wrapper_checks_its_map(kernel):
    """A map of the wrong dtype or length raises before anything runs."""
    mod, _, layout, lowering = MAP_KERNELS[kernel]
    tplan, _, d = _pair_plans(layout, lowering, "f32")
    spmm = kernel.startswith("spmm")
    x = torch.zeros((d.shape[1], 2) if spmm else d.shape[1])
    fn = getattr(mod, kernel)
    with pytest.raises(TypeError, match="int32"):
        fn(*_args(kernel, tplan), x, torch.arange(d.shape[1]),
           **_geom(kernel, tplan))
    with pytest.raises(ValueError, match="shape"):
        fn(*_args(kernel, tplan), x,
           torch.arange(d.shape[1] - 1, dtype=torch.int32),
           **_geom(kernel, tplan))


def test_pad_cmap_reads_zero_past_ncols():
    """The port's padded map points a column at or past ncols at x's zero
    padding (the reference pads with 0, reading x[0] times a zero value)."""
    cmap = torch.tensor([2, 0, 1], dtype=torch.int32)
    padded = TR.pad_cmap(cmap, 6)
    assert padded.tolist() == [2, 0, 1, 3, 4, 5]
    assert TR.pad_cmap(cmap, 3) is cmap


# ----------------------------------------------------------------------------
# reordered plans through the executors
# ----------------------------------------------------------------------------

LAYOUTS = {"whole_vector": dict(layout="whole_vector", cb=16),
           "panels": dict(layout="panels", pr=64, xw=64, cb=8),
           "test_whole": dict(layout="test", multi_layout="whole_vector",
                              cb=16),
           "test_panels": dict(layout="test", multi_layout="panels", pr=64,
                               xw=64, cb=8)}


def _scrambled(rc=(1, 8), n=500):
    j = JM.scrambled_banded(n, 8, 1.0, seed=42)
    t = TM.scrambled_banded(n, 8, 1.0, seed=42)
    return (JF.csr_to_spc5(j, *rc), TF.csr_to_spc5(t, *rc),
            t.to_dense().astype(np.float64))


@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("reorder", ["rcm", "colwindow", "sigma"])
def test_reordered_products_match_the_reference(reorder, layout, lowering,
                                                vdtype):
    """SpMV (both buffer settings) and SpMM at nvec 5 of a reordered plan
    against the reference's executors on its plan, and against the f64
    product of the unpermuted matrix (x and y in the original order)."""
    jm, tm, dense = _scrambled((2, 4) if reorder == "sigma" else (1, 8))
    kw = dict(LAYOUTS[layout], lowering=lowering, vdtype=vdtype,
              tune=False, reorder=reorder)
    jplan = jops.prepare(jm, **kw)
    tplan = tops.prepare(tm, device="cpu", **kw)
    rng = np.random.default_rng(4)
    x = rng.standard_normal(500).astype(np.float32)
    xm = rng.standard_normal((500, 5)).astype(np.float32)
    for db in (True, False):
        y = tops.spmv(tplan, torch.from_numpy(x), double_buffer=db)
        assert_close(y, jops.spmv(jplan, jnp.asarray(x), use_pallas=False,
                                  double_buffer=db))
    ym = tops.spmm(tplan, torch.from_numpy(xm))
    assert_close(ym, jops.spmm(jplan, jnp.asarray(xm), use_pallas=False))
    for got, xin in ((y, x), (ym, xm)):
        want = dense @ xin.astype(np.float64)
        if vdtype == "f32":
            assert_close(got, want)
        else:
            assert (np.abs(got.numpy() - want)
                    <= error_bound(dense, np.abs(xin), vdtype)).all()


@pytest.mark.parametrize("reorder", ["rcm", "colwindow"])
def test_the_permuted_product_contract(reorder):
    """``A' @ x[col_perm] == (A @ x)[row_perm]``: the port's plan of the
    permuted matrix, given x gathered by col_perm, computes y gathered by
    row_perm; the reordered plan undoes both."""
    jm, tm, dense = _scrambled()
    reo = TRE.reorder(tm, reorder, pr=64, xw=64, cb=8)
    assert not reo.is_identity
    permuted = tops.prepare(reo.permute_spc5(tm), layout="panels",
                            lowering="descriptor", tune=False, device="cpu",
                            pr=64, xw=64, cb=8)
    x = np.random.default_rng(5).standard_normal(500).astype(np.float32)
    y_perm = tops.spmv(permuted, torch.from_numpy(reo.apply_x(x)))
    assert_close(y_perm, (dense @ x.astype(np.float64))[reo.row_perm])
    plan = tops.prepare(tm, layout="panels", lowering="descriptor",
                        tune=False, device="cpu", reorder=reo, pr=64, xw=64,
                        cb=8)
    assert_close(tops.spmv(plan, torch.from_numpy(x)),
                 reo.unpermute_y(y_perm.numpy()))


# ----------------------------------------------------------------------------
# carrying reordered reference plans and layers across
# ----------------------------------------------------------------------------

def _keywords(plan):
    return dict(col_perm=plan.col_perm, row_iperm=plan.row_iperm,
                rows_fused=plan.rows_fused)


@pytest.mark.parametrize("how", ["whole", "keywords"])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
def test_plan_from_arrays_carries_a_reordered_reference_plan(lowering,
                                                             layout, how):
    jm, _, dense = _scrambled()
    jplan = jops.prepare(jm, lowering=lowering, tune=False, reorder="rcm",
                         **LAYOUTS[layout])
    assert jplan.is_reordered
    if how == "whole":
        tplan = TP.plan_from_arrays(jplan, device="cpu")
        assert tplan.strategy == "rcm" and tplan.stats == jplan.stats
    else:
        children = [jplan.multi] if jplan.layout == "test" else ()
        tplan = TP.plan_from_arrays(jplan.layout, jplan.arrays, jplan.meta,
                                    device="cpu", children=children,
                                    **_keywords(jplan))
    assert tplan.is_reordered and tplan.rows_fused == jplan.rows_fused
    x = np.random.default_rng(6).standard_normal(500).astype(np.float32)
    xm = np.random.default_rng(7).standard_normal((500, 3)).astype(
        np.float32)
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 jops.spmv(jplan, jnp.asarray(x), use_pallas=False))
    assert_close(tops.spmm(tplan, torch.from_numpy(xm)),
                 jops.spmm(jplan, jnp.asarray(xm), use_pallas=False))
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 dense @ x.astype(np.float64))


def test_plan_from_arrays_checks_the_permutations():
    jm, _, _ = _scrambled()
    jplan = jops.prepare(jm, layout="panels", lowering="descriptor",
                         tune=False, reorder="rcm", pr=64, xw=64, cb=8)
    with pytest.raises(ValueError, match="col_perm"):
        TP.plan_from_arrays(jplan.layout, jplan.arrays, jplan.meta,
                            device="cpu", col_perm=np.arange(499))
    with pytest.raises(ValueError, match="row_iperm"):
        TP.plan_from_arrays(jplan.layout, jplan.arrays, jplan.meta,
                            device="cpu", row_iperm=np.zeros(500, np.float32))
    with pytest.raises(ValueError, match="not both"):
        TP.plan_from_arrays(jplan, device="cpu", col_perm=jplan.col_perm)


@pytest.mark.parametrize("reorder", ["rcm", "colwindow", "prebuilt"])
def test_sparse_linear_reorder_and_from_arrays(reorder):
    """``from_dense(reorder=)`` in both packages gives byte-equal plans and
    the same forward (batch 1 and 4); the reference's reordered layer comes
    across whole and by keywords; a prebuilt Reordering (the reference's)
    is taken by the port's ``from_dense``."""
    w = _random((160, 120), 0.3, 9)
    kw = dict(density=0.3, block=(2, 4), layout="panels",
              lowering="descriptor", tune=False, pr=32, xw=32, cb=8)
    if reorder == "prebuilt":
        csr = JF.csr_from_dense(JL.prune_by_magnitude(w, 0.3))
        reorder = JR.Reordering(
            np.random.default_rng(1).permutation(160).astype(np.int64),
            np.random.default_rng(2).permutation(120).astype(np.int64),
            "custom")
        assert csr.shape == (160, 120)
    jl = JL.SparseLinear.from_dense(w, reorder=reorder, **kw)
    tl = TL.SparseLinear.from_dense(w, reorder=reorder, device="cpu", **kw)
    assert tl.plan.is_reordered == jl.handle.is_reordered
    for t, j in zip(tl.plan.arrays, jl.handle.arrays):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    x = np.random.default_rng(3).standard_normal((4, 120)).astype(np.float32)
    for xb in (x[:1], x):
        want = jl(jnp.asarray(xb), use_pallas=False)
        assert_close(tl(torch.from_numpy(xb)), want)
        for layer in (TL.SparseLinear.from_arrays(jl.handle, bias=jl.bias,
                                                  device="cpu"),
                      TL.SparseLinear.from_arrays(
                          jl.handle.layout, jl.handle.arrays, jl.handle.meta,
                          jl.bias, device="cpu", **_keywords(jl.handle))):
            assert_close(layer(torch.from_numpy(xb)), want)


# ----------------------------------------------------------------------------
# the fuse choice: the port maps columns at every width
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("spmm", [False, True])
def test_a_plan_past_the_reference_budget_still_maps_in_the_kernel(
        monkeypatch, spmm):
    """The reference materialises x[col_perm] once x and the map pass its
    2 MiB budget (``_panel_fused_x``); the port hands the map to the
    kernel wrapper at every width. A panel plan of 300,000 columns (SpMV:
    300,000 * 8 bytes) and one of 4,608 columns at nvec 128 (4,608 * 516
    bytes, the vocab layer's side of the line): the wrapper is called with
    the map, once a product, and its (plain) result is the product."""
    ncols = 4_608 if spmm else 300_000
    rng = np.random.default_rng(11)
    rows = rng.integers(0, 64, 600)
    cols = rng.integers(0, ncols, 600)
    csr = TF.csr_from_coo((64, ncols), rows, cols,
                          rng.standard_normal(600).astype(np.float32))
    mat = TF.csr_to_spc5(csr, 1, 8)
    reo = TRE.Reordering(np.arange(64, dtype=np.int64),
                           rng.permutation(ncols).astype(np.int64), "custom")
    plan = tops.prepare(mat, layout="panels", lowering="descriptor",
                        tune=False, device="cpu", reorder=reo, nvec=128)
    nvec = 128 if spmm else 1
    assert plan.ncols_pad * (4 * nvec + 4) > TP.VMEM_WHOLE_VECTOR_BUDGET
    assert plan.col_perm is not None
    mod, name = ((KDM, "spmm_cuda_panels_desc_db") if spmm
                 else (KD, "spmv_cuda_panels_desc_db"))
    real, calls = getattr(mod, name), []

    def spy(*args, **kw):
        calls.append(args[8] is not None)
        return real(*args, **kw)
    monkeypatch.setattr(mod, name, spy)
    x = rng.standard_normal((ncols, nvec) if spmm else ncols).astype(
        np.float32)
    y = (tops.spmm if spmm else tops.spmv)(plan, torch.from_numpy(x))
    assert calls == [True]
    dense_y = np.zeros((64,) + ((nvec,) if spmm else ()))
    np.add.at(dense_y, _csr_rows(csr), csr.values[:, None] * x[csr.colidx]
              if spmm else csr.values * x[csr.colidx])
    assert_close(y, dense_y)


def _csr_rows(csr):
    return np.repeat(np.arange(csr.nrows), np.diff(csr.rowptr))
