"""The rest of the reference's ``ops`` surface in the port, against the JAX
package, on the host: the deprecated shims ``prepare_panels`` /
``prepare_test``, the re-exported names and legacy handle aliases, the
``use_pallas=`` / ``interpret=`` keywords of ``spmv`` / ``spmm`` /
``spmv_test`` / ``SparseLinear.forward``, ``ref_spmv.spmv_dense_oracle``
and the oracle module ``kernels/ref.py``, and the legacy ``dtype=``
decision (float32 only: a deliberate difference).

Plans must be byte-equal (bf16 as bit patterns); products agree to
``rtol=1e-5``, ``atol=1e-5 * max|y_ref|`` (the f32 sums of a row are taken
in another order). ``use_pallas=False`` runs the plain PyTorch version on
the plan's device, so on the CPU it must equal the default path's output
exactly (the same plain version).
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import ref_spmv as JR
from repro.core import sparse_linear as JL
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import ref_spmv as TR
from repro_torch.core import sparse_linear as TL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

RTOL = 1e-5
GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=64, xw=64, cb=8),
        "test": dict(pr=64, xw=64, cb=8)}


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))


def assert_plans_byte_equal(tplan, jplan):
    assert tplan.layout == jplan.layout
    assert tuple(tplan.meta) == tuple(jplan.meta)
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            t, j = t.view(torch.int16), j.view(np.int16)
        t = t.numpy()
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
    for tc, jc in zip(tplan.children, jplan.children):
        assert_plans_byte_equal(tc, jc)


def _pair(rc=(2, 4), n=240, seed=5):
    return (JF.csr_to_spc5(JM.scrambled_banded(n, 4, 0.9, seed=seed), *rc),
            TF.csr_to_spc5(TM.scrambled_banded(n, 4, 0.9, seed=seed), *rc))


def _x(n, nvec=None, seed=7):
    rng = np.random.default_rng(seed)
    shape = (n,) if nvec is None else (n, nvec)
    return rng.standard_normal(shape).astype(np.float32)


# ----------------------------------------------------------------------------
# re-exports and aliases
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["SPC5Plan", "SPC5Handle", "SPC5PanelHandle",
                                  "SPC5ReorderedHandle", "SPC5TestHandle"])
def test_handle_aliases_are_the_plan_class(name):
    assert getattr(tops, name) is TP.SPC5Plan
    assert getattr(jops, name) is not None


def test_reexported_names_match_the_reference():
    for name in ("LAYOUT_WHOLE", "LAYOUT_PANELS", "LAYOUT_TEST",
                 "VMEM_WHOLE_VECTOR_BUDGET"):
        assert getattr(tops, name) == getattr(jops, name)
    assert tops.fits_whole_vector is TP.fits_whole_vector
    for n, m, itemsize, nvec in ((1000, 1000, 4, 1), (1000, 1000, 4, 128),
                                 (200_000, 200_000, 4, 1), (262_144, 0, 8, 1),
                                 (131_072, 131_072, 2, 4)):
        assert (tops.fits_whole_vector(n, m, itemsize, nvec=nvec)
                == jops.fits_whole_vector(n, m, itemsize, nvec=nvec))


# ----------------------------------------------------------------------------
# the deprecated shims
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
def test_prepare_panels_shim_warns_and_builds_the_reference_plan(lowering):
    jmat, tmat = _pair()
    kw = dict(pr=64, cb=8, xw=64, lowering=lowering)
    with pytest.warns(DeprecationWarning, match="prepare_panels"):
        tplan = tops.prepare_panels(tmat, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jplan = jops.prepare_panels(jmat, **kw)
    assert tplan.layout == "panels"
    assert_plans_byte_equal(tplan, jplan)
    assert tplan.trace[0]["source"] == "disabled"


@pytest.mark.parametrize("multi", ["auto", "panels", "whole_vector"])
def test_prepare_test_shim_warns_and_builds_the_reference_plan(multi):
    jmat, tmat = _pair()
    kw = dict(layout=multi, cb=8, pr=64 if multi == "panels" else None,
              xw=64 if multi == "panels" else None, lowering="mask",
              tune=False)
    with pytest.warns(DeprecationWarning, match="prepare_test"):
        tplan = tops.prepare_test(tmat, device="cpu", **kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jplan = jops.prepare_test(jmat, **kw)
    assert tplan.layout == "test"
    assert_plans_byte_equal(tplan, jplan)
    x = _x(tmat.ncols)
    assert_close(tops.spmv_test(tplan, torch.from_numpy(x)),
                 jops.spmv_test(jplan, jnp.asarray(x), use_pallas=False))


# ----------------------------------------------------------------------------
# use_pallas= and interpret=
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vdtype", ["auto", "int8"])
@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_use_pallas_false_is_the_plain_product(layout, lowering, reorder,
                                               vdtype):
    """``use_pallas=False`` on a CPU plan: the plain version, equal to the
    default path's output and to the reference's ``use_pallas=False``, for
    SpMV and SpMM (whose nvt rule it does not apply, as the reference's
    oracle does not); ``interpret`` changes nothing on the CPU."""
    jmat, tmat = _pair()
    kw = dict(layout=layout, lowering=lowering, reorder=reorder,
              vdtype=vdtype, tune=False, **GEOM[layout])
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    x, xs = _x(tmat.ncols), _x(tmat.ncols, 6)
    xt, xst = torch.from_numpy(x), torch.from_numpy(xs)
    y0 = tops.spmv(tplan, xt)
    for extra in (dict(use_pallas=False), dict(use_pallas=False,
                                               interpret=True),
                  dict(use_pallas=False, double_buffer=False)):
        y = tops.spmv(tplan, xt, **extra)
        assert y.dtype == torch.float32 and y.shape == (tmat.nrows,)
        torch.testing.assert_close(y, y0, rtol=0, atol=0)
    for extra in (dict(use_pallas=True), dict(use_pallas=None),
                  dict(interpret=True), dict(interpret=False)):
        torch.testing.assert_close(tops.spmv(tplan, xt, **extra), y0,
                                   rtol=0, atol=0)
    assert_close(y0, jops.spmv(jplan, jnp.asarray(x), use_pallas=False))
    assert_close(tops.spmv_test(tplan, xt, use_pallas=False), y0)
    y = tops.spmm(tplan, xst, use_pallas=False)
    assert y.shape == (tmat.nrows, 6)
    assert_close(y, jops.spmm(jplan, jnp.asarray(xs), use_pallas=False))
    assert_close(y, tops.spmm(tplan, xst, nvt=2))
    assert_close(tops.spmm(tplan, xst, use_pallas=False, nvt=4), y)


def _meta_plan():
    """A plan whose tensors lie off the CPU (on torch's "meta" device): what
    the executors check before any kernel is reached."""
    _, tmat = _pair()
    plan = tops.prepare(tmat, device="cpu", layout="whole_vector",
                        lowering="mask", tune=False, cb=16)
    return TP.SPC5Plan(plan.layout, tuple(a.to("meta") for a in plan.arrays),
                       plan.meta, trace_json=plan.trace_json)


@pytest.mark.parametrize("entry", ["spmv", "spmm", "spmv_test", "forward"])
def test_interpret_true_raises_off_the_cpu(entry):
    """The port has no kernel interpreter: ``interpret=True`` on a plan off
    the CPU raises ``ValueError`` before any kernel (on the card, too:
    ``test_torch_gpu.py``)."""
    plan = _meta_plan()
    x = torch.zeros(plan.ncols, device="meta")
    with pytest.raises(ValueError, match="interpret"):
        if entry == "spmv":
            tops.spmv(plan, x, interpret=True)
        elif entry == "spmm":
            tops.spmm(plan, x[:, None].expand(-1, 4).contiguous(),
                      interpret=True)
        elif entry == "spmv_test":
            tops.spmv_test(plan, x, interpret=True)
        else:
            TL.SparseLinear(plan)(x[None, :], interpret=True)


@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_layer_forward_takes_use_pallas(layout):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((300, 200)).astype(np.float32)
    b = rng.standard_normal(300).astype(np.float32)
    kw = dict(density=0.2, block=(2, 4), bias=b, layout=layout,
              lowering="descriptor", tune=False, **GEOM[layout])
    tl = TL.SparseLinear.from_dense(w, device="cpu", **kw)
    jl = JL.SparseLinear.from_dense(w, **kw)
    x = rng.standard_normal((4, 200)).astype(np.float32)
    for xb in (x, x[:1], x[0]):
        y = tl(torch.from_numpy(xb), use_pallas=False)
        assert y.shape == xb.shape[:-1] + (300,)
        torch.testing.assert_close(y, tl(torch.from_numpy(xb)), rtol=0,
                                   atol=0)
        torch.testing.assert_close(
            y, tl(torch.from_numpy(xb), use_pallas=False, interpret=True),
            rtol=0, atol=0)
        assert_close(y, jl(jnp.asarray(xb), use_pallas=False))


# ----------------------------------------------------------------------------
# oracles
# ----------------------------------------------------------------------------

def test_dense_oracle_matches_reference():
    rng = np.random.default_rng(0)
    for dtype in (np.float32, np.float64):
        d = rng.standard_normal((50, 40)).astype(dtype)
        x = rng.standard_normal(40).astype(np.float32)
        y = TR.spmv_dense_oracle(d, x)
        assert y.dtype == np.float64
        np.testing.assert_array_equal(y, JR.spmv_dense_oracle(d, x))
    assert tref.spmv_dense_oracle is TR.spmv_dense_oracle


def test_ref_module_reexports_the_plain_versions():
    for name in ("SPC5Device", "device_put", "spmm", "spmv",
                 "spmv_dense_oracle"):
        assert getattr(tref, name) is getattr(TR, name)
        assert hasattr(jref, name)
    jmat, tmat = _pair()
    ch = TF.to_chunked(tmat, cb=16)
    dev = tref.device_put(ch, "cpu")
    x = _x(tmat.ncols)
    y = tref.spmv(dev, torch.from_numpy(x), r=2, c=4, nrows=tmat.nrows,
                  ncols=tmat.ncols)
    dense = TF.spc5_to_csr(tmat).to_dense()
    np.testing.assert_allclose(y.numpy(), tref.spmv_dense_oracle(dense, x),
                               rtol=RTOL, atol=1e-5)


# ----------------------------------------------------------------------------
# the legacy dtype= passthrough: float32 only (a deliberate difference)
# ----------------------------------------------------------------------------

def test_float32_dtype_builds_the_reference_plan():
    jmat, tmat = _pair()
    for dtype in (np.float32, "float32", torch.float32):
        tplan = tops.prepare(tmat, device="cpu", dtype=dtype, tune=False,
                             layout="panels", lowering="mask",
                             **GEOM["panels"])
        jplan = jops.prepare(jmat, dtype=np.float32, tune=False,
                             layout="panels", lowering="mask",
                             **GEOM["panels"])
        assert_plans_byte_equal(tplan, jplan)


@pytest.mark.parametrize("dtype", [np.float64, np.float16, "bfloat16",
                                   torch.bfloat16, np.int8])
def test_other_dtypes_stay_refused(dtype):
    """No kernel of the port takes a value store other than f32 or a
    ``vdtype``'s, so the reference's ``dtype=`` passthrough to another
    dtype stays a refusal (ROADMAP §3, deliberate differences); ``vdtype``
    is the way to narrow values."""
    if dtype == "bfloat16":
        import ml_dtypes
        dtype = ml_dtypes.bfloat16
    _, tmat = _pair()
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.prepare(tmat, device="cpu", dtype=dtype)
