"""The port's plan pipeline and ops facade against the JAX package's.

Both packages build from the same matrix with the same explicit arguments
(``lowering="mask"``, ``tune=False`` unless the tune pass is the point); the
port runs on the CPU (``device="cpu"``), where its kernel wrappers take the
plain PyTorch version. The JAX side runs its Pallas kernels in interpret
mode and its jnp oracle, as its own tests do.

Tolerance for outputs: ``rtol=1e-5``, ``atol=1e-5 * max|y_ref|`` (the f32
sums of a row are taken in another order). Plan arrays must be byte-equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import selector as JS
from repro.core import sparse_linear as JL
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core.sparse_linear import SparseLinear
from repro_torch.kernels import ops as tops

RTOL = 1e-5
GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=64, xw=64, cb=16)}


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))


def assert_arrays_byte_equal(tplan, jplan):
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        j = np.asarray(j)
        t = t.cpu().numpy()
        if j.dtype == np.uint32:          # masks travel as an int32 view
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()


def _pair(rc):
    """fem_blocks(1_200, 4, 6): the SET_A bone010 class at a small size,
    float64 values as the generators make them."""
    return (JF.csr_to_spc5(JM.fem_blocks(1_200, 4, 6, seed=3), *rc),
            TF.csr_to_spc5(TM.fem_blocks(1_200, 4, 6, seed=3), *rc))


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_prepare_spmv_end_to_end_matches_reference(rc, layout):
    jmat, tmat = _pair(rc)
    jplan = jops.prepare(jmat, layout=layout, lowering="mask", tune=False,
                         **GEOM[layout])
    tplan = tops.prepare(tmat, layout=layout, lowering="mask", tune=False,
                         device="cpu", **GEOM[layout])
    assert tplan.device == torch.device("cpu")
    assert_arrays_byte_equal(tplan, jplan)
    x = _x(tmat.ncols)
    y_pal = jops.spmv(jplan, jnp.asarray(x), use_pallas=True, interpret=True)
    y_ora = jops.spmv(jplan, jnp.asarray(x), use_pallas=False)
    for db in (True, False):
        y = tops.spmv(tplan, torch.from_numpy(x), double_buffer=db)
        assert y.dtype == torch.float32 and y.shape == (tmat.nrows,)
        assert_close(y, y_pal)
        assert_close(y, y_ora)


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


@pytest.mark.parametrize("case", [
    dict(layout="whole_vector", tune=False),
    dict(layout="panels", tune=False, pr=64, xw=64, cb=16),
    dict(layout="auto", tune=False),
    dict(layout="auto", tune=True),
    dict(layout="whole_vector", tune=True, vdtype="f32"),
    dict(layout="auto", tune=True, cb=32),
])
def test_trace_matches_reference(case):
    jmat, tmat = _pair((2, 4))
    jt = jops.prepare(jmat, lowering="mask", **case).trace
    tt = tops.prepare(tmat, lowering="mask", device="cpu", **case).trace
    assert [sorted(e) for e in tt] == [sorted(e) for e in jt]
    assert _strip(tt) == _strip(jt)
    assert all(isinstance(e["duration_s"], float) and e["duration_s"] >= 0
               for e in tt)


@pytest.mark.parametrize("values_dtype,want", [(np.float32, "whole_vector"),
                                               (np.float64, "panels")])
def test_auto_layout_rule_matches_reference(values_dtype, want):
    """(nrows + ncols) * itemsize against the 2 MiB budget, counted with the
    matrix's own value dtype: 180,000 x 90,000 fits in f32 (1.08 MB), not
    in f64 (2.16 MB)."""
    rows = np.array([0, 7, 179_999]), np.array([3, 89_990, 5])
    vals = np.array([1.5, -2.0, 0.25], dtype=values_dtype)
    shape = (180_000, 90_000)
    jmat = JF.csr_to_spc5(JF.csr_from_coo(shape, *rows, vals), 8, 4)
    tmat = TF.csr_to_spc5(TF.csr_from_coo(shape, *rows, vals), 8, 4)
    jplan = jops.prepare(jmat, lowering="mask", tune=False)
    tplan = tops.prepare(tmat, lowering="mask", tune=False, device="cpu")
    assert tplan.layout == jplan.layout == want
    assert _strip(tplan.trace) == _strip(jplan.trace)
    x = _x(shape[1])
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 jops.spmv(jplan, jnp.asarray(x), use_pallas=False))
    for n, m, item in [(1000, 1000, 4), (200_000, 62_144, 8),
                       (200_000, 62_145, 8), (400_000, 124_288, 4)]:
        assert TP.fits_whole_vector(n, m, item) == jops.fits_whole_vector(
            n, m, item)


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_plan_from_arrays_round_trips_a_jax_plan(layout):
    jmat, tmat = _pair((4, 8))
    jplan = jops.prepare(jmat, layout=layout, lowering="mask", tune=False,
                         **GEOM[layout])
    tplan = TP.plan_from_arrays(layout, jplan.arrays, jplan.meta,
                                device="cpu")
    assert_arrays_byte_equal(tplan, jplan)
    assert dict(tplan.meta) == dict(jplan.meta)
    own = tops.prepare(tmat, layout=layout, lowering="mask", tune=False,
                       device="cpu", **GEOM[layout])
    x = _x(tmat.ncols)
    y = tops.spmv(tplan, torch.from_numpy(x))
    assert torch.equal(y, tops.spmv(own, torch.from_numpy(x)))
    assert_close(y, jops.spmv(jplan, jnp.asarray(x), use_pallas=False))


def test_prepare_config_takes_panelconfig_whole():
    jmat, tmat = _pair((4, 4))
    cfg = JS.PanelConfig(layout="panels", pr=64, xw=64, cb=16,
                         lowering="mask")
    jplan = jops.prepare(jmat, config=cfg)
    tplan = tops.prepare(tmat, config=cfg, device="cpu")
    assert (tplan.layout, tplan.pr, tplan.xw, tplan.cb) == ("panels", 64, 64,
                                                            16)
    assert_arrays_byte_equal(tplan, jplan)
    assert _strip(tplan.trace) == _strip(jplan.trace)


def test_prepare_without_device_needs_a_card():
    _, tmat = _pair((1, 4))
    if torch.cuda.is_available():
        plan = tops.prepare(tmat, tune=False)
        assert plan.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.prepare(tmat, tune=False)


@pytest.mark.parametrize("kw", [
    dict(dtype=np.float64),
    dict(config=JS.PanelConfig(layout="panels", reorder="rcm")),
])
def test_unported_axes_raise(kw):
    """A float64 store and a reordering config stay refusals."""
    _, tmat = _pair((1, 8))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tops.prepare(tmat, device="cpu", **kw)


def assert_plans_byte_equal(tplan, jplan):
    """Arrays (bf16 as bit patterns), meta and, for a test plan, the multi
    sub-plan's, byte for byte."""
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:
            t, j = t.view(torch.int16), j.view(np.int16)
        t = t.numpy()
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.tobytes() == j.tobytes()
    assert tuple(tplan.meta) == tuple(jplan.meta)
    for tc, jc in zip(tplan.children, jplan.children):
        assert_plans_byte_equal(tc, jc)


@pytest.mark.parametrize("kw", [
    dict(entry="from_dense", vdtype="bf16"),
    dict(entry="from_dense", lowering="descriptor", vdtype="int8"),
    dict(vdtype="bf16"),
    dict(vdtype="int8"), dict(layout="test", vdtype="bf16"),
    dict(config=JS.PanelConfig(layout="panels", lowering="descriptor",
                               vdtype="bf16")),
    dict(layout="test", vdtype="int8"),
])
def test_quantised_axes_build_like_the_reference(kw):
    """The bf16 / int8 cases that raised before the value-dtype axis was
    ported now build the reference's plan byte for byte and compute its
    product. ``entry`` names the call under test: ``ops.prepare``
    (default) or ``SparseLinear.from_dense``, at its default lowering and
    at ``descriptor``; the ``test`` layout stores the values in its multi
    sub-plan (quantised) and its tail (bf16, or f32 for int8); a
    ``PanelConfig`` passes its vdtype."""
    jmat, tmat = _pair((1, 8))
    kw = dict(kw, tune=False)
    entry = kw.pop("entry", "prepare")
    if entry == "from_dense":
        w = np.random.default_rng(0).standard_normal((16, 24)).astype(
            np.float32)
        tlayer = SparseLinear.from_dense(w, block=(1, 8), device="cpu", **kw)
        jlayer = JL.SparseLinear.from_dense(w, block=(1, 8), **kw)
        assert_plans_byte_equal(tlayer.plan, jlayer.handle)
        x = np.random.default_rng(1).standard_normal((3, 24)).astype(
            np.float32)
        assert_close(tlayer(torch.from_numpy(x)),
                     jlayer(jnp.asarray(x), use_pallas=False))
        return
    tplan = tops.prepare(tmat, device="cpu", **kw)
    jplan = jops.prepare(jmat, **kw)
    assert_plans_byte_equal(tplan, jplan)
    x = _x(tmat.ncols)
    y = tops.spmv(tplan, torch.from_numpy(x))
    assert y.dtype == torch.float32
    assert_close(y, jops.spmv(jplan, jnp.asarray(x), use_pallas=False))


def test_spmv_wants_x_on_the_plans_device():
    _, tmat = _pair((2, 8))
    plan = tops.prepare(tmat, tune=False, device="cpu")
    with pytest.raises(ValueError, match="device"):
        tops.spmv(plan, _x(tmat.ncols))
    with pytest.raises(ValueError, match="device"):
        tops.spmv(plan, torch.zeros(tmat.ncols, device="meta"))
