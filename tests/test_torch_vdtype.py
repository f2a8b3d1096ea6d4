"""The port's value-dtype axis (bf16 and int8 values) against the JAX
package's.

Host side: ``formats.quantize_chunk_values`` and the bf16 cast give the
reference's bytes (bf16 compared as bit patterns: the port stores them as
``uint16``, the reference as ``ml_dtypes.bfloat16``); quantised plans of
every layout and lowering are byte-equal, ``value_scale`` and meta
included, also where "auto" picks another layout at another width, and
``plan_from_arrays`` takes the reference's quantised plans. Device side (the
CPU, where every wrapper runs its plain version): SpMV and SpMM of a
quantised plan agree with the reference's on the same plan, through its jnp
oracle and its Pallas kernels in interpret mode, and meet
``tests/test_vdtype.py``'s pins against the f64 product of the f32 matrix.
The four panel descriptor wrappers' shared-memory figures are held against
a copy of the kernels' layouts at 4-, 2- and 1-byte values.

Tolerance: outputs within ``1e-5 * max|y_ref|`` of the reference's (f32
sums in another order); the pins are ``2**-7 * (|A| @ |x|)`` for bf16 and
``smax / 2 * ((|A| > 0) @ |x|)`` for int8, each plus 1e-5.
"""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core.sparse_linear import SparseLinear
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5
VDTYPES = ("bf16", "int8")
LAYOUTS = ("whole_vector", "panels", "test", "auto")
LOWERINGS = ("mask", "descriptor")
GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=32, xw=32, cb=8),
        "test": dict(pr=32, xw=32, cb=8), "auto": {}}


def _bits(a):
    """A host array or tensor as comparable bytes: bf16 as its uint16 bit
    patterns (port or reference), masks as uint32."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def assert_plans_byte_equal(tplan, jplan):
    assert tplan.layout == jplan.layout
    assert tuple(tplan.meta) == tuple(jplan.meta)
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        t, j = _bits(t), _bits(j)
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()
    assert len(tplan.children) == len(jplan.children)
    for tc, jc in zip(tplan.children, jplan.children):
        assert_plans_byte_equal(tc, jc)


def assert_close(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    np.testing.assert_allclose(y, y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


def make_mat(rc=(2, 4), n=96, m=80, density=0.3, seed=0):
    """``tests/test_vdtype.py``'s matrix, for both packages."""
    rng = np.random.default_rng(seed)
    dense = ((rng.random((n, m)) < density)
             * rng.standard_normal((n, m))).astype(np.float32)
    return (dense, JF.csr_to_spc5(JF.csr_from_dense(dense), *rc),
            TF.csr_to_spc5(TF.csr_from_dense(dense), *rc))


def error_bound(dense, x, vdtype):
    """``tests/test_vdtype.py``'s elementwise pin on |y - A @ x|."""
    absA, absx = np.abs(dense), np.abs(x)
    if vdtype == "bf16":
        return (2.0 ** -7) * (absA @ absx) + 1e-5
    smax = absA.max() / 127.0
    return 0.5 * smax * ((absA > 0).astype(np.float64) @ absx) + 1e-5


# ----------------------------------------------------------------------------
# host formats: the bf16 cast and quantize_chunk_values
# ----------------------------------------------------------------------------

def test_value_dtype_and_itemsize():
    for vd, size in (("f32", 4), ("bf16", 2), ("int8", 1), ("", 4)):
        assert TF.value_itemsize(vd) == JF.value_itemsize(vd) == size
    assert TF.value_dtype("bf16") == TF.BF16_HOST == np.uint16
    assert TF.value_dtype("int8") == np.int8
    assert TF.value_dtype("float32") == np.float32


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_bf16_bits_match_ml_dtypes(dtype):
    """Random bit patterns (every exponent, subnormals, infinities) and the
    rounding ties, float32 and float64 inputs: the port's bf16 bits are
    ml_dtypes' wherever the input is not NaN."""
    rng = np.random.default_rng(1)
    if dtype == np.float32:
        v = rng.integers(0, 2**32, 400_000, dtype=np.uint64).astype(
            np.uint32).view(np.float32)
    else:
        v = rng.integers(0, 2**63, 400_000, dtype=np.int64).view(np.float64)
        v = np.concatenate([v, v.astype(np.float32).astype(np.float64)
                            * (1 + 2.0 ** -30)])
    ties = (np.arange(1, 200, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    v = np.concatenate([v, ties.astype(dtype), -ties.astype(dtype),
                        np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, 1e-39,
                                  3.4e38, 3.5e38], dtype)])
    got = TF.bf16_bits(v)
    want = v.astype(ml_dtypes.bfloat16).view(np.uint16)
    ok = ~np.isnan(v)
    assert got.dtype == np.uint16 and np.array_equal(got[ok], want[ok])


def test_bf16_nan_pattern_is_the_ports_own():
    """NaN keeps its sign and becomes the quiet NaN 0x7fc0 / 0xffc0 on any
    host; ml_dtypes keeps more of the payload, so the two differ there
    only."""
    nans = np.array([0x7fc00000, 0x7f800001, 0xffc12345, 0x7fffffff],
                    np.uint32).view(np.float32)
    assert TF.bf16_bits(nans).tolist() == [0x7fc0, 0x7fc0, 0xffc0, 0x7fc0]


def _special_values(n, rng):
    """Packed values with rounding ties for int8 (k + 0.5 times a chunk
    scale of 1 when absmax is 127), subnormals, infinities and zeros."""
    v = rng.standard_normal(n).astype(np.float32)
    v[::7] = np.float32(1e-42)                   # float32 subnormals
    v[3::11] = (rng.integers(-127, 127, v[3::11].shape) + 0.5).astype(
        np.float32)
    v[5::13] = 127.0
    v[::97] = np.inf
    v[1::101] = -np.inf
    v[2::17] = 0.0
    return v


@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("kind", ["chunked", "panels", "special", "tiny"])
def test_quantize_chunk_values_matches_reference(kind, vdtype):
    """Byte-equal values and scales on a chunked and a panelled layout (the
    panels hold empty padding chunks), with the values replaced by ties,
    subnormals and infinities ("special"), or scaled into the subnormal
    range, where a scale rounds to 0 ("tiny"); an all-zero chunk takes
    scale 1.0."""
    mat = JF.csr_to_spc5(JM.fem_blocks(600, 4, 6, seed=2), 4, 8)
    lay = (JF.to_chunked(mat, cb=8) if kind == "chunked"
           else JF.to_panels(mat, pr=64, cb=8, xw=64))
    values = lay.values.astype(np.float32)
    rng = np.random.default_rng(4)
    if kind == "special":
        values = _special_values(values.shape[0], rng)
    elif kind == "tiny":
        values = values * np.float32(1e-42)
    first = int(lay.chunk_vbase.ravel()[0])
    values[first:first + lay.vmax] = 0.0         # chunk 0 all zero
    want_q, want_s = JF.quantize_chunk_values(values, lay.chunk_vbase,
                                              lay.chunk_mask, vdtype)
    got_q, got_s = TF.quantize_chunk_values(values, lay.chunk_vbase,
                                            lay.chunk_mask, vdtype)
    assert _bits(got_q).tobytes() == _bits(want_q).tobytes()
    if vdtype == "bf16":
        assert got_s is None and want_s is None
        return
    assert got_s.dtype == want_s.dtype == np.float32
    assert got_s.shape == want_s.shape == lay.chunk_vbase.shape
    assert got_s.tobytes() == want_s.tobytes()
    if kind != "special":
        assert got_s.ravel()[0] == 1.0


def test_quantize_handles_empty_chunks_and_no_values():
    """No chunk holds a value: every scale is 1.0 and every value 0."""
    masks = np.zeros((3, 4), np.uint32)
    q, s = TF.quantize_chunk_values(np.ones(24, np.float32),
                                    np.array([0, 8, 16], np.int32), masks,
                                    "int8")
    assert not q.any() and (s == 1.0).all() and s.shape == (3,)


# ----------------------------------------------------------------------------
# plans
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plans_byte_equal(layout, lowering, vdtype):
    """Arrays (values at their width, int8 scales trailing), meta and the
    test layout's multi sub-plan, byte for byte; the plan's ``dev`` view
    leaves the scale out, as the reference's does."""
    _, jmat, tmat = make_mat()
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype, tune=False,
              **GEOM[layout])
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    assert_plans_byte_equal(tplan, jplan)
    inner = tplan.multi if layout == "test" else tplan
    assert inner.vdtype == vdtype
    assert inner.values.dtype == {"bf16": torch.bfloat16,
                                  "int8": torch.int8}[vdtype]
    if vdtype == "int8":
        assert inner.value_scale is inner.arrays[-1]
        assert len(inner.dev) == len(inner.arrays) - 1
    if layout == "test":
        assert tplan.single_values.dtype == (
            torch.bfloat16 if vdtype == "bf16" else torch.float32)


def test_auto_layout_flips_on_width():
    """At nvec 16 a 20,000 x 20,000 matrix's x and y take (2 * 20,000) * 4
    * 16 bytes > 2 MiB at f32 (panels) and half that at bf16 (whole
    vector), in both packages."""
    rng = np.random.default_rng(3)
    n = 20_000
    rows = np.repeat(np.arange(n), 3)
    cols = rng.integers(0, n, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0])
    layouts = {}
    for vdtype in ("f32", "bf16"):
        jmat = JF.csr_to_spc5(JF.csr_from_coo((n, n), rows, cols, vals), 2, 4)
        tmat = TF.csr_to_spc5(TF.csr_from_coo((n, n), rows, cols, vals), 2, 4)
        kw = dict(vdtype=vdtype, nvec=16, lowering="mask", tune=False)
        jplan = jops.prepare(jmat, **kw)
        tplan = tops.prepare(tmat, device="cpu", **kw)
        assert_plans_byte_equal(tplan, jplan)
        layouts[vdtype] = tplan.layout
    assert layouts == {"f32": "panels", "bf16": "whole_vector"}


@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_plan_from_arrays_takes_quantised_reference_plans(layout, vdtype):
    """A quantised JAX plan, whole or as its layout, arrays and meta (bf16
    as ``ml_dtypes`` arrays, known by their dtype name), gives the port the
    same bytes and the reference's product."""
    _, jmat, tmat = make_mat()
    jplan = jops.prepare(jmat, layout=layout, lowering="descriptor",
                         vdtype=vdtype, tune=False, **GEOM[layout])
    whole = TP.plan_from_arrays(jplan, device="cpu")
    assert_plans_byte_equal(whole, jplan)
    children = [jplan.multi] if layout == "test" else ()
    parts = TP.plan_from_arrays(jplan.layout, jplan.arrays, jplan.meta,
                                children=children, device="cpu")
    assert_plans_byte_equal(parts, jplan)
    x = np.random.default_rng(2).standard_normal(tmat.ncols).astype(
        np.float32)
    y = tops.spmv(whole, torch.from_numpy(x))
    assert_close(y, jops.spmv(jplan, jnp.asarray(x), use_pallas=False))


# ----------------------------------------------------------------------------
# products
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_spmv_matches_reference_and_pins(layout, lowering, vdtype):
    """y of the port's quantised plan against the reference's same plan
    through its jnp oracle and its Pallas kernels in interpret mode, both
    buffers, and within the pins of the f64 product of the f32 matrix."""
    dense, jmat, tmat = make_mat()
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype, tune=False,
              **GEOM[layout])
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    x = np.random.default_rng(1).standard_normal(dense.shape[1]).astype(
        np.float32)
    y_ora = jops.spmv(jplan, jnp.asarray(x), use_pallas=False)
    y_pal = jops.spmv(jplan, jnp.asarray(x), use_pallas=True,
                      interpret=True)
    ref = dense.astype(np.float64) @ x.astype(np.float64)
    for db in (True, False):
        y = tops.spmv(tplan, torch.from_numpy(x), double_buffer=db)
        assert y.dtype == torch.float32 and y.shape == (dense.shape[0],)
        assert_close(y, y_ora)
        assert_close(y, y_pal)
        assert np.all(np.abs(y.numpy() - ref)
                      <= error_bound(dense, x, vdtype))


@pytest.mark.parametrize("vdtype", VDTYPES)
@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_spmm_matches_reference_and_pins(layout, lowering, vdtype):
    """Y at nvec 4 against the reference's same plan (jnp oracle and Pallas
    interpret mode where the reference has a kernel for the layout) and
    within the pins of the f64 product."""
    dense, jmat, tmat = make_mat()
    kw = dict(layout=layout, lowering=lowering, vdtype=vdtype, tune=False,
              nvec=4, **GEOM[layout])
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    X = np.random.default_rng(3).standard_normal((dense.shape[1], 4)).astype(
        np.float32)
    refs = [jops.spmm(jplan, jnp.asarray(X), use_pallas=False)]
    if layout != "test":
        refs.append(jops.spmm(jplan, jnp.asarray(X), use_pallas=True,
                              interpret=True))
    ref = dense.astype(np.float64) @ X.astype(np.float64)
    bound = np.stack([error_bound(dense, X[:, j], vdtype)
                      for j in range(4)], axis=1)
    for db in (True, False):
        Y = tops.spmm(tplan, torch.from_numpy(X), double_buffer=db)
        assert Y.dtype == torch.float32 and Y.shape == (dense.shape[0], 4)
        for y_ref in refs:
            assert_close(Y, y_ref)
        assert np.all(np.abs(Y.numpy() - ref) <= bound)


@pytest.mark.parametrize("vdtype", VDTYPES)
def test_sparse_linear_default_layer_is_quantised(vdtype):
    """``SparseLinear.from_dense(vdtype=...)`` at the default layer's
    arguments (auto layout and lowering, nvec 128) builds the reference's
    plan, and its forward matches the reference's at batch 1 and 5."""
    w = np.random.default_rng(7).standard_normal((2_100, 256)).astype(
        np.float32)
    kw = dict(density=0.1, vdtype=vdtype, tune=False)
    from repro.core import sparse_linear as JL
    tl = SparseLinear.from_dense(w, device="cpu", **kw)
    jl = JL.SparseLinear.from_dense(w, **kw)
    assert_plans_byte_equal(tl.plan, jl.handle)
    x = np.random.default_rng(8).standard_normal((5, 256)).astype(np.float32)
    for xb in (x[:1], x):
        y = tl(torch.from_numpy(xb))
        assert y.dtype == torch.float32
        assert_close(y, jl(jnp.asarray(xb), use_pallas=False))


@pytest.mark.parametrize("vdtype", VDTYPES)
def test_prepare_takes_a_configs_vdtype(vdtype):
    """``prepare(config=...)`` reads ``config.vdtype`` as the reference
    does; an explicit ``vdtype`` wins over it."""
    from repro.core import selector as JS
    _, jmat, tmat = make_mat()
    cfg = JS.PanelConfig(layout="panels", pr=32, xw=32, cb=8,
                         lowering="descriptor", vdtype=vdtype)
    jplan = jops.prepare(jmat, config=cfg, tune=False)
    tplan = tops.prepare(tmat, config=cfg, tune=False, device="cpu")
    assert tplan.vdtype == vdtype
    assert_plans_byte_equal(tplan, jplan)
    other = "int8" if vdtype == "bf16" else "bf16"
    assert tops.prepare(tmat, config=cfg, vdtype=other, tune=False,
                        device="cpu").vdtype == other


# ----------------------------------------------------------------------------
# the wrappers on the CPU and the kernels' shared-memory figures
# ----------------------------------------------------------------------------

def test_wrappers_check_the_value_store():
    """int8 values need their scale, of the plan's (npanels, nchunks) shape
    and float32; a scale with f32 or bf16 values is refused, as the port
    scales int8 values only."""
    _, _, tmat = make_mat()
    plan = tops.prepare(tmat, layout="panels", lowering="descriptor",
                        vdtype="int8", tune=False, device="cpu",
                        **GEOM["panels"])
    x = torch.zeros(tmat.ncols)
    args = (plan.chunk_vbase, plan.chunk_xbase, plan.desc_valid,
            plan.desc_vidx, plan.desc_xcol, plan.desc_yrow)
    kw = dict(r=plan.r, c=plan.c, cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
              pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    fn = KD.spmv_cuda_panels_desc_db
    with pytest.raises(ValueError, match="value_scale"):
        fn(*args, plan.values, x, **kw)
    with pytest.raises(ValueError, match="shape"):
        fn(*args, plan.values, x, None, plan.value_scale[:1], **kw)
    with pytest.raises(TypeError, match="float32"):
        fn(*args, plan.values, x, None, plan.value_scale.double(), **kw)
    with pytest.raises(NotImplementedError, match="int8"):
        fn(*args, plan.values.to(torch.bfloat16), x, None, plan.value_scale,
           **kw)
    y = fn(*args, plan.values, x, None, plan.value_scale, **kw)
    assert y.dtype == torch.float32 and not y.any()


def _r16(n):
    return -(-n // 16) * 16


def _spmv_smem_copy(stages, nb, r, c, vmax, xw, pr, wv, wx, vsize):
    """A copy of ``stage_layout`` / ``panels_smem`` in
    ``csrc/spc5_spmv_desc.cu`` with ``value_window`` of
    ``csrc/spc5_stage.cuh``."""
    rc = r * c
    window = _r16(vsize * vmax) + (16 if vsize < 4 else 0)
    stage = (window + _r16(4 * xw) + _r16(nb * rc) + _r16(nb * rc * wv)
             + _r16(nb * c * wx) + _r16(4 * nb))
    return _r16(4 * pr) + stages * stage


def _spmm_smem_copy(stages, q, nb, r, c, vmax, prows, tw, wv, wx, vsize):
    """A copy of ``panel_layout`` / ``panel_smem`` in
    ``csrc/spc5_spmm_desc.cu``."""
    rc = r * c
    window = _r16(vsize * vmax) + (16 if vsize < 4 else 0)
    stage = (q * window + _r16(4 * q) + (_r16(8 * q) if vsize < 4 else 0)
             + _r16(nb * rc) + _r16(nb * rc * wv) + _r16(nb * c * wx)
             + _r16(4 * nb) + 16)
    return _r16(4 * prows * tw) + stages * stage + 16 * nb + _r16(4 * nb)


@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("geom", [(64, 4, 8, 312, 512, 512, 2, 2),
                                  (64, 2, 4, 176, 512, 512, 2, 2),
                                  (8, 8, 4, 40, 64, 64, 1, 1),
                                  (320, 4, 8, 10_240, 1_024, 64, 2, 2)])
@pytest.mark.parametrize("stages", [1, 2, 3])
def test_spmv_panel_smem_matches_a_copy(stages, geom, vsize):
    """``panels_smem_bytes`` of the panel descriptor SpMV pair at 4-, 2-
    and 1-byte values, and its value window's width."""
    assert KD.panels_smem_bytes(stages, *geom, vsize) == \
        _spmv_smem_copy(stages, *geom, vsize)
    vmax = geom[3]
    assert KD.value_window_bytes(vmax, vsize) == (
        4 * vmax if vsize == 4 else _r16(vsize * vmax) + 16)


@pytest.mark.parametrize("vsize", [4, 2, 1])
@pytest.mark.parametrize("geom", [(2, 128, 4, 8, 312, 128, 128, 2, 2),
                                  (1, 64, 2, 4, 176, 512, 16, 2, 2),
                                  (3, 12, 8, 4, 40, 64, 1, 1, 1)])
@pytest.mark.parametrize("stages", [1, 2])
def test_spmm_panel_smem_matches_a_copy(stages, geom, vsize):
    """``panels_smem_bytes`` of the panel descriptor SpMM pair at 4-, 2-
    and 1-byte values."""
    assert KDM.panels_smem_bytes(stages, *geom, vsize) == \
        _spmm_smem_copy(stages, *geom, vsize)


@pytest.mark.parametrize("vsize", [2, 1])
def test_narrow_values_plan_no_larger_stages(vsize):
    """The default layer's stages shrink with the values: the SpMV pair's
    ring and the SpMM pair's plan at nvec 128 never need more shared
    memory than at f32."""
    geom = dict(cb=64, r=4, c=8, vmax=312, xw=512, pr=512, wv=2, wx=2)
    for stages in (1, KD.DB_STAGES):
        assert (KD.panels_stages(stages, *geom.values(), vsize=vsize)[2]
                < KD.panels_stages(stages, *geom.values())[2])
    for stages in (1, KDM.PANEL_DB_STAGES):
        f32 = KDM.panels_plan(stages, 64, 4, 8, 312, 512, 128, 4, 2, 2)
        q = KDM.panels_plan(stages, 64, 4, 8, 312, 512, 128, 4, 2, 2,
                            vsize=vsize)
        assert q["smem_bytes"] <= f32["smem_bytes"]
