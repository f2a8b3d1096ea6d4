"""The port's descriptor SpMM on the CPU, against the JAX package's.

The plain ``spmm_desc`` / ``spmm_panels_desc``, the three wrappers (which
take the plain version for a CPU tensor) and ``ops.spmm`` on descriptor
plans are held against the reference's jnp oracles and its Pallas
descriptor SpMM kernels in interpret mode, on inputs made with numpy from a
seed. The defaults are the reference's (``lowering="auto"``): plans and
``SparseLinear`` layers built with every other argument at its default must
resolve to the same layout and lowering, with the same layout-pass trace and
byte-equal arrays. An explicit ``lowering`` wins over a ``config``'s in both
packages.

Tolerance for outputs: ``rtol=1e-5``, ``atol=1e-5 * max|Y_ref|`` (the f32
products of a row are summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import ref_spmv as JR
from repro.core import selector as JS
from repro.core import sparse_linear as JL
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import ref_spmv as TR
from repro_torch.core import sparse_linear as TL
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv as K

RTOL = 1e-5
GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=64, xw=64, cb=16)}
LAYOUTS = ("whole_vector", "panels")
#: Pallas kernel -> (layout, double_buffer)
PALLAS = {"spmm_pallas_desc": ("whole_vector", False),
          "spmm_pallas_panels_desc": ("panels", False),
          "spmm_pallas_panels_desc_db": ("panels", True)}
KERNELS = ("spmm_cuda_desc", "spmm_cuda_panels_desc",
           "spmm_cuda_panels_desc_db")


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


def assert_arrays_byte_equal(tplan, jplan):
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        j = np.asarray(j)
        t = t.cpu().numpy()
        if j.dtype == np.uint32:          # masks travel as an int32 view
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


def _dense(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def _x(n, nvec, seed=5):
    return np.random.default_rng(seed).standard_normal((n, nvec)).astype(
        np.float32)


def _plans(d, rc, layout, geom, lowering="descriptor"):
    kw = dict(layout=layout, lowering=lowering, tune=False, **geom)
    return (jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc), **kw),
            tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                         device="cpu", **kw))


def _plain(plan, x):
    if plan.layout == "panels":
        return TR.spmm_panels_desc(plan.dev, x, pr=plan.pr, nrows=plan.nrows,
                                   ncols_pad=plan.ncols_pad)
    return TR.spmm_desc(plan.dev, x, nrows=plan.nrows)


def _oracle(jplan, x):
    xj = jnp.asarray(x)
    if jplan.layout == "panels":
        return JR.spmm_panels_desc(jplan.dev, xj, pr=jplan.pr,
                                   nrows=jplan.nrows,
                                   ncols_pad=jplan.ncols_pad)
    return JR.spmm_desc(jplan.dev, xj, nrows=jplan.nrows)


# ----------------------------------------------------------------------------
# plain versions against the Pallas kernels and the jnp oracles
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("nvec", [3, 16])
@pytest.mark.parametrize("pallas", sorted(PALLAS))
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_plain_desc_spmm_matches_pallas(rc, pallas, nvec):
    """302x260 (nrows % r != 0 for r in (4, 8)), several chunks and panels,
    bit-31 masks for 4x8 and 8x4: the plain version, ``ops.spmm`` through
    the plan (the wrapper's CPU route, which must give the plain version's
    bytes), the reference's jnp oracle, its Pallas kernel in interpret mode
    and the float64 product."""
    layout, db = PALLAS[pallas]
    d = _dense((302, 260), 0.08, 10 * rc[0] + rc[1] + 3)
    x = _x(260, nvec, seed=rc[0] + rc[1])
    jplan, tplan = _plans(d, rc, layout, GEOM[layout])
    assert_arrays_byte_equal(tplan, jplan)
    if layout == "panels":
        assert tplan.npanels > 1 and tplan.nchunks > 1
    xt = torch.from_numpy(x)
    y = _plain(tplan, xt)
    assert y.dtype == torch.float32 and y.shape == (302, nvec)
    assert torch.equal(tops.spmm(tplan, xt, double_buffer=db), y)
    y_pal = jops.spmm(jplan, jnp.asarray(x), use_pallas=True, interpret=True,
                      double_buffer=db)
    assert_close(y, y_pal)
    assert_close(y, _oracle(jplan, x))
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["empty", "last_row_only", "left_columns"])
def test_desc_spmm_edge_matrices_match_pallas(kind, layout):
    """No nonzero at all; one nonzero in the last row and column (nrows %
    r != 0); nonzeros only in the first columns, so the panel layout's
    ncols_pad (16) is below ncols (29)."""
    d = np.zeros((37, 29), np.float32)
    if kind == "last_row_only":
        d[36, 28] = 2.0
    elif kind == "left_columns":
        d[::3, :9] = np.random.default_rng(6).standard_normal((13, 9))
    x = _x(29, 5, seed=7)
    geom = dict(pr=16, xw=16, cb=4) if layout == "panels" else dict(cb=4)
    jplan, tplan = _plans(d, (8, 4), layout, geom)
    if layout == "panels" and kind == "left_columns":
        assert tplan.ncols_pad < 29
    y = tops.spmm(tplan, torch.from_numpy(x))
    y_pal = jops.spmm(jplan, jnp.asarray(x), use_pallas=True, interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(y.numpy(), d.astype(np.float64) @ x,
                               rtol=RTOL, atol=RTOL)


def test_plain_panels_desc_spmm_with_a_short_x_adds_nothing_past_it():
    """X with fewer rows than ncols_pad: the reference pads it with zero
    rows; the plain version drops the lanes past X instead, with the same
    result and no copy of X."""
    d = _dense((130, 100), 0.1, 4)
    jplan, tplan = _plans(d, (2, 4), "panels", GEOM["panels"])
    assert tplan.ncols_pad > 90
    x = _x(90, 4, seed=8)
    want = jops.spmm(jplan, jnp.asarray(x), use_pallas=False)
    assert_close(_plain(tplan, torch.from_numpy(x)), want)
    assert_close(_plain(tplan, torch.from_numpy(x)),
                 d[:, :90].astype(np.float64) @ x)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_desc_spmm_slices_wide_batches(layout, monkeypatch):
    """The plain version cuts X's columns into slices once valid lanes x
    columns pass its limit; the slices give the same Y."""
    d = _dense((302, 260), 0.08, 9)
    _, tplan = _plans(d, (2, 4), layout, GEOM[layout])
    x = torch.from_numpy(_x(260, 12))
    whole = _plain(tplan, x)
    monkeypatch.setattr(TR, "_SLICE_ELEMS", int(np.count_nonzero(d)) * 5)
    assert torch.equal(_plain(tplan, x), whole)


def test_plain_desc_spmm_rejects_unported_operands():
    """A per-chunk ``value_scale`` is taken, as in the reference (each
    chunk's values times its scale); so is a fused column permutation
    (``cmap``, once refused): the panel product reads X's row cmap[col] at
    permuted column col."""
    d = _dense((60, 50), 0.2, 1)
    _, whole = _plans(d, (2, 4), "whole_vector", GEOM["whole_vector"])
    _, pan = _plans(d, (2, 4), "panels", GEOM["panels"])
    x = torch.from_numpy(_x(50, 2))
    twice = torch.full((whole.chunk_vbase.shape[0],), 2.0)
    assert torch.allclose(TR.spmm_desc(whole.dev, x, twice, nrows=60),
                          2 * TR.spmm_desc(whole.dev, x, nrows=60))
    cmap = torch.from_numpy(np.random.default_rng(5).permutation(50))
    assert torch.allclose(
        TR.spmm_panels_desc(pan.dev, x, cmap, pr=pan.pr, nrows=60,
                            ncols_pad=pan.ncols_pad),
        torch.from_numpy(d.astype(np.float64) @ x.numpy()[cmap.numpy()]
                         .astype(np.float64)).float(), rtol=1e-5, atol=1e-5)


# ----------------------------------------------------------------------------
# the wrappers on the CPU
# ----------------------------------------------------------------------------

def _wrapper_args(kernel, rc=(4, 8), nvec=6):
    layout = "panels" if "panels" in kernel else "whole_vector"
    d = _dense((302, 260), 0.08, 2)
    x = torch.from_numpy(_x(260, nvec, seed=3))
    _, plan = _plans(d, rc, layout, GEOM[layout])
    dev = plan.dev
    tables = (dev.desc_valid, dev.desc_vidx, dev.desc_xcol, dev.desc_yrow,
              dev.values)
    if layout == "panels":
        args = (dev.chunk_vbase, dev.chunk_xbase) + tables
        kw = dict(r=rc[0], c=rc[1], cb=plan.cb, vmax=plan.vmax, xw=plan.xw,
                  pr=plan.pr, nrows=plan.nrows, ncols_pad=plan.ncols_pad)
    else:
        args = (dev.chunk_vbase,) + tables
        kw = dict(r=rc[0], c=rc[1], cb=plan.cb, vmax=plan.vmax,
                  nrows=plan.nrows, ncols=plan.ncols)
    return args, x, kw, _plain(plan, x), d


@pytest.mark.parametrize("kernel", KERNELS)
def test_desc_spmm_wrapper_on_cpu_runs_plain_version_and_launches_nothing(
        kernel):
    args, x, kw, plain, d = _wrapper_args(kernel)
    before = dict(KDM.LAUNCHES)
    y = getattr(KDM, kernel)(*args, x, **kw)
    assert torch.equal(y, plain)
    assert KDM.LAUNCHES == before
    assert_close(y, d.astype(np.float64) @ x.numpy().astype(np.float64))


@pytest.mark.parametrize("kernel", KERNELS)
def test_desc_spmm_wrapper_keeps_the_nvt_rule(kernel):
    """nvec must be a multiple of min(nvt, nvec), as in the reference;
    nvec=6 with nvt=3 runs, nvt=4 raises, and so does a 1-D X."""
    args, x, kw, plain, _ = _wrapper_args(kernel)
    fn = getattr(KDM, kernel)
    assert torch.equal(fn(*args, x, nvt=3, **kw), plain)
    with pytest.raises(ValueError, match="not divisible"):
        fn(*args, x, nvt=4, **kw)
    with pytest.raises(ValueError, match="2-D"):
        fn(*args, x[:, 0].contiguous(), **kw)


@pytest.mark.parametrize("kernel", KERNELS)
def test_desc_spmm_wrapper_rejects_unported_operands(kernel):
    args, x, kw, _, _ = _wrapper_args(kernel)
    fn = getattr(KDM, kernel)
    with pytest.raises(NotImplementedError, match="int8"):
        fn(*args, x, value_scale=torch.ones(1), **kw)
    if "panels" in kernel:
        # a column map, once refused, is taken on the CPU: the plain version
        # reads x[col_map[column]], what the unmapped call reads of
        # x[col_map]
        cmap = torch.arange(x.shape[0] - 1, -1, -1, dtype=torch.int32)
        assert torch.equal(fn(*args, x, cmap, **kw),
                           fn(*args, x[cmap.long()].contiguous(), **kw))


@pytest.mark.parametrize("kernel", KERNELS)
def test_desc_spmm_wrapper_takes_tables_only_as_built(kernel):
    """A widened (or otherwise retyped) table raises instead of being
    converted; so do a wrong shape, a strided table and a float64 X."""
    args, x, kw, _, _ = _wrapper_args(kernel)
    fn = getattr(KDM, kernel)
    first = 2 if "panels" in kernel else 1       # desc_valid's position
    for i in range(first, first + 4):
        bad = list(args)
        bad[i] = bad[i].to(torch.int32 if bad[i].dtype != torch.int32
                           else torch.int16)
        with pytest.raises(TypeError, match="never widened"):
            fn(*bad, x, **kw)
    with pytest.raises(ValueError, match="shape"):
        fn(*args, x, **dict(kw, cb=kw["cb"] * 2))
    bad = list(args)
    bad[first] = torch.zeros(bad[first].shape + (2,), dtype=torch.int8)[..., 0]
    with pytest.raises(ValueError, match="contiguous"):
        fn(*bad, x, **kw)
    with pytest.raises(TypeError, match="float32"):
        fn(*args, x.double(), **kw)


def test_desc_spmm_shared_memory_plan():
    """The wrappers' reckoning of a CTA's shared memory. Panels (the launch
    plan of ``panels_plan``): the vocab layer's shape (pr=512, cb=64,
    beta(4,8), vmax 2,048, int16 vidx) at nvec 128 takes one 128-column
    tile (four columns a lane) in four row parts, so that two CTAs with a
    ring of two whole chunks fit an SM; an int32 vidx window (vmax 40,960)
    fits the synchronous kernel with its tables in slices and is refused
    double-buffered. (The whole-vector kernel's planning is pinned by
    ``tests/test_torch_spmm_whole.py``.)"""
    cta = KDM.panels_plan(2, 64, 4, 8, 2048, 512, 128, 4, 2, 2)
    assert (cta["blocks_per_stage"], cta["tile_columns"], cta["vector"],
            cta["row_parts"]) == (64, 128, 4, 4)
    smem = cta["smem_bytes"]
    assert smem == KDM.panels_smem_bytes(2, 1, 64, 4, 8, 2048, 128, 128, 2,
                                         2)
    assert 64 * 1024 < smem <= KDM.TWO_CTA_SMEM_BYTES
    cta = KDM.panels_plan(1, 1280, 4, 8, 40960, 64, 16, 4, 4, 2)
    assert cta["blocks_per_stage"] < 1280 and cta["tile_columns"] == 16
    assert cta["smem_bytes"] <= K.MAX_SMEM_BYTES
    with pytest.raises(ValueError, match="shared memory"):
        KDM.panels_plan(2, 1280, 4, 8, 40960, 64, 16, 4, 4, 2)
    for rc in TF.SUPPORTED_BLOCKS:
        KDM._block(*rc)
    with pytest.raises(ValueError, match="beta"):
        KDM._block(1, 2)


# ----------------------------------------------------------------------------
# the plan path and the defaults
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_ops_spmm_on_descriptor_plans_matches_reference(rc, layout):
    """Byte-equal descriptor plans; ``ops.spmm`` in the port against the
    reference's ``ops.spmm(use_pallas=False)``, with both buffer settings
    and nvec 8 in tiles of 4."""
    d = _dense((302, 260), 0.08, 10 * rc[0] + rc[1])
    jplan, tplan = _plans(d, rc, layout, GEOM[layout])
    assert tplan.lowering == jplan.lowering == "descriptor"
    assert_arrays_byte_equal(tplan, jplan)
    assert dict(tplan.meta) == dict(jplan.meta)
    x = _x(260, 8, seed=rc[1])
    want = jops.spmm(jplan, jnp.asarray(x), use_pallas=False)
    for db in (True, False):
        y = tops.spmm(tplan, torch.from_numpy(x), nvt=4, double_buffer=db)
        assert y.dtype == torch.float32 and y.shape == (302, 8)
        assert_close(y, want)


@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_prepare_defaults_to_auto_like_reference(rc):
    """``prepare`` with no ``lowering``: both packages run the cost model
    and build the same plan."""
    d = _dense((302, 260), 0.08, rc[0] * rc[1])
    mats = (JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
            TF.csr_to_spc5(TF.csr_from_dense(d), *rc))
    jplan = jops.prepare(mats[0], tune=False)
    tplan = tops.prepare(mats[1], tune=False, device="cpu")
    entry = next(e for e in tplan.trace if e["pass"] == "layout")
    assert entry["lowering_reason"] == "cost-model"
    assert (tplan.layout, tplan.lowering) == (jplan.layout, jplan.lowering)
    assert _strip(tplan.trace) == _strip(jplan.trace)
    assert_arrays_byte_equal(tplan, jplan)


@pytest.mark.parametrize("lowering,want", [
    ("mask", "mask"), ("auto", "descriptor"), (None, "descriptor")])
def test_explicit_lowering_wins_over_config(lowering, want):
    """``prepare(mat, lowering=..., config=<lowering="descriptor">)``: the
    config's lowering fills only a lowering left at "auto" (or not
    passed), in both packages."""
    d = _dense((302, 260), 0.08, 12)
    jmat = JF.csr_to_spc5(JF.csr_from_dense(d), 4, 8)
    tmat = TF.csr_to_spc5(TF.csr_from_dense(d), 4, 8)
    cfg = JS.PanelConfig(layout="whole_vector", cb=64, lowering="descriptor")
    kw = {} if lowering is None else dict(lowering=lowering)
    jplan = jops.prepare(jmat, config=cfg, tune=False, **kw)
    tplan = tops.prepare(tmat, config=cfg, tune=False, device="cpu", **kw)
    assert tplan.lowering == jplan.lowering == want
    assert (tplan.layout, tplan.cb) == ("whole_vector", 64)
    assert _strip(tplan.trace) == _strip(jplan.trace)
    assert_arrays_byte_equal(tplan, jplan)


@pytest.mark.parametrize("shape,density,want", [
    ((300, 200), 0.2, "whole_vector"), ((3000, 1200), 0.05, "panels")])
def test_sparse_linear_at_all_defaults_matches_reference(shape, density,
                                                         want):
    """``from_dense(w, density=...)`` with every other argument at its
    default (block by eq. 4, layout and lowering "auto", nvec 128, tune on
    with no store): the same layout and lowering by the same trace, byte-
    equal arrays, and batch 1 and batch 4 within tolerance. At 3000 x 1200
    nvec=128 puts the layer on panels and the cost model on descriptors,
    the plan the reference builds for the yi-6b vocab layer."""
    rng = np.random.default_rng(sum(shape))
    w = rng.standard_normal(shape).astype(np.float32)
    jl = JL.SparseLinear.from_dense(w, density=density)
    tl = TL.SparseLinear.from_dense(w, density=density, device="cpu")
    jentry = next(e for e in jl.handle.trace if e["pass"] == "layout")
    tentry = next(e for e in tl.plan.trace if e["pass"] == "layout")
    assert _strip([tentry]) == _strip([jentry])
    assert _strip(tl.plan.trace) == _strip(jl.handle.trace)
    assert (tl.plan.layout, tl.plan.lowering) == (want, "descriptor")
    assert tentry["lowering_reason"] == "cost-model"
    assert_arrays_byte_equal(tl.plan, jl.handle)
    assert dict(tl.plan.meta) == dict(jl.handle.meta)
    x = rng.standard_normal((4, shape[1])).astype(np.float32)
    for xb in (x[:1], x):
        y = tl(torch.from_numpy(xb))
        assert y.shape == (xb.shape[0], shape[0])
        assert_close(y.numpy(), jl(jnp.asarray(xb), use_pallas=False))
