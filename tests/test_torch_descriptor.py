"""The port's descriptor lowering against the JAX package's.

Host side: ``chunk_descriptors``, the byte models and ``lowering_cost`` must
give the reference's bytes and numbers; descriptor plans built by both
packages from the same matrix with the same explicit arguments
(``tune=False``) must hold byte-equal arrays, dtypes included, and equal
layout-pass traces. Device side: the port's plain ``spmv_desc`` /
``spmv_panels_desc`` and its four wrappers on the CPU (which take the plain
version) are held against the reference's Pallas descriptor kernels in
interpret mode and its jnp oracles, on inputs made with numpy from a seed.

Tolerance for outputs: ``rtol=1e-5``, ``atol=1e-5 * max|y_ref|`` (the f32
products of a row are summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import plan as JP
from repro.core import selector as JS
from repro.core import sparse_linear as JL
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import ref_spmv as TR
from repro_torch.core.sparse_linear import SparseLinear
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmv_desc as KD

RTOL = 1e-5
GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=64, xw=64, cb=16)}
LAYOUTS = ("whole_vector", "panels")


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * max(float(np.abs(y_ref).max()),
                                               1e-30))


def assert_arrays_byte_equal(tplan, jplan):
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        j = np.asarray(j)
        if t.dtype == torch.bfloat16:     # bf16 as bit patterns, both sides
            t, j = t.view(torch.int16), j.view(np.int16)
        t = t.cpu().numpy()
        if j.dtype == np.uint32:          # masks travel as an int32 view
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def _mats(d, rc):
    return (JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
            TF.csr_to_spc5(TF.csr_from_dense(d), *rc))


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


# ----------------------------------------------------------------------------
# host tables and byte models
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("slice_lanes", [None, 100])
@pytest.mark.parametrize("col_map", [False, True])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_chunk_descriptors_byte_equal(layout, rc, col_map, slice_lanes,
                                      monkeypatch):
    """Same tables, dtypes included, for every block shape, on whole-vector
    and panel arrays, with and without a folded column map; ``slice_lanes``
    cuts the port's expansion into many slices (one slice otherwise)."""
    if slice_lanes is not None:
        monkeypatch.setattr(TF, "DESC_SLICE_LANES", slice_lanes)
    d = _random((302, 260), 0.08, 10 * rc[0] + rc[1])
    jmat, tmat = _mats(d, rc)
    if layout == "panels":
        jl, tl = (JF.to_panels(jmat, pr=64, cb=16, xw=64),
                  TF.to_panels(tmat, pr=64, cb=16, xw=64))
        bounds = dict(vmax=tl.vmax, xmax=tl.xw, ymax=tl.pr)
    else:
        jl, tl = JF.to_chunked(jmat, cb=16), TF.to_chunked(tmat, cb=16)
        bounds = dict(vmax=tl.vmax, xmax=tl.ncols, ymax=tl.nrows)
    cmap = (np.random.default_rng(1).permutation(bounds["xmax"])
            if col_map else None)
    jd = JF.chunk_descriptors(jl.chunk_mask, jl.chunk_voff, jl.chunk_col,
                              jl.chunk_row, r=rc[0], c=rc[1], col_map=cmap,
                              **bounds)
    td = TF.chunk_descriptors(tl.chunk_mask, tl.chunk_voff, tl.chunk_col,
                              tl.chunk_row, r=rc[0], c=rc[1], col_map=cmap,
                              **bounds)
    for name in ("valid", "vidx", "xcol", "yrow"):
        j, t = getattr(jd, name), getattr(td, name)
        assert t.dtype == j.dtype and t.shape == j.shape, name
        assert t.tobytes() == j.tobytes(), name
    assert td.lane_nbytes == jd.lane_nbytes
    assert td.valid.dtype == np.int8


@pytest.mark.parametrize("value,want", [
    (0, np.int8), (127, np.int8), (128, np.int16), (32_767, np.int16),
    (32_768, np.int32), (2**31 - 1, np.int32)])
def test_narrow_index_dtype_boundaries(value, want):
    assert TF.narrow_index_dtype(value) == np.dtype(want)
    assert TF.narrow_index_dtype(value) == JF.narrow_index_dtype(value)


@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_byte_models_and_lowering_cost_match_reference(rc):
    r, c = rc
    for bounds in [(8, 8, 8), (128, 129, 32_768), (32_769, 40_000, 128),
                   (1_016, 4_096, 64_000)]:
        assert (TF.descriptor_lane_nbytes(*bounds)
                == JF.descriptor_lane_nbytes(*bounds))
    assert TF.DESC_WORDS_PER_LANE == JF.DESC_WORDS_PER_LANE
    assert (TF.descriptor_table_bytes(594_069, r, c)
            == JF.descriptor_table_bytes(594_069, r, c))
    for avg in (1.0, 3.96, 6.0, 16.0, float(r * c)):
        for lowering in ("mask", "descriptor"):
            for s_float, lane in ((4, None), (8, 11), (2, 7)):
                assert (TF.spmv_bytes_per_nnz(r, c, avg, lowering, s_float,
                                              desc_lane_nbytes=lane)
                        == JF.spmv_bytes_per_nnz(r, c, avg, lowering,
                                                 s_float,
                                                 desc_lane_nbytes=lane))
            for itemsize in (1, 2, 4, 8):
                assert (TP.lowering_cost(r, c, avg, itemsize, lowering)
                        == JP.lowering_cost(r, c, avg, itemsize, lowering))


def test_lowering_cost_picks_descriptor_for_the_smoke_matrices():
    """The FEM matrix (beta(4,4), Avg 16, float64 values) and the vocab
    weight (beta(4,8), Avg 3.96, f32): the cost model prefers descriptors,
    in both packages."""
    for (r, c, avg, item) in [(4, 4, 16.0, 8), (4, 8, 3.96, 4)]:
        for pkg in (TP, JP):
            costs = {lo: pkg.lowering_cost(r, c, avg, item, lo)
                     for lo in ("mask", "descriptor")}
            assert min(costs, key=costs.get) == "descriptor"


# ----------------------------------------------------------------------------
# plans
# ----------------------------------------------------------------------------

def _fem_pair(rc):
    return (JF.csr_to_spc5(JM.fem_blocks(1_200, 4, 6, seed=3), *rc),
            TF.csr_to_spc5(TM.fem_blocks(1_200, 4, 6, seed=3), *rc))


@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_descriptor_plan_matches_reference(layout, rc):
    jmat, tmat = _fem_pair(rc)
    jplan = jops.prepare(jmat, layout=layout, lowering="descriptor",
                         tune=False, **GEOM[layout])
    tplan = tops.prepare(tmat, layout=layout, lowering="descriptor",
                         tune=False, device="cpu", **GEOM[layout])
    assert tplan.lowering == "descriptor"
    assert_arrays_byte_equal(tplan, jplan)
    assert dict(tplan.meta) == dict(jplan.meta)
    assert type(tplan.dev).__name__ == type(jplan.dev).__name__
    assert tplan.dev._fields == jplan.dev._fields
    x = _x(tmat.ncols)
    y_ora = jops.spmv(jplan, jnp.asarray(x), use_pallas=False)
    for db in (True, False):
        y = tops.spmv(tplan, torch.from_numpy(x), double_buffer=db)
        assert y.dtype == torch.float32 and y.shape == (tmat.nrows,)
        assert_close(y, y_ora)


@pytest.mark.parametrize("lowering", ["mask", "descriptor", "auto"])
@pytest.mark.parametrize("case", [
    dict(layout="whole_vector", tune=False),
    dict(layout="panels", tune=False, pr=64, xw=64, cb=16),
    dict(layout="auto", tune=False),
    dict(layout="auto", tune=True),
])
def test_layout_trace_matches_reference(case, lowering):
    jmat, tmat = _fem_pair((2, 4))
    jt = jops.prepare(jmat, lowering=lowering, **case).trace
    tt = tops.prepare(tmat, lowering=lowering, device="cpu", **case).trace
    assert [sorted(e) for e in tt] == [sorted(e) for e in jt]
    assert _strip(tt) == _strip(jt)
    layout_pass = next(e for e in tt if e["pass"] == "layout")
    if lowering == "auto":
        assert layout_pass["lowering_reason"] == "cost-model"


@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_auto_lowering_resolves_like_reference(rc):
    jmat, tmat = _fem_pair(rc)
    jplan = jops.prepare(jmat, lowering="auto", tune=False)
    tplan = tops.prepare(tmat, lowering="auto", tune=False, device="cpu")
    assert (tplan.layout, tplan.lowering) == (jplan.layout, jplan.lowering)
    assert _strip(tplan.trace) == _strip(jplan.trace)
    assert_arrays_byte_equal(tplan, jplan)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_plan_from_arrays_on_a_jax_descriptor_plan(layout):
    jmat, tmat = _fem_pair((4, 8))
    jplan = jops.prepare(jmat, layout=layout, lowering="descriptor",
                         tune=False, **GEOM[layout])
    tplan = TP.plan_from_arrays(layout, jplan.arrays, jplan.meta,
                                device="cpu")
    assert_arrays_byte_equal(tplan, jplan)
    assert tplan.lowering == "descriptor"
    own = tops.prepare(tmat, layout=layout, lowering="descriptor",
                       tune=False, device="cpu", **GEOM[layout])
    x = _x(tmat.ncols)
    y = tops.spmv(tplan, torch.from_numpy(x))
    assert torch.equal(y, tops.spmv(own, torch.from_numpy(x)))
    assert_close(y, jops.spmv(jplan, jnp.asarray(x), use_pallas=False))
    with pytest.raises(ValueError, match="arrays"):
        TP.plan_from_arrays(layout, jplan.arrays[:-1], jplan.meta,
                            device="cpu")


def test_prepare_config_with_descriptor_lowering():
    jmat, tmat = _fem_pair((4, 4))
    cfg = JS.PanelConfig(layout="panels", pr=64, xw=64, cb=16,
                         lowering="descriptor")
    jplan = jops.prepare(jmat, config=cfg)
    tplan = tops.prepare(tmat, config=cfg, device="cpu")
    assert (tplan.layout, tplan.lowering) == ("panels", "descriptor")
    assert_arrays_byte_equal(tplan, jplan)
    assert _strip(tplan.trace) == _strip(jplan.trace)


def test_unknown_lowering_is_a_value_error():
    _, tmat = _fem_pair((1, 4))
    with pytest.raises(ValueError, match="did you mean 'descriptor'"):
        tops.prepare(tmat, lowering="descriptr", device="cpu")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_spmm_on_a_descriptor_plan_matches_reference(layout):
    """SpMM on a descriptor plan runs (the descriptor SpMM kernels are
    ported) and raises only where the reference raises: an nvec that is
    not a multiple of min(nvt, nvec), and, in the port, an X on another
    device than the plan."""
    jmat, tmat = _fem_pair((2, 4))
    plan = tops.prepare(tmat, layout=layout, lowering="descriptor",
                        tune=False, device="cpu", **GEOM[layout])
    jplan = jops.prepare(jmat, layout=layout, lowering="descriptor",
                         tune=False, **GEOM[layout])
    x = np.random.default_rng(2).standard_normal((tmat.ncols, 4)).astype(
        np.float32)
    assert_close(tops.spmm(plan, torch.from_numpy(x)),
                 jops.spmm(jplan, jnp.asarray(x), use_pallas=False))
    with pytest.raises(ValueError, match="not divisible"):
        tops.spmm(plan, torch.zeros(tmat.ncols, 6), nvt=4)
    with pytest.raises(ValueError, match="not divisible"):
        jops.spmm(jplan, jnp.zeros((tmat.ncols, 6)), use_pallas=True,
                  interpret=True, nvt=4)
    with pytest.raises(ValueError, match="device"):
        tops.spmm(plan, torch.zeros(tmat.ncols, 4, device="meta"))


@pytest.mark.parametrize("lowering", ["descriptor", "auto"])
def test_sparse_linear_descriptor_matches_reference(lowering):
    """A descriptor (or auto) layer builds and runs, batch 1 and wider, as
    the reference's does, with f32, bf16 and int8 values (byte-equal plans,
    int8 scales included)."""
    w = np.random.default_rng(0).standard_normal((40, 32)).astype(np.float32)
    kw = dict(density=0.5, block=(2, 4), lowering=lowering, tune=False)
    layer = SparseLinear.from_dense(w, device="cpu", **kw)
    ref = JL.SparseLinear.from_dense(w, **kw)
    assert layer.plan.lowering == ref.handle.lowering
    assert_arrays_byte_equal(layer.plan, ref.handle)
    x = np.random.default_rng(1).standard_normal((3, 32)).astype(np.float32)
    for xb in (x, x[0]):
        assert_close(layer(torch.from_numpy(xb)).numpy(),
                     ref(jnp.asarray(xb), use_pallas=False))
    for vdtype in ("bf16", "int8"):
        layer = SparseLinear.from_dense(w, device="cpu", vdtype=vdtype, **kw)
        ref = JL.SparseLinear.from_dense(w, vdtype=vdtype, **kw)
        assert layer.plan.vdtype == ref.handle.vdtype == vdtype
        assert_arrays_byte_equal(layer.plan, ref.handle)
        for xb in (x, x[0]):
            y = layer(torch.from_numpy(xb))
            assert y.dtype == torch.float32
            assert_close(y.numpy(), ref(jnp.asarray(xb), use_pallas=False))


# ----------------------------------------------------------------------------
# plain versions and wrappers against the Pallas kernels
# ----------------------------------------------------------------------------

def _jax_plan(d, rc, layout, geom):
    return jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
                        layout=layout, lowering="descriptor", tune=False,
                        **geom)


def _jax_y(jplan, x, double_buffer):
    xj = jnp.asarray(x)
    return (jops.spmv(jplan, xj, use_pallas=True, interpret=True,
                      double_buffer=double_buffer),
            jops.spmv(jplan, xj, use_pallas=False))


def _plain(plan, x):
    if plan.layout == "panels":
        return TR.spmv_panels_desc(plan.dev, x, pr=plan.pr, nrows=plan.nrows,
                                   ncols_pad=plan.ncols_pad)
    return TR.spmv_desc(plan.dev, x, nrows=plan.nrows)


@pytest.mark.parametrize("double_buffer", [True, False])
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
@pytest.mark.parametrize("layout", LAYOUTS)
def test_plain_desc_matches_pallas(layout, rc, double_buffer):
    """302x260 (nrows % r != 0 for r in (4, 8)), several chunks and panels,
    bit-31 masks for 4x8 and 8x4."""
    d = _random((302, 260), 0.08, 10 * rc[0] + rc[1] + 1)
    x = _x(260, seed=rc[0] + rc[1])
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                         layout=layout, lowering="descriptor", tune=False,
                         device="cpu", **GEOM[layout])
    if layout == "panels":
        assert tplan.npanels > 1 and tplan.nchunks > 1
    y = _plain(tplan, torch.from_numpy(x))
    y_pal, y_ora = _jax_y(_jax_plan(d, rc, layout, GEOM[layout]), x,
                          double_buffer)
    assert y.dtype == torch.float32 and y.shape == (302,)
    assert_close(y, y_pal)
    assert_close(y, y_ora)
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


KERNELS = ("spmv_cuda_desc", "spmv_cuda_desc_db", "spmv_cuda_panels_desc",
           "spmv_cuda_panels_desc_db")


def _wrapper_args(kernel, rc=(4, 8)):
    layout = "panels" if "panels" in kernel else "whole_vector"
    d = _random((302, 260), 0.08, 2)
    x = torch.from_numpy(_x(260, seed=3))
    plan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                        layout=layout, lowering="descriptor", tune=False,
                        device="cpu", **GEOM[layout])
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
def test_desc_wrapper_on_cpu_runs_plain_version_and_launches_nothing(kernel):
    args, x, kw, plain, d = _wrapper_args(kernel)
    before = dict(KD.LAUNCHES)
    y = getattr(KD, kernel)(*args, x, **kw)
    assert torch.equal(y, plain)
    assert KD.LAUNCHES == before
    assert_close(y, d.astype(np.float64) @ x.numpy().astype(np.float64))


@pytest.mark.parametrize("kernel", KERNELS)
def test_desc_wrapper_rejects_unported_operands(kernel):
    args, x, kw, _, _ = _wrapper_args(kernel)
    fn = getattr(KD, kernel)
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
def test_desc_wrapper_takes_tables_only_as_built(kernel):
    """A widened (or otherwise retyped) table raises instead of being
    converted; so do a wrong shape and a strided table."""
    args, x, kw, _, _ = _wrapper_args(kernel)
    fn = getattr(KD, kernel)
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


def _width_case(table, width, layout):
    """A matrix and geometry whose ``table`` narrows to ``width`` bits:
    vidx is bounded by vmax (cb), xcol by ncols or xw, yrow by nrows or pr.
    Returns (dense matrix, block shape, geometry)."""
    small = 4 if width == 8 else (1_280 if width == 32 else None)
    if table == "vidx":
        # 4 blocks of 32 hold at most 128 values; 1,280 full blocks of 32
        # hold 40,960 (a window that still fits one CTA on the card)
        d = (_random((64, 4_096), 1.0, 7) if width == 32
             else _random((120, 100), 0.3, 7))
        geom = (dict(cb=small) if layout == "whole_vector"
                else dict(pr=64, xw=1_024, cb=small))
        if small is None:
            geom = dict(GEOM[layout])
        return d, (4, 8), geom
    big = {8: 100, 16: 1_000, 32: 40_000}[width]
    if table == "xcol":
        d = _random((60, big), min(1.0, 300 / big), 8)
        geom = (dict(cb=16) if layout == "whole_vector"
                else dict(pr=64, xw=big, cb=16))
    else:
        d = _random((big, 60), min(1.0, 300 / big), 9)
        geom = (dict(cb=16) if layout == "whole_vector"
                else dict(pr=big, xw=64, cb=16))
    return d, (2, 4), geom


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("table", ["vidx", "xcol", "yrow"])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_every_table_width_matches_reference(layout, table, width):
    """Each index table at each of its three widths: the same bytes as the
    reference's plan, and the wrapper's output (the plain version, on the
    CPU) within tolerance of the reference's jnp oracle."""
    d, rc, geom = _width_case(table, width, layout)
    jplan = _jax_plan(d, rc, layout, geom)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), *rc),
                         layout=layout, lowering="descriptor", tune=False,
                         device="cpu", **geom)
    assert getattr(tplan, f"desc_{table}").dtype == getattr(
        torch, f"int{width}")
    assert_arrays_byte_equal(tplan, jplan)
    x = _x(d.shape[1], seed=width)
    y = tops.spmv(tplan, torch.from_numpy(x))
    assert_close(y, jops.spmv(jplan, jnp.asarray(x), use_pallas=False))
    assert_close(y, d.astype(np.float64) @ x.astype(np.float64))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("kind", ["empty", "last_row_only", "left_columns"])
def test_desc_edge_matrices_match_pallas(kind, layout):
    """No nonzero at all; one nonzero in the last row and column (nrows %
    r != 0); nonzeros only in the first columns, so the panel layout's
    ncols_pad (16) is below ncols (29)."""
    d = np.zeros((37, 29), np.float32)
    if kind == "last_row_only":
        d[36, 28] = 2.0
    elif kind == "left_columns":
        d[::3, :9] = np.random.default_rng(6).standard_normal((13, 9))
    x = _x(29, seed=7)
    geom = dict(pr=16, xw=16, cb=4) if layout == "panels" else dict(cb=4)
    tplan = tops.prepare(TF.csr_to_spc5(TF.csr_from_dense(d), 8, 4),
                         layout=layout, lowering="descriptor", tune=False,
                         device="cpu", **geom)
    if layout == "panels" and kind == "left_columns":
        assert tplan.ncols_pad < 29
    y = tops.spmv(tplan, torch.from_numpy(x))
    y_pal, _ = _jax_y(_jax_plan(d, (8, 4), layout, geom), x, True)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_pal), rtol=RTOL,
                               atol=RTOL)
    np.testing.assert_allclose(y.numpy(), d.astype(np.float64) @ x,
                               rtol=RTOL, atol=RTOL)


def test_unregistered_lowering_is_demoted_like_reference(monkeypatch):
    """A layout that registers only the mask lowering demotes a descriptor
    request to "mask" and says so in the trace, in both packages."""
    import dataclasses
    jmat, tmat = _fem_pair((2, 4))
    for pkg in (TP, JP):
        spec = pkg._REGISTRY["panels"]
        monkeypatch.setitem(pkg._REGISTRY, "panels", dataclasses.replace(
            spec, lowerings=("mask",)))
    jplan = jops.prepare(jmat, layout="panels", lowering="descriptor",
                         tune=False, **GEOM["panels"])
    tplan = tops.prepare(tmat, layout="panels", lowering="descriptor",
                         tune=False, device="cpu", **GEOM["panels"])
    entry = next(e for e in tplan.trace if e["pass"] == "layout")
    assert entry["lowering"] == "mask" and entry["lowering_demoted"]
    assert entry["lowering_demoted_reason"] == "unregistered-lowering"
    assert _strip(tplan.trace) == _strip(jplan.trace)
    assert_arrays_byte_equal(tplan, jplan)


def test_descriptor_prepare_without_device_needs_a_card():
    _, tmat = _fem_pair((1, 4))
    if torch.cuda.is_available():
        plan = tops.prepare(tmat, lowering="descriptor", tune=False)
        assert plan.device.type == "cuda" and plan.desc_valid.is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tops.prepare(tmat, lowering="descriptor", tune=False)
