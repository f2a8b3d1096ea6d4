"""The port's reorder pass against the JAX package's, on the host.

Byte-equal, with the same numpy inputs made from a seed: the formats helpers
(``spc5_to_coo``, ``spc5_to_csr``, ``as_csr``, ``count_panel_chunks``),
``structure.profile`` (every field), ``reorder.reorder`` for every strategy,
alias, "none" and "auto" (declines and ``decline=False`` too), and every
plan a reorder builds: each layout (whole-vector, panels, ``test`` over
either multi layout) x both lowerings x f32 / bf16 / int8, its arrays,
``col_perm``, ``row_iperm``, ``rows_fused``, ``is_reordered``,
``strategy``, ``stats`` and the trace's reorder and build entries (without
``duration_s``). Rows fuse in two of the cases: RCM at r = 1 (the
whole-vector ``chunk_row`` fold) and a permutation of whole panels (the
panel layout's).

The matrices: a scrambled band, FEM blocks, a power-law graph, random
rectangles both ways, one with an empty row, one with no nonzero, and
``nrows % r != 0``.
"""
import types

import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import reorder as JR
from repro.core import structure as JS
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import reorder as TR
from repro_torch.core import structure as TS
from repro_torch.kernels import ops as tops


def _random(shape, density, seed, empty_row=None):
    rng = np.random.default_rng(seed)
    d = ((rng.random(shape) < density)
         * rng.standard_normal(shape)).astype(np.float32)
    if empty_row is not None:
        d[empty_row] = 0.0
    return d


def _dense_pair(d):
    return JF.csr_from_dense(d), TF.csr_from_dense(d)


def _gen(name):
    """(reference CSR, port CSR) of a named test matrix, from one seed."""
    if name == "scrambled_band":
        return (JM.scrambled_banded(600, 8, 1.0, seed=42),
                TM.scrambled_banded(600, 8, 1.0, seed=42))
    if name == "fem":
        return JM.fem_blocks(400, 4, 6, seed=5), TM.fem_blocks(400, 4, 6,
                                                                seed=5)
    if name == "powerlaw":
        return JM.powerlaw(500, 5, seed=3), TM.powerlaw(500, 5, seed=3)
    if name == "wide":
        return _dense_pair(_random((90, 330), 0.05, 1))
    if name == "tall":
        return _dense_pair(_random((330, 90), 0.05, 2))
    if name == "empty_row":
        return _dense_pair(_random((150, 150), 0.06, 3, empty_row=77))
    if name == "no_nonzero":
        return _dense_pair(np.zeros((40, 30), np.float32))
    if name == "ragged":                     # nrows % r != 0 for r in 2, 4, 8
        return _dense_pair(_random((203, 170), 0.05, 4))
    raise KeyError(name)


MATRICES = ("scrambled_band", "fem", "powerlaw", "wide", "tall", "empty_row",
            "no_nonzero", "ragged")
BLOCKS = ((1, 8), (2, 4), (4, 8))
STRATEGIES = ("none", "identity", "sigma", "sell", "sigma_sort", "rcm",
              "bandwidth", "colwindow", "columns", "colwise", "auto")
GEOM = dict(pr=64, xw=64, cb=8)


def _mats(name, rc):
    j, t = _gen(name)
    return JF.csr_to_spc5(j, *rc), TF.csr_to_spc5(t, *rc)


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


# ----------------------------------------------------------------------------
# formats helpers and the structure profile
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("rc", BLOCKS)
@pytest.mark.parametrize("name", MATRICES)
def test_formats_helpers_match_the_reference(name, rc):
    jm, tm = _mats(name, rc)
    for a, b in zip(JF.spc5_to_coo(jm), TF.spc5_to_coo(tm)):
        _same(a, b)
    for jc, tc in ((JF.spc5_to_csr(jm), TF.spc5_to_csr(tm)),
                   (JF.as_csr(jm), TF.as_csr(tm))):
        assert jc.shape == tc.shape
        for f in ("rowptr", "colidx", "values"):
            _same(getattr(jc, f), getattr(tc, f))
    j, t = _gen(name)
    assert TF.as_csr(t) is t
    for pr, cb, xw in ((64, 8, 64), (32, 4, 16), (512, 64, 512)):
        _same(JF.count_panel_chunks(jm, pr=pr, cb=cb, xw=xw),
              TF.count_panel_chunks(tm, pr=pr, cb=cb, xw=xw))


def test_csr_from_coo_sums_duplicates_and_clears_negative_zero():
    """The port's sort-based duplicate sum gives the reference's bytes,
    duplicates and a -0.0 value included."""
    rows = np.array([3, 0, 3, 1, 0, 2], np.int64)
    cols = np.array([1, 2, 1, 0, 2, 2], np.int64)
    vals = np.array([1.5, -0.0, 2.0, -0.0, 3.0, 4.0], np.float32)
    for r, c, v in ((rows, cols, vals), (rows[[1, 3, 5]], cols[[1, 3, 5]],
                                          vals[[1, 3, 5]])):
        j = JF.csr_from_coo((4, 3), r, c, v)
        t = TF.csr_from_coo((4, 3), r, c, v)
        for f in ("rowptr", "colidx", "values"):
            _same(getattr(j, f), getattr(t, f))


@pytest.mark.parametrize("as_spc5", [False, True])
@pytest.mark.parametrize("name", MATRICES)
def test_profile_matches_the_reference(name, as_spc5):
    j, t = _gen(name)
    if as_spc5:
        j, t = JF.csr_to_spc5(j, 2, 4), TF.csr_to_spc5(t, 2, 4)
    for kw in ({}, dict(blocks=((4, 4),), r=1, c=8, pr=32, xw=64, cb=4)):
        a, b = JS.profile(j, **kw), TS.profile(t, **kw)
        for f in ("nrows", "ncols", "nnz", "nnz_row_mean", "nnz_row_max",
                  "bandwidth_mean", "bandwidth_max", "diag_frac",
                  "diag_dominance", "block_fill", "nchunks_total", "r", "c",
                  "pr", "xw", "cb"):
            assert getattr(a, f) == getattr(b, f), f
        _same(a.panel_chunks, b.panel_chunks)
        assert a.summary() == b.summary()
        assert a.chunks_per_panel_mean == b.chunks_per_panel_mean


# ----------------------------------------------------------------------------
# reorder()
# ----------------------------------------------------------------------------

def _assert_same_reordering(a, b):
    _same(a.row_perm, b.row_perm)
    _same(a.col_perm, b.col_perm)
    assert a.strategy == b.strategy and a.stats == b.stats
    _same(a.row_iperm, b.row_iperm)
    _same(a.col_iperm, b.col_iperm)
    assert (a.identity_rows, a.identity_cols, a.is_identity) == (
        b.identity_rows, b.identity_cols, b.is_identity)


@pytest.mark.parametrize("decline", [True, False])
@pytest.mark.parametrize("rc", BLOCKS)
@pytest.mark.parametrize("name", MATRICES)
def test_reorder_matches_the_reference(name, rc, decline):
    """Every strategy and alias, "none" and "auto", from the converted
    matrix and (at the block shape given) from CSR."""
    jm, tm = _mats(name, rc)
    jc, tc = _gen(name)
    for strategy in STRATEGIES:
        a = JR.reorder(jm, strategy, decline=decline, **GEOM)
        b = TR.reorder(tm, strategy, decline=decline, **GEOM)
        _assert_same_reordering(a, b)
        for r in range(1, rc[0] + 1):
            assert a.rows_interval_contiguous(r) == b.rows_interval_contiguous(r)
    a = JR.reorder(jc, "auto", r=rc[0], c=rc[1], decline=decline, **GEOM)
    b = TR.reorder(tc, "auto", r=rc[0], c=rc[1], decline=decline, **GEOM)
    _assert_same_reordering(a, b)
    with pytest.raises(ValueError, match="unknown reorder strategy"):
        TR.reorder(tm, "rmc")


def test_strategies_and_permutes_match_the_reference():
    """The three builders called alone, ``permute_csr`` / ``permute_spc5``
    and the host-side ``apply_x`` / ``unpermute_y``; the contract
    ``A' @ x[col_perm] == (A @ x)[row_perm]``."""
    j, t = _gen("scrambled_band")
    jm, tm = JF.csr_to_spc5(j, 2, 4), TF.csr_to_spc5(t, 2, 4)
    pairs = [(JR.sigma_window_rows(j, sigma=100, pr=32),
              TR.sigma_window_rows(t, sigma=100, pr=32)),
             (JR.rcm_blocks(j, r=2, c=4), TR.rcm_blocks(t, r=2, c=4)),
             (JR.column_window_cluster(j, pr=32),
              TR.column_window_cluster(t, pr=32))]
    w, tw = _gen("wide")
    pairs.append((JR.rcm_blocks(w, r=2, c=4), TR.rcm_blocks(tw, r=2, c=4)))
    x = np.random.default_rng(0).standard_normal(600)
    for a, b in pairs[:3]:
        _assert_same_reordering(a, b)
        pc_j, pc_t = a.permute_csr(j), b.permute_csr(t)
        for f in ("rowptr", "colidx", "values"):
            _same(getattr(pc_j, f), getattr(pc_t, f))
        ps_j, ps_t = a.permute_spc5(jm), b.permute_spc5(tm)
        for f in ("block_rowptr", "block_colidx", "block_masks",
                  "block_voffset", "values"):
            _same(getattr(ps_j, f), getattr(ps_t, f))
        _same(a.apply_x(x), b.apply_x(x))
        _same(a.unpermute_y(x), b.unpermute_y(x))
        dense, pdense = t.to_dense().astype(np.float64), \
            pc_t.to_dense().astype(np.float64)
        np.testing.assert_allclose(pdense @ b.apply_x(x),
                                   (dense @ x)[b.row_perm], rtol=1e-12,
                                   atol=1e-12)
        np.testing.assert_allclose(b.unpermute_y(pdense @ b.apply_x(x)),
                                   dense @ x, rtol=1e-12, atol=1e-12)
    _assert_same_reordering(*pairs[3])
    assert pairs[3][1].identity_cols and not pairs[3][1].identity_rows


def test_permute_spc5_keeps_the_reference_bytes_for_explicit_zeros():
    """An explicit -0.0 value (a CSR built by hand) comes out of the
    permutation as the reference's CSR round trip leaves it (0.0)."""
    rowptr = np.array([0, 2, 3, 5], np.int64)
    colidx = np.array([0, 3, 1, 0, 2], np.int32)
    vals = np.array([1.0, -0.0, 2.0, -0.0, 3.0], np.float32)
    j = JF.CSRMatrix((3, 4), rowptr, colidx, vals)
    t = TF.CSRMatrix((3, 4), rowptr, colidx, vals)
    reo_j = JR.Reordering(np.array([2, 0, 1]), np.array([3, 1, 0, 2]), "x")
    reo_t = TR.Reordering(np.array([2, 0, 1]), np.array([3, 1, 0, 2]), "x")
    for rc in ((1, 4), (2, 4)):
        a = reo_j.permute_spc5(JF.csr_to_spc5(j, *rc))
        b = reo_t.permute_spc5(TF.csr_to_spc5(t, *rc))
        for f in ("block_rowptr", "block_colidx", "block_masks",
                  "block_voffset", "values"):
            _same(getattr(a, f), getattr(b, f))


# ----------------------------------------------------------------------------
# plans
# ----------------------------------------------------------------------------

def _bits(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _without_durations(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


def _trace_entries(plan):
    return [e for e in _without_durations(plan.trace)
            if e["pass"] in ("reorder", "build")]


def assert_plans_equal(tplan, jplan, top=True):
    assert tplan.layout == jplan.layout
    assert tuple(tplan.meta) == tuple(jplan.meta)
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        t, j = _bits(t), _bits(j)
        if j.dtype == np.uint32:
            t = t.view(np.uint32)
        assert t.dtype == j.dtype and t.shape == j.shape
        assert t.tobytes() == j.tobytes()
    for name in ("col_perm", "row_iperm"):
        t, j = getattr(tplan, name), getattr(jplan, name)
        assert (t is None) == (j is None), name
        if t is not None:
            assert t.dtype == torch.int32
            _same(t.numpy(), np.asarray(j))
    assert tplan.rows_fused == jplan.rows_fused
    assert tplan.is_reordered == jplan.is_reordered
    assert tplan.strategy == jplan.strategy
    assert tplan.stats == jplan.stats
    assert _trace_entries(tplan) == _trace_entries(jplan)
    assert len(tplan.children) == len(jplan.children)
    for tc, jc in zip(tplan.children, jplan.children):
        assert_plans_equal(tc, jc, top=False)


def _panel_rows_reordering(package, nrows, ncols, pr, seed=3):
    """A permutation of whole pr-row panels (the partial last panel kept
    last), columns untouched: the panel layout fuses it."""
    full = nrows // pr
    panels = np.random.default_rng(seed).permutation(full)
    rows = np.concatenate([np.arange(p * pr, (p + 1) * pr) for p in panels]
                          + [np.arange(full * pr, nrows)]).astype(np.int64)
    return package.Reordering(rows, np.arange(ncols, dtype=np.int64),
                              "custom", {"note": 1.0})


LAYOUTS = ("whole_vector", "panels", "test_whole", "test_panels")
REORDERS = ("rcm", "colwindow", "auto", "panel_rows", "prebuilt")


def _plan_kw(layout):
    if layout.startswith("test"):
        return dict(layout="test", multi_layout=layout[5:].replace(
            "whole", "whole_vector"), **GEOM)
    return dict(layout=layout, **(GEOM if layout == "panels"
                                  else dict(cb=8)))


def _reorder_args(reorder, name, jm):
    """The reorder request for each package: a name, or the reference's
    and the port's Reordering objects (the port takes the reference's)."""
    if reorder == "panel_rows":
        return (_panel_rows_reordering(JR, jm.nrows, jm.ncols, 64),
                _panel_rows_reordering(TR, jm.nrows, jm.ncols, 64))
    if reorder == "prebuilt":
        reo = JR.reorder(jm, "rcm", **GEOM)
        return reo, reo            # the reference's object, read by attribute
    return reorder, reorder


@pytest.mark.parametrize("vdtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("reorder", REORDERS)
def test_reordered_plans_match_the_reference(reorder, layout, lowering,
                                             vdtype):
    name, rc = ("scrambled_band", (1, 8))
    jm, tm = _mats(name, rc)
    jreo, treo = _reorder_args(reorder, name, jm)
    kw = dict(_plan_kw(layout), lowering=lowering, vdtype=vdtype, tune=False)
    jplan = jops.prepare(jm, reorder=jreo, **kw)
    tplan = tops.prepare(tm, reorder=treo, device="cpu", **kw)
    assert_plans_equal(tplan, jplan)
    applied = {e["pass"]: e for e in tplan.trace}["reorder"]["applied"]
    assert applied == (reorder != "auto" or jplan.strategy != "")


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("rc", BLOCKS)
@pytest.mark.parametrize("name", MATRICES)
def test_every_matrix_reorders_like_the_reference(name, rc, layout):
    """"auto" and "rcm" on every matrix and block shape, both lowerings
    (f32): declines, row-only and column permutations alike."""
    jm, tm = _mats(name, rc)
    for reorder in ("auto", "rcm"):
        for lowering in ("mask", "descriptor"):
            kw = dict(_plan_kw(layout), lowering=lowering, tune=False,
                      reorder=reorder)
            assert_plans_equal(tops.prepare(tm, device="cpu", **kw),
                               jops.prepare(jm, **kw))


def test_rows_fuse_where_the_reference_fuses_them():
    """RCM at r = 1 fuses the rows into the whole-vector chunk_row; a
    permutation of whole panels into the panel layout's stacked arrays;
    the descriptor whole-vector build folds the columns into xcol too."""
    jm, tm = _mats("scrambled_band", (1, 8))
    whole = tops.prepare(tm, layout="whole_vector", lowering="descriptor",
                         reorder="rcm", tune=False, device="cpu", cb=8)
    assert whole.rows_fused and whole.row_iperm is None
    assert whole.col_perm is None and whole.is_reordered
    mask = tops.prepare(tm, layout="whole_vector", lowering="mask",
                        reorder="rcm", tune=False, device="cpu", cb=8)
    assert mask.rows_fused and mask.col_perm is not None
    pan = tops.prepare(tm, layout="panels", lowering="mask", tune=False,
                       device="cpu", reorder=_panel_rows_reordering(
                           TR, 600, 600, 64), **GEOM)
    assert pan.rows_fused and pan.row_iperm is None and pan.col_perm is None
    assert pan.strategy == "custom" and pan.stats == {"note": 1.0}
    trace = {e["pass"]: e for e in pan.trace}
    assert trace["reorder"]["applied"] and trace["build"]["rows_fused"]


def test_make_plan_takes_strategies_reorderings_and_refuses_bad_shapes():
    jm, tm = _mats("tall", (2, 4))
    for reorder in (None, "none", "identity"):
        plan = TP.make_plan(tm, device="cpu", layout="panels", tune=False,
                            reorder=reorder, **GEOM)
        assert not plan.is_reordered and plan.strategy == ""
        want = {} if reorder is None else {"applied": 0.0, "declined": 0.0}
        assert plan.stats == want
    reo = TR.identity((5, 5))
    with pytest.raises(ValueError, match="reordering is for shape"):
        TP.make_plan(tm, device="cpu", reorder=reo, tune=False)
    duck = types.SimpleNamespace(row_perm=np.arange(330)[::-1],
                                 col_perm=np.arange(90), strategy="mine",
                                 stats={"k": 2.0})
    plan = TP.make_plan(tm, device="cpu", layout="panels", tune=False,
                        reorder=duck, **GEOM)
    assert plan.strategy == "mine" and plan.stats == {"k": 2.0}
    assert plan.row_iperm is not None and plan.col_perm is None
    converted = TP.as_reordering(duck)
    assert isinstance(converted, TR.Reordering)
    assert converted.row_perm.dtype == np.int64


def test_config_reorder_is_taken_and_an_explicit_reorder_wins():
    jm, tm = _mats("scrambled_band", (1, 8))
    cfg = types.SimpleNamespace(layout="panels", pr=64, xw=64, cb=8,
                                lowering="descriptor", reorder="rcm",
                                vdtype="")
    plan = tops.prepare(tm, config=cfg, tune=False, device="cpu")
    assert plan.strategy == "rcm"
    assert_plans_equal(plan, jops.prepare(jm, layout="panels",
                                          lowering="descriptor",
                                          reorder="rcm", tune=False, **GEOM))
    other = tops.prepare(tm, config=cfg, reorder="colwindow", tune=False,
                         device="cpu")
    assert other.strategy == "colwindow"
