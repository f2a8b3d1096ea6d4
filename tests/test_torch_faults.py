"""Two faults of the port against the reference, repaired and pinned with
both packages.

* A reordered reference plan keeps its permutation outside its arrays and
  meta (``SPC5Plan.col_perm``, ``row_iperm``, ``rows_fused``). The port
  refused such a plan until it had the reorder pass (ROADMAP queue 1, item
  5b); ``plan_from_arrays`` and ``SparseLinear.from_arrays`` now carry it
  across, given by keywords or whole (a test plan's permutations with its
  parent), and compute the reference's product. A plan whose reorder pass
  declined computes as the reference does too.
* ``ops.prepare`` and ``plan.make_plan`` take the reference's ``reorder``,
  ``store`` and ``verify`` keywords: each builds the reference's plan
  (``reorder`` since ROADMAP queue 1 item 5b, ``store`` and ``verify``
  since items 6 and 7; a store's records carry the port's backend).

The matrix is a 96 x 96 band of half-width 3 with its rows and columns
shuffled, in beta(2,4) with the mask lowering: a reordering has something
to undo on it. Tolerance for outputs: ``rtol=1e-5``, ``atol=1e-5 *
max|y_ref|`` (the f32 sums of a row are taken in another order).
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import sparse_linear as JL
from repro.kernels import ops as jops
from repro_torch.core import formats as TF
from repro_torch.core import plan as TP
from repro_torch.core import sparse_linear as TL
from repro_torch.kernels import ops as tops

RTOL = 1e-5
GEOM = {"panels": dict(pr=32, xw=32, cb=8), "whole_vector": dict(cb=8)}


def _banded(n=96, half=3, seed=0):
    rng = np.random.default_rng(seed)
    d = np.zeros((n, n), np.float32)
    for i in range(n):
        lo, hi = max(0, i - half), min(n, i + half + 1)
        d[i, lo:hi] = rng.standard_normal(hi - lo)
    return d[rng.permutation(n)][:, rng.permutation(n)]


def _jplan(reorder, layout="panels", d=None):
    d = _banded() if d is None else d
    return jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), 2, 4),
                        layout=layout, lowering="mask", reorder=reorder,
                        tune=False, **GEOM[layout])


def _jlayer(reorder, layout="panels"):
    return JL.SparseLinear.from_dense(_banded(), block=(2, 4), layout=layout,
                                      lowering="mask", reorder=reorder,
                                      tune=False, **GEOM[layout])


def assert_close(y, y_ref):
    y_ref = np.asarray(y_ref)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=RTOL,
                               atol=RTOL * float(np.abs(y_ref).max()))


def _keywords(plan):
    return dict(col_perm=plan.col_perm, row_iperm=plan.row_iperm,
                rows_fused=plan.rows_fused)


# ----------------------------------------------------------------------------
# F1: reordered reference plans, once refused, are carried across
# ----------------------------------------------------------------------------

def _xs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(96).astype(np.float32),
            rng.standard_normal((96, 5)).astype(np.float32))


@pytest.mark.parametrize("how", ["keywords", "whole"])
@pytest.mark.parametrize("reorder", ["rcm", "colwindow", "auto"])
def test_plan_from_arrays_refuses_a_reordered_plan(reorder, how):
    """rcm, colwindow and auto (which picks colwindow here) all permute
    this panel plan. The port refused it until the reorder pass was
    ported; it now takes it, with its permutation by keywords or as the
    plan whole, and computes the reference's product (SpMV and SpMM)."""
    jplan = _jplan(reorder)
    assert jplan.is_reordered
    if how == "whole":
        tplan = TP.plan_from_arrays(jplan, device="cpu")
    else:
        tplan = TP.plan_from_arrays(jplan.layout, jplan.arrays, jplan.meta,
                                    device="cpu", **_keywords(jplan))
    assert tplan.is_reordered
    x, xm = _xs()
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 jops.spmv(jplan, jnp.asarray(x), use_pallas=False))
    assert_close(tops.spmm(tplan, torch.from_numpy(xm)),
                 jops.spmm(jplan, jnp.asarray(xm), use_pallas=False))
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 _banded().astype(np.float64) @ x)


@pytest.mark.parametrize("how", ["keywords", "whole"])
@pytest.mark.parametrize("reorder", ["rcm", "colwindow", "auto"])
def test_sparse_linear_from_arrays_refuses_a_reordered_layer(reorder, how):
    """The reordered reference layer, once refused, comes across and
    computes the reference layer's forward."""
    layer = _jlayer(reorder)
    h = layer.handle
    assert h.is_reordered
    if how == "whole":
        tl = TL.SparseLinear.from_arrays(h, bias=layer.bias, device="cpu")
    else:
        tl = TL.SparseLinear.from_arrays(h.layout, h.arrays, h.meta,
                                         layer.bias, device="cpu",
                                         **_keywords(h))
    x = np.random.default_rng(4).standard_normal((3, 96)).astype(np.float32)
    assert_close(tl(torch.from_numpy(x)),
                 layer(jnp.asarray(x), use_pallas=False))


@pytest.mark.parametrize("which", ["col_perm", "row_iperm", "rows_fused"])
def test_each_permutation_keyword_alone_is_refused(which):
    """Any one of the three is taken alone, and applied: a plan of the
    declined reorder with one of them set by hand computes the matrix with
    that permutation (a reversed column or row order; rows_fused alone
    permutes nothing, the build having fused nothing)."""
    jplan = _jplan("sigma")
    value = True if which == "rows_fused" else np.arange(96)[::-1]
    tplan = TP.plan_from_arrays(jplan.layout, jplan.arrays, jplan.meta,
                                device="cpu", **{which: value})
    layer = TL.SparseLinear.from_arrays(jplan.layout, jplan.arrays,
                                        jplan.meta, device="cpu",
                                        **{which: value})
    assert tplan.is_reordered and layer.plan.is_reordered
    x, _ = _xs()
    d = _banded().astype(np.float64)
    want = {"col_perm": d @ x[::-1], "row_iperm": (d @ x)[::-1],
            "rows_fused": d @ x}[which]
    assert_close(tops.spmv(tplan, torch.from_numpy(x)), want)
    assert_close(layer(torch.from_numpy(x[None]))[0], want)


@pytest.mark.parametrize("layout", ["panels", "whole_vector"])
@pytest.mark.parametrize("how", ["arrays", "keywords", "whole"])
def test_a_declined_reorder_computes_like_the_reference(how, layout):
    """sigma declines on this matrix (nothing improves), so the plan is not
    reordered and the port's plan, given in any of the three ways, computes
    the reference's product (SpMV and SpMM)."""
    jplan = _jplan("sigma", layout)
    assert not jplan.is_reordered
    if how == "whole":
        tplan = TP.plan_from_arrays(jplan, device="cpu")
    else:
        kw = _keywords(jplan) if how == "keywords" else {}
        tplan = TP.plan_from_arrays(jplan.layout, jplan.arrays, jplan.meta,
                                    device="cpu", **kw)
    rng = np.random.default_rng(3)
    x = rng.standard_normal(96).astype(np.float32)
    xm = rng.standard_normal((96, 5)).astype(np.float32)
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 jops.spmv(jplan, jnp.asarray(x), use_pallas=False))
    assert_close(tops.spmm(tplan, torch.from_numpy(xm)),
                 jops.spmm(jplan, jnp.asarray(xm), use_pallas=False))
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 _banded().astype(np.float64) @ x)


def test_a_declined_layer_whole_matches_the_reference_layer():
    layer = _jlayer("sigma")
    assert not layer.handle.is_reordered
    tl = TL.SparseLinear.from_arrays(layer.handle, bias=layer.bias,
                                     device="cpu")
    x = np.random.default_rng(4).standard_normal((3, 96)).astype(np.float32)
    assert_close(tl(torch.from_numpy(x)),
                 layer(jnp.asarray(x), use_pallas=False))


@pytest.mark.parametrize("multi_layout", ["whole_vector", "panels"])
def test_a_test_plan_whole_and_its_child_whole(multi_layout):
    """A reference test plan given whole (its multi sub-plan read by
    attribute too), and by arrays with ``children=[plan.multi]`` whole."""
    d = _banded()
    jplan = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(d), 2, 4),
                         layout="test", multi_layout=multi_layout,
                         lowering="mask", tune=False, **GEOM[multi_layout])
    x = np.random.default_rng(5).standard_normal(96).astype(np.float32)
    want = jops.spmv(jplan, jnp.asarray(x), use_pallas=False)
    for tplan in (TP.plan_from_arrays(jplan, device="cpu"),
                  TP.plan_from_arrays("test", jplan.arrays, jplan.meta,
                                      device="cpu", children=[jplan.multi])):
        assert tplan.multi.layout == multi_layout
        assert_close(tops.spmv(tplan, torch.from_numpy(x)), want)


def test_a_duck_typed_plan_and_a_reordered_child_are_read_by_attribute():
    """Any object with ``layout``, ``arrays`` and ``meta`` is a plan, its
    ``col_perm``, ``row_iperm`` and ``rows_fused`` read where it has them
    (once refused, now carried); so is a child of a test plan. A reordered
    reference test plan brings its permutations with its parent."""
    jplan = _jplan("sigma")
    plain = types.SimpleNamespace(layout=jplan.layout, arrays=jplan.arrays,
                                  meta=jplan.meta)
    tplan = TP.plan_from_arrays(plain, device="cpu")
    assert tplan.layout == "panels" and tplan.nchunks == jplan.nchunks
    assert not tplan.is_reordered
    x, _ = _xs()
    d = _banded().astype(np.float64)
    mapped = types.SimpleNamespace(**vars(plain),
                                   col_perm=np.arange(96)[::-1])
    assert_close(tops.spmv(TP.plan_from_arrays(mapped, device="cpu"),
                           torch.from_numpy(x)), d @ x[::-1])
    jtest = jops.prepare(JF.csr_to_spc5(JF.csr_from_dense(_banded()), 2, 4),
                         layout="test", multi_layout="panels",
                         lowering="mask", reorder="rcm", tune=False,
                         **GEOM["panels"])
    assert jtest.is_reordered and not jtest.multi.is_reordered
    ttest = TP.plan_from_arrays(jtest, device="cpu")
    assert ttest.is_reordered and not ttest.multi.is_reordered
    assert_close(tops.spmv(ttest, torch.from_numpy(x)),
                 jops.spmv(jtest, jnp.asarray(x), use_pallas=False))
    assert_close(tops.spmv(ttest, torch.from_numpy(x)), d @ x)
    with pytest.raises(ValueError, match="not both"):
        TP.plan_from_arrays(jplan, jplan.arrays, jplan.meta, device="cpu")
    with pytest.raises(ValueError, match="arrays and meta"):
        TP.plan_from_arrays("panels", device="cpu")


# ----------------------------------------------------------------------------
# F2: the reference's keywords on prepare and make_plan
# ----------------------------------------------------------------------------

def _mats():
    d = _banded()
    return (JF.csr_to_spc5(JF.csr_from_dense(d), 2, 4),
            TF.csr_to_spc5(TF.csr_from_dense(d), 2, 4))


def test_prepare_takes_the_reference_defaults():
    """A call written for the reference, every keyword at its default,
    builds the plan the reference builds."""
    jmat, tmat = _mats()
    kw = dict(layout="panels", lowering="mask", reorder=None, config=None,
              verify=False, pr=32, xw=32, cb=8, nvec=1, align=8, dtype=None,
              vdtype="auto", store=None, tune=False, multi_layout="auto")
    jplan = jops.prepare(jmat, **kw)
    tplan = tops.prepare(tmat, device="cpu", **kw)
    for t, j in zip(tplan.arrays, jplan.arrays):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
    same = TP.make_plan(tmat, device="cpu", layout="panels", lowering="mask",
                        pr=32, xw=32, cb=8, tune=False, store=None,
                        reorder=None, verify=False)
    assert all(torch.equal(a, b) for a, b in zip(same.arrays, tplan.arrays))


@pytest.mark.parametrize("entry", ["prepare", "make_plan"])
@pytest.mark.parametrize("keyword,value,item", [
    ("reorder", "rcm", "item 5"), ("reorder", "sigma", "item 5"),
    ("store", object(), "item 6"), ("verify", True, "item 7"),
    ("verify", print, "item 7")])
def test_non_default_keywords_raise_naming_their_item(entry, keyword, value,
                                                      item):
    """Each keyword, once refused naming the ROADMAP item that ported it,
    now builds the reference's plan: rcm permutes this matrix, sigma
    declines on it; a store (the reference's records, the port's with
    ``backend="cpu"``) tunes both plans alike; ``verify`` proves the plan
    (True) or hands the report to the callable."""
    from repro.core import selector as JS
    from repro_torch.core import selector as TS
    jmat, tmat = _mats()
    kw = dict(layout="panels", lowering="mask", tune=False, **GEOM["panels"])
    jkw, tkw = dict(kw), dict(kw)
    if keyword == "store":
        best = dict(layout="whole_vector", cb=16, lowering="descriptor")
        jkw, tkw = {}, {}
        jkw["store"], tkw["store"] = JS.RecordStore(), TS.RecordStore()
        for S, st, extra in ((JS, jkw["store"], {}),
                             (TS, tkw["store"], {"backend": "cpu"})):
            f = S.spc5_features(jmat)
            st.add_measurement("2x4", f, S.PanelConfig(**best), 1, 5.0,
                               **extra)
            st.add_measurement("2x4", f, S.PanelConfig(**GEOM["panels"],
                                                       layout="panels"),
                               1, 1.0, **extra)
    elif keyword == "verify":
        seen = []
        jkw["verify"] = tkw["verify"] = (
            value if value is True else lambda rep: seen.append(rep))
    else:
        jkw[keyword] = tkw[keyword] = value
    fn = tops.prepare if entry == "prepare" else TP.make_plan
    tplan = fn(tmat, device="cpu", **tkw)
    jplan = jops.prepare(jmat, **jkw)
    if keyword == "reorder":
        assert tplan.is_reordered == jplan.is_reordered == (value == "rcm")
        assert tplan.stats == jplan.stats and tplan.strategy == jplan.strategy
    elif keyword == "store":
        assert tplan.trace[0]["source"] == jplan.trace[0]["source"] == "store"
        assert (tplan.layout, tplan.lowering) == ("whole_vector",
                                                  "descriptor")
        strip = [{k: v for k, v in e.items() if k != "duration_s"}
                 for e in tplan.trace]
        assert strip == [{k: v for k, v in e.items() if k != "duration_s"}
                         for e in jplan.trace]
    elif value is not True:
        assert len(seen) == 2 and all(rep.ok for rep in seen)
    assert len(tplan.arrays) == len(jplan.arrays)
    for t, j in zip(tplan.arrays, jplan.arrays):
        assert t.numpy().tobytes() == np.asarray(j).tobytes()
