"""The port's beta(r,c)_test layout against the JAX package's.

The split (``formats.split_singletons``), the test plan (its singleton tail,
bucketed by row panel or flat, and its multi-block sub-plan) and the trace
must be byte-equal or equal to the reference's when both packages build
from the same numpy inputs with the same explicit arguments (``tune=False``,
an explicit ``multi_layout`` and ``lowering``). Products through the plan,
through ``SparseLinear`` and through the COO plain versions are held against
the reference's Pallas kernels in interpret mode (``spmv_tail_pallas`` and
the multi kernels) and its jnp oracles. The port runs on the CPU, where the
tail wrapper takes its plain version.

Tolerance for outputs: ``rtol=1e-5``, ``atol=1e-5 * max|y_ref|`` (the f32
products of a row are summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import ref_spmv as JR
from repro.core import sparse_linear as JL
from repro.kernels import ops as jops
from repro.kernels import spc5_spmv as JK
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import ref_spmv as TR
from repro_torch.core.sparse_linear import SparseLinear
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmv_tail as KT

RTOL = 1e-5
GEOM = dict(pr=16, xw=32, cb=8)
LAYOUTS = ("whole_vector", "panels")
LOWERINGS = ("mask", "descriptor")


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


def assert_same_bytes(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert a.tobytes() == b.tobytes()


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


def _random(shape, density, seed):
    rng = np.random.default_rng(seed)
    return ((rng.random(shape) < density)
            * rng.standard_normal(shape)).astype(np.float32)


def _x(n, seed=5):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _csr_pair(kind):
    """The same CSR from each package: ``random`` (302 x 260, nrows % r != 0
    for r = 4, 8), two SET_A picks (``in-2004``: power-law rows, the
    paper's web class; ``ns3Da``: scattered), ``all_single`` (one nonzero
    per row, columns 8 apart: every block a singleton) and ``no_single``
    (dense: no singleton for any block shape)."""
    if kind == "random":
        d = _random((302, 260), 0.08, 0)
        return JF.csr_from_dense(d), TF.csr_from_dense(d)
    if kind == "all_single":
        n = 200
        rows = np.arange(n)
        cols = np.random.default_rng(1).permutation(n) * 8
        vals = np.random.default_rng(2).standard_normal(n)
        return (JF.csr_from_coo((n, 8 * n), rows, cols, vals),
                TF.csr_from_coo((n, 8 * n), rows, cols, vals))
    if kind == "no_single":
        return JM.dense(64, seed=4), TM.dense(64, seed=4)
    return JM.SET_A[kind](), TM.SET_A[kind]()


# ----------------------------------------------------------------------------
# the split
# ----------------------------------------------------------------------------

SPLIT_KINDS = ("random", "in-2004", "ns3Da", "all_single", "no_single")


@pytest.mark.parametrize("kind", SPLIT_KINDS)
@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_split_singletons_byte_equal(rc, kind):
    """The port's vectorised value gather gives the reference's bytes, or
    both packages raise alike."""
    jcsr, tcsr = _csr_pair(kind)
    jmat, tmat = JF.csr_to_spc5(jcsr, *rc), TF.csr_to_spc5(tcsr, *rc)
    try:
        js = JF.split_singletons(jmat)
    except Exception as e:              # pragma: no cover - the packages agree
        with pytest.raises(type(e)):
            TF.split_singletons(tmat)
        return
    ts = TF.split_singletons(tmat)
    for f in ("single_rows", "single_cols", "single_values"):
        assert_same_bytes(getattr(ts, f), getattr(js, f))
    for f in ("block_rowptr", "block_colidx", "block_masks", "block_voffset",
              "values"):
        assert_same_bytes(getattr(ts.multi, f), getattr(js.multi, f))
    assert (ts.multi.shape, ts.multi.r, ts.multi.c) == (js.multi.shape,
                                                        js.multi.r,
                                                        js.multi.c)
    assert ts.nnz == js.nnz == tmat.nnz
    if kind == "all_single":
        assert ts.multi.nblocks == 0 and ts.single_values.size == tmat.nnz
    if kind == "no_single":
        assert ts.single_values.size == 0


# ----------------------------------------------------------------------------
# the COO plain versions
# ----------------------------------------------------------------------------

def _coo(n=120, m=90, nnz=400, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, n, nnz).astype(np.int32),
            rng.integers(0, m, nnz).astype(np.int32),
            rng.standard_normal(nnz).astype(np.float32), n, m)


def test_spmv_coo_matches_reference():
    rows, cols, vals, n, m = _coo()
    x = _x(m)
    y = TR.spmv_coo(*map(torch.from_numpy, (rows, cols, vals, x)), nrows=n)
    assert y.dtype == torch.float32 and y.shape == (n,)
    assert_close(y, JR.spmv_coo(*map(jnp.asarray, (rows, cols, vals, x)),
                                nrows=n))


@pytest.mark.parametrize("nvec", [1, 5, 16])
def test_spmm_coo_matches_reference(nvec):
    rows, cols, vals, n, m = _coo()
    x = np.random.default_rng(4).standard_normal((m, nvec)).astype(np.float32)
    y = TR.spmm_coo(*map(torch.from_numpy, (rows, cols, vals, x)), nrows=n)
    assert y.shape == (n, nvec)
    assert_close(y, JR.spmm_coo(*map(jnp.asarray, (rows, cols, vals, x)),
                                nrows=n))


def test_spmm_coo_slices_wide_batches(monkeypatch):
    """The columns of X go through in slices without changing the sum."""
    rows, cols, vals, n, m = _coo()
    x = np.random.default_rng(4).standard_normal((m, 9)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (rows, cols, vals, x)]
    whole = TR.spmm_coo(*args, nrows=n)
    monkeypatch.setattr(TR, "_SLICE_ELEMS", 2 * len(vals))
    assert torch.equal(TR.spmm_coo(*args, nrows=n), whole)


def _buckets(kind="powerlaw"):
    """Both packages' panel test plans of powerlaw(320, 5, seed=17) in
    beta(2,4) at pr=16, xw=32, cb=8 (the reference's tail test), or of a
    330-row matrix (nrows % pr != 0)."""
    n = 320 if kind == "powerlaw" else 330
    csr = (JM.powerlaw(n, 5, seed=17), TM.powerlaw(n, 5, seed=17))
    kw = dict(layout="test", multi_layout="panels", lowering="mask",
              tune=False, **GEOM)
    return (jops.prepare(JF.csr_to_spc5(csr[0], 2, 4), **kw),
            tops.prepare(TF.csr_to_spc5(csr[1], 2, 4), device="cpu", **kw))


@pytest.mark.parametrize("kind", ["powerlaw", "ragged"])
def test_tail_wrapper_matches_the_pallas_tail_kernel(kind):
    """``spmv_tail_cuda`` on the CPU (its plain version, ``spmv_coo_panels``)
    against ``spmv_tail_pallas`` in interpret mode and the reference's
    ``spmv_coo_panels`` on the same buckets; then the whole test plan
    against the reference executor with the Pallas kernels."""
    jplan, tplan = _buckets(kind)
    n = tplan.nrows
    assert tplan.tail_pr == 16 and tplan.single_values.numel()
    if kind == "ragged":
        assert n % tplan.tail_pr
    x = _x(n)
    jx = jnp.asarray(x)
    y_pallas = JK.spmv_tail_pallas(
        jplan.tail_xbase, jplan.single_rows, jplan.single_cols,
        jplan.single_values, jx, pr=jplan.tail_pr, xw=jplan.tail_xw,
        nrows=n, ncols_pad=jplan.tail_ncols_pad, interpret=True)
    y_oracle = JR.spmv_coo_panels(jplan.single_rows, jplan.single_cols,
                                  jplan.single_values, jx, pr=16, nrows=n)
    y = KT.spmv_tail_cuda(tplan.tail_xbase, tplan.single_rows,
                          tplan.single_cols, tplan.single_values,
                          torch.from_numpy(x), pr=tplan.tail_pr,
                          xw=tplan.tail_xw, nrows=n,
                          ncols_pad=tplan.tail_ncols_pad)
    assert y.shape == (n,) and KT.LAUNCHES["spmv_tail_cuda"] == 0
    assert_close(y, y_pallas)
    assert_close(y, y_oracle)
    assert_close(TR.spmv_coo_panels(tplan.single_rows, tplan.single_cols,
                                    tplan.single_values, torch.from_numpy(x),
                                    pr=16, nrows=n), y_oracle)
    y_exec = tops.spmv_test(tplan, torch.from_numpy(x))
    assert_close(y_exec, jops.spmv_test(jplan, jx, use_pallas=True,
                                        interpret=True))
    assert_close(y_exec, jops.spmv_test(jplan, jx, use_pallas=False))


def test_spmv_coo_panels_drops_rows_outside_the_panel():
    """A row outside [0, pr) adds nothing, as the reference's segment sum
    drops it."""
    rows = np.array([[0, 3, 4, -1], [1, 1, 7, 2]], np.int32)
    cols = np.array([[0, 1, 2, 3], [4, 5, 6, 7]], np.int32)
    vals = np.arange(1, 9, dtype=np.float32).reshape(2, 4)
    x = _x(8)
    y = TR.spmv_coo_panels(*map(torch.from_numpy, (rows, cols, vals, x)),
                           pr=4, nrows=7)
    assert y.shape == (7,)
    assert_close(y, JR.spmv_coo_panels(*map(jnp.asarray,
                                            (rows, cols, vals, x)),
                                       pr=4, nrows=7))


def test_tail_wrapper_checks_its_operands():
    _, tplan = _buckets()
    args = [tplan.tail_xbase, tplan.single_rows, tplan.single_cols,
            tplan.single_values, torch.zeros(tplan.ncols)]
    kw = dict(pr=16, xw=tplan.tail_xw, nrows=tplan.nrows,
              ncols_pad=tplan.tail_ncols_pad)
    bad = list(args)
    bad[3] = bad[3].double()
    with pytest.raises(TypeError, match="float32"):
        KT.spmv_tail_cuda(*bad, **kw)
    bad = list(args)
    bad[0] = bad[0][:-1]
    with pytest.raises(ValueError, match="tail_xbase"):
        KT.spmv_tail_cuda(*bad, **kw)
    with pytest.raises(ValueError, match="cannot hold"):
        KT.spmv_tail_cuda(*args, **{**kw, "nrows": 10_000})
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        KT.spmv_tail_cuda(*meta, **kw)


# ----------------------------------------------------------------------------
# the test plan
# ----------------------------------------------------------------------------

def _fem_pair(rc):
    """fem_blocks(1_200, 4, 6) with every 7th nonzero kept plus a random
    scatter, so that both singletons and multi blocks occur."""
    d = JM.fem_blocks(1_200, 4, 6, seed=3).to_dense()[:, :1_100]
    keep = np.random.default_rng(0).random(d.shape) < 0.3
    d = np.where(keep, d, 0.0) + _random(d.shape, 2e-3, 1)
    return (JF.csr_to_spc5(JF.csr_from_dense(d), *rc),
            TF.csr_to_spc5(TF.csr_from_dense(d), *rc))


def _test_pair(rc, multi_layout, lowering, **kw):
    jmat, tmat = _fem_pair(rc)
    args = dict(layout="test", multi_layout=multi_layout, lowering=lowering,
                tune=False, **GEOM, **kw)
    return (jops.prepare(jmat, **args),
            tops.prepare(tmat, device="cpu", **args))


@pytest.mark.parametrize("lowering", LOWERINGS)
@pytest.mark.parametrize("multi_layout", LAYOUTS)
@pytest.mark.parametrize("rc", [(1, 8), (2, 4), (4, 8)])
def test_test_plan_matches_reference(rc, multi_layout, lowering):
    jplan, tplan = _test_pair(rc, multi_layout, lowering)
    assert tplan.layout == jplan.layout == "test"
    assert tplan.multi.layout == jplan.multi.layout == multi_layout
    assert tplan.lowering == jplan.lowering == lowering
    assert_arrays_byte_equal(tplan, jplan)
    assert_arrays_byte_equal(tplan.multi, jplan.multi)
    assert dict(tplan.meta) == dict(jplan.meta)
    assert dict(tplan.multi.meta) == dict(jplan.multi.meta)
    assert _strip(tplan.trace) == _strip(jplan.trace)
    assert _strip(tplan.multi.trace) == _strip(jplan.multi.trace)
    assert tplan.n_single > 0
    assert bool(tplan.tail_pr) == (multi_layout == "panels")
    x = _x(tplan.ncols)
    y = tops.spmv(tplan, torch.from_numpy(x))
    assert y.shape == (tplan.nrows,)
    assert_close(y, jops.spmv_test(jplan, jnp.asarray(x), use_pallas=False))
    X = np.random.default_rng(7).standard_normal(
        (tplan.ncols, 4)).astype(np.float32)
    Y = tops.spmm(tplan, torch.from_numpy(X))
    assert Y.shape == (tplan.nrows, 4)
    assert_close(Y, jops.spmm(jplan, jnp.asarray(X), use_pallas=False))


@pytest.mark.parametrize("multi_layout", LAYOUTS)
def test_test_plan_spmv_matches_the_pallas_kernels(multi_layout):
    """The reference with every kernel in Pallas interpret mode (the multi
    kernel and, for panel buckets, ``spmv_tail_pallas``) against the port,
    both buffer settings."""
    jplan, tplan = _test_pair((2, 4), multi_layout, "mask")
    x = _x(tplan.ncols)
    for db in (True, False):
        assert_close(tops.spmv_test(tplan, torch.from_numpy(x),
                                    double_buffer=db),
                     jops.spmv_test(jplan, jnp.asarray(x), use_pallas=True,
                                    interpret=True, double_buffer=db))


@pytest.mark.parametrize("multi_layout", LAYOUTS)
def test_test_plan_without_singletons(multi_layout):
    """A dense matrix has no singleton: the tail is empty and the product
    is the multi sub-plan's, in both packages."""
    jmat, tmat = JF.csr_to_spc5(JM.dense(64, seed=4), 2, 4), \
        TF.csr_to_spc5(TM.dense(64, seed=4), 2, 4)
    args = dict(layout="test", multi_layout=multi_layout, lowering="mask",
                tune=False, **GEOM)
    jplan, tplan = jops.prepare(jmat, **args), tops.prepare(
        tmat, device="cpu", **args)
    assert tplan.n_single == 0 and tplan.tail_pr == 0
    assert_arrays_byte_equal(tplan, jplan)
    x = _x(64)
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 jops.spmv_test(jplan, jnp.asarray(x), use_pallas=False))
    X = np.random.default_rng(8).standard_normal((64, 3)).astype(np.float32)
    assert_close(tops.spmm(tplan, torch.from_numpy(X)),
                 jops.spmm(jplan, jnp.asarray(X), use_pallas=False))


@pytest.mark.parametrize("rc", [(1, 8), (2, 4)])
def test_test_layout_equals_dense_product(rc):
    """The split's SpMV is the matrix's product (the reference's
    ``test_beta_test_split_kernel``: powerlaw(600, 5), cb=64)."""
    csr = TM.powerlaw(600, 5, seed=9)
    d = csr.to_dense()
    plan = tops.prepare(TF.csr_to_spc5(csr, *rc), layout="test", cb=64,
                        dtype=np.float32, tune=False, device="cpu")
    assert plan.n_single > 0
    x = np.random.default_rng(1).standard_normal(600).astype(np.float32)
    y = tops.spmv_test(plan, torch.from_numpy(x))
    tgt = d @ x
    np.testing.assert_allclose(y.numpy(), tgt,
                               atol=2e-4 * max(1, np.abs(tgt).max()))


@pytest.mark.parametrize("multi_layout", LAYOUTS)
def test_mask_and_descriptor_test_plans_agree(multi_layout):
    """The lowering goes to the multi sub-plan; the tail is the same."""
    tmat = TF.csr_to_spc5(TM.powerlaw(320, 5, seed=13), 2, 4)
    plans = {lw: tops.prepare(tmat, layout="test", multi_layout=multi_layout,
                              dtype=np.float32, lowering=lw, tune=False,
                              device="cpu", **GEOM) for lw in LOWERINGS}
    assert plans["descriptor"].multi.lowering == "descriptor"
    assert plans["descriptor"].lowering == "descriptor"
    for a, b in zip(plans["mask"].arrays, plans["descriptor"].arrays):
        assert torch.equal(a, b)
    x = torch.from_numpy(_x(320, seed=4))
    assert_close(tops.spmv_test(plans["descriptor"], x),
                 tops.spmv_test(plans["mask"], x))


def test_auto_lowering_and_layout_resolve_in_the_sub_plan():
    """At its defaults the split delegates: the outer trace says so, the
    sub-plan resolves the layout by the 2 MiB rule and the lowering by the
    cost model, as in the reference."""
    jmat, tmat = _fem_pair((2, 4))
    jplan = jops.prepare(jmat, layout="test", tune=False)
    tplan = tops.prepare(tmat, layout="test", tune=False, device="cpu")
    assert _strip(tplan.trace) == _strip(jplan.trace)
    assert _strip(tplan.multi.trace) == _strip(jplan.multi.trace)
    tune, _, layout = tplan.trace[:3]
    assert tune["source"] == "delegated"
    assert layout["lowering_reason"] == "delegated"
    inner = next(e for e in tplan.multi.trace if e["pass"] == "layout")
    assert (inner["reason"], inner["lowering_reason"]) == ("vmem-fit",
                                                          "cost-model")
    assert tplan.lowering == tplan.multi.lowering == jplan.lowering


def test_auto_never_resolves_to_test():
    assert "test" in TP.layout_names()
    assert "test" not in TP._AUTO_ORDER
    for csr in (TM.powerlaw(600, 5, seed=9), TM.banded(300_000, 2, 1.0)):
        for nvec in (1, 128):
            plan = tops.prepare(TF.csr_to_spc5(csr, 1, 8), lowering="mask",
                                nvec=nvec, tune=False, device="cpu")
            assert plan.layout in ("whole_vector", "panels")


# ----------------------------------------------------------------------------
# a JAX plan's bytes in the port, and SparseLinear
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("multi_layout", LAYOUTS)
def test_plan_from_arrays_computes_on_a_jax_test_plan(multi_layout):
    jplan, own = _test_pair((2, 4), multi_layout, "descriptor")
    m = jplan.multi
    tplan = TP.plan_from_arrays("test", jplan.arrays, jplan.meta,
                                device="cpu",
                                children=[(m.layout, m.arrays, m.meta)])
    assert_arrays_byte_equal(tplan, jplan)
    assert_arrays_byte_equal(tplan.multi, jplan.multi)
    x = _x(tplan.ncols)
    y = tops.spmv(tplan, torch.from_numpy(x))
    assert torch.equal(y, tops.spmv(own, torch.from_numpy(x)))
    assert_close(y, jops.spmv_test(jplan, jnp.asarray(x), use_pallas=False))
    layer = SparseLinear.from_arrays("test", jplan.arrays, jplan.meta,
                                     device="cpu",
                                     children=[(m.layout, m.arrays, m.meta)])
    X = np.random.default_rng(2).standard_normal((3, tplan.ncols)).astype(
        np.float32)
    assert_close(layer(torch.from_numpy(X)).numpy().T,
                 jops.spmm(jplan, jnp.asarray(X.T), use_pallas=False))
    with pytest.raises(ValueError, match="sub-plans"):
        TP.plan_from_arrays("test", jplan.arrays, jplan.meta, device="cpu")


@pytest.mark.parametrize("nvec", [1, 128])
def test_sparse_linear_test_layout_matches_reference(nvec):
    """``from_dense(layout="test")`` builds the reference's plan (its multi
    sub-plan whole-vector at nvec=1, panels at nvec=128 by the 2 MiB rule)
    and matches the reference layer at batch 1 and at batch 16."""
    w = np.random.default_rng(4).standard_normal((3000, 1200)).astype(
        np.float32)
    kw = dict(density=0.01, block=(2, 4), layout="test", lowering="mask",
              tune=False, nvec=nvec)
    layer = SparseLinear.from_dense(w, device="cpu", **kw)
    ref = JL.SparseLinear.from_dense(w, **kw)
    assert layer.plan.multi.layout == ref.handle.multi.layout == (
        "whole_vector" if nvec == 1 else "panels")
    assert_arrays_byte_equal(layer.plan, ref.handle)
    assert_arrays_byte_equal(layer.plan.multi, ref.handle.multi)
    x = np.random.default_rng(1).standard_normal((16, 1200)).astype(
        np.float32)
    for xb in (x[:1], x):
        assert_close(layer(torch.from_numpy(xb)).numpy(),
                     ref(jnp.asarray(xb), use_pallas=False))
