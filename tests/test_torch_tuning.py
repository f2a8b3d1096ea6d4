"""The port's record-store tuning against the JAX package's, on the host:
``ops.prepare(store=...)`` / ``plan.make_plan(store=...)``, the default
store (``selector.set_default_store``, ``$SPC5_RECORDS``),
``sparse_linear.choose_block(csr, store)`` and
``SparseLinear.from_dense(store=...)``.

The reference's store holds the records; the port's holds the same records
with ``backend="cpu"``, the backend of a plan on the host, so both tune
alike: the plans must be byte-equal (bf16 as bit patterns) with equal tune
trace entries (``duration_s`` aside), whole-vector and lowering demotions
included. A store of records of another backend only (``"cuda:..."``, or
``""``: every record loaded from the reference's files) leaves a port plan
untuned ("no-store"), byte-equal to the untuned plan. Products agree to
``rtol=1e-5``, ``atol=1e-5 * max|y_ref|``.
"""
import dataclasses
import os

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
from repro_torch.core import selector as TS
from repro_torch.core import sparse_linear as TL
from repro_torch.kernels import ops as tops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_STORE = os.path.join(REPO, "benchmarks", "records", "spmv_quick.jsonl")
RTOL = 1e-5
CARD = "cuda:NVIDIA H100 80GB HBM3"


@pytest.fixture(autouse=True)
def _no_ambient_store(monkeypatch):
    for S in (JS, TS):
        monkeypatch.delenv(S.RECORDS_ENV, raising=False)
        S.set_default_store(None)
    yield
    for S in (JS, TS):
        S.set_default_store(None)


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
    for tp, jp in ((tplan.col_perm, jplan.col_perm),
                   (tplan.row_iperm, jplan.row_iperm)):
        assert (tp is None) == (jp is None)
        if tp is not None:
            assert np.array_equal(tp.numpy(), np.asarray(jp))
    assert tplan.rows_fused == jplan.rows_fused
    assert len(tplan.children) == len(jplan.children)
    for tc, jc in zip(tplan.children, jplan.children):
        assert_plans_byte_equal(tc, jc)


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


def assert_same_plan(tplan, jplan):
    assert_plans_byte_equal(tplan, jplan)
    assert _strip(tplan.trace) == _strip(jplan.trace)
    for tc, jc in zip(tplan.children, jplan.children):
        assert _strip(tc.trace) == _strip(jc.trace)


def planted(best, worse, kernel, S, backend=None):
    """A store where ``best`` measures strictly faster than ``worse``
    (``backend`` on each record, for the port's store)."""
    st = S.RecordStore()
    r, c = S.kernel_block(kernel)
    extra = {} if backend is None else {"backend": backend}
    for avg in (1.0, 3.0, 6.0):
        f = S.MatrixFeatures(0, 0, 0, 5.0, 2.0, avg, avg / (r * c))
        st.add_measurement(kernel, f, S.PanelConfig(**best), 1, 2.0 + avg,
                           **extra)
        st.add_measurement(kernel, f, S.PanelConfig(**worse), 1, 1.0,
                           **extra)
    return st


def stores(best, worse, kernel, backend="cpu"):
    return (planted(best, worse, kernel, JS),
            planted(best, worse, kernel, TS, backend))


BEST = dict(layout="panels", pr=16, xw=32, cb=8)
WORSE = dict(layout="whole_vector", pr=0, xw=0, cb=256)


def _mats(csr_fn, rc):
    return (JF.csr_to_spc5(csr_fn(JM), *rc), TF.csr_to_spc5(csr_fn(TM), *rc))


def _banded(M):
    return M.banded(400, 5, 1.0, seed=1)


CASES = {
    # (best config, worse config, matrix, block, prepare keywords)
    "panels": (BEST, WORSE, _banded, (2, 8), {}),
    "whole": (dict(layout="whole_vector", cb=64), BEST, _banded, (2, 8), {}),
    "descriptor": (dict(layout="panels", pr=32, xw=64, cb=16,
                        lowering="descriptor"),
                   dict(layout="panels", pr=32, xw=64, cb=16), _banded,
                   (2, 8), {}),
    "explicit-lowering-wins": (dict(layout="panels", pr=32, xw=64, cb=16,
                                    lowering="descriptor"), WORSE, _banded,
                               (2, 8), dict(lowering="mask")),
    "bf16": (dict(layout="whole_vector", cb=64, vdtype="bf16"),
             dict(layout="whole_vector", cb=64), _banded, (2, 8), {}),
    "int8": (dict(layout="panels", pr=32, xw=32, cb=8, vdtype="int8",
                  lowering="descriptor"), WORSE, _banded, (2, 8), {}),
    "f32-pick": (dict(layout="whole_vector", cb=32, vdtype="f32"),
                 dict(layout="whole_vector", cb=32, vdtype="bf16"), _banded,
                 (2, 8), {}),
    "reorder": (dict(layout="panels", pr=32, xw=32, cb=8, reorder="rcm"),
                WORSE, lambda M: M.scrambled_banded(320, 4, 0.9, seed=5),
                (2, 4), {}),
    "clamped": (dict(layout="panels", pr=2048, xw=4096, cb=512), WORSE,
                lambda M: M.banded(8, 2, 1.0, seed=2), (2, 8), {}),
    # the whole-vector pick past the reference's budget at nvec=128
    "whole-demoted": (dict(layout="whole_vector", pr=0, xw=0, cb=512),
                      BEST, lambda M: M.banded(2400, 4, 1.0, seed=9), (1, 8),
                      dict(nvec=128)),
    "other-kernel": (BEST, WORSE, _banded, (4, 4), {}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_prepare_with_a_store_builds_the_reference_plan(case):
    best, worse, csr_fn, rc, kw = CASES[case]
    js, ts = stores(best, worse, "2x8")
    jmat, tmat = _mats(csr_fn, rc)
    jplan = jops.prepare(jmat, store=js, **kw)
    tplan = tops.prepare(tmat, store=ts, device="cpu", **kw)
    assert tplan.trace[0]["source"] == "store"
    assert_same_plan(tplan, jplan)
    if case == "whole-demoted":
        assert tplan.trace[0]["demoted"] is True
        assert tplan.trace[0]["demoted_reason"] == "vmem-budget"
        assert (tplan.layout, tplan.pr, tplan.xw, tplan.cb) == ("panels",
                                                                512, 512, 64)
    x = np.random.default_rng(0).standard_normal(tmat.ncols).astype(
        np.float32)
    assert_close(tops.spmv(tplan, torch.from_numpy(x)),
                 jops.spmv(jplan, jnp.asarray(x), use_pallas=False))


def test_make_plan_with_a_store_matches_the_reference():
    js, ts = stores(BEST, WORSE, "2x8")
    jmat, tmat = _mats(_banded, (2, 8))
    tplan = TP.make_plan(tmat, device="cpu", store=ts)
    assert_same_plan(tplan, JP.make_plan(jmat, store=js))
    assert (tplan.layout, tplan.pr, tplan.xw, tplan.cb) == ("panels", 16, 32,
                                                            8)


def test_lowering_demotion_is_traced_like_the_reference(monkeypatch):
    """A tuned lowering the layout did not register is demoted to "mask"
    by ``clamp_config``, and the tune entry says so (the registries of both
    packages patched alike, as tests/test_verify.py does)."""
    for P in (JP, TP):
        spec = P._REGISTRY[P.LAYOUT_PANELS]
        monkeypatch.setitem(P._REGISTRY, P.LAYOUT_PANELS,
                            dataclasses.replace(spec, lowerings=("mask",)))
    best = dict(layout="panels", pr=32, xw=64, cb=16, lowering="descriptor")
    js, ts = stores(best, WORSE, "2x8")
    jmat, tmat = _mats(_banded, (2, 8))
    tplan = tops.prepare(tmat, store=ts, device="cpu")
    entry = tplan.trace[0]
    assert entry["lowering_demoted"] is True
    assert entry["lowering_demoted_reason"] == "unregistered-lowering"
    assert tplan.lowering == "mask"
    assert_same_plan(tplan, jops.prepare(jmat, store=js))


@pytest.mark.parametrize("kw", [dict(layout="whole_vector"),
                                dict(pr=48, xw=64), dict(tune=False),
                                dict(layout="test")])
def test_explicit_requests_bypass_the_store_like_the_reference(kw):
    js, ts = stores(BEST, WORSE, "2x8")
    jmat, tmat = _mats(_banded, (2, 8))
    tplan = tops.prepare(tmat, store=ts, device="cpu", **kw)
    jplan = jops.prepare(jmat, store=js, **kw)
    assert tplan.trace[0]["source"] == jplan.trace[0]["source"] != "store"
    assert_same_plan(tplan, jplan)


def test_test_layout_tunes_its_multi_sub_plan_like_the_reference():
    js, ts = stores(BEST, WORSE, "2x4")
    jmat, tmat = _mats(lambda M: M.scrambled_banded(320, 4, 0.9, seed=5),
                       (2, 4))
    tplan = tops.prepare(tmat, layout="test", store=ts, device="cpu")
    assert tplan.trace[0]["source"] == "delegated"
    assert tplan.multi.trace[0]["source"] == "store"
    assert_same_plan(tplan, jops.prepare(jmat, layout="test", store=js))


@pytest.mark.parametrize("backend", [CARD, "", "cuda:other card"])
def test_records_of_another_backend_leave_the_plan_untuned(backend):
    """A store whose records were measured on another device (or carry no
    backend, as the reference's do) tunes no CPU plan: "no-store", and the
    plan of an untuned build, byte for byte."""
    _, ts = stores(BEST, WORSE, "2x8", backend=backend)
    jmat, tmat = _mats(_banded, (2, 8))
    tplan = tops.prepare(tmat, store=ts, device="cpu")
    assert tplan.trace[0]["source"] == "no-store"
    untuned = tops.prepare(tmat, device="cpu")
    assert_plans_byte_equal(tplan, jops.prepare(jmat))
    assert _strip(tplan.trace) == _strip(untuned.trace)
    # a CPU record among them tunes it
    ts.records.append(dataclasses.replace(ts.records[0], backend="cpu"))
    assert tops.prepare(tmat, store=ts, device="cpu").trace[0]["source"] \
        == "store"


def test_the_references_records_never_tune_the_port(monkeypatch):
    """Every record of the reference's committed store (CPU interpret
    mode) loads with ``backend=""``: passed as ``store``, installed as the
    default or named by ``$SPC5_RECORDS``, it leaves the port's plans
    untuned, where the reference's own plans are tuned from it."""
    jmat, tmat = _mats(lambda M: M.banded(600, 4, 0.8, seed=3), (1, 8))
    ref = TS.load_records(REF_STORE)
    assert len(ref.records) > 0
    assert tops.prepare(tmat, store=ref, device="cpu").trace[0]["source"] \
        == "no-store"
    TS.set_default_store(ref)
    assert tops.prepare(tmat, device="cpu").trace[0]["source"] == "no-store"
    TS.set_default_store(None)
    monkeypatch.setenv(TS.RECORDS_ENV, REF_STORE)
    assert tops.prepare(tmat, device="cpu").trace[0]["source"] == "no-store"
    assert jops.prepare(jmat, store=JS.load_records(REF_STORE)).trace[0][
        "source"] == "store"
    assert TL.choose_block(TF.spc5_to_csr(tmat), ref, device="cpu") == \
        TL.choose_block(TF.spc5_to_csr(tmat))


def test_default_store_and_env_var_tune_like_the_reference(tmp_path,
                                                           monkeypatch):
    js, ts = stores(BEST, WORSE, "2x8")
    jmat, tmat = _mats(_banded, (2, 8))
    JS.set_default_store(js)
    TS.set_default_store(ts)
    tplan = tops.prepare(tmat, device="cpu")
    assert tplan.trace[0]["source"] == "store" and tplan.pr == 16
    assert_same_plan(tplan, jops.prepare(jmat))
    for S in (JS, TS):
        S.set_default_store(None)
    p = str(tmp_path / "records.jsonl")
    ts.save_jsonl(p)
    monkeypatch.setenv(TS.RECORDS_ENV, p)
    tplan = tops.prepare(tmat, device="cpu")
    assert tplan.trace[0]["source"] == "store"
    assert_same_plan(tplan, jops.prepare(jmat, store=js))


# ----------------------------------------------------------------------------
# choose_block and from_dense
# ----------------------------------------------------------------------------

def _law_stores(backend="cpu"):
    """Per-kernel laws: beta(r,c) throughput grows with Avg, beta(2,8)
    three times faster than the rest (so the selector's pick differs from
    eq. 4's); whole-vector records (pr = 0, what ``choose_block`` fits) and
    panel records of each kernel."""
    js, ts = JS.RecordStore(), TS.RecordStore()
    for k in JS.DEFAULT_KERNELS:
        for avg in (1.0, 4.0, 12.0, 30.0):
            g = avg * (3.0 if k == "2x8" else 1.0)
            js.add(k, avg, 1, g, layout="whole_vector", cb=64)
            ts.add(k, avg, 1, g, layout="whole_vector", cb=64,
                   backend=backend)
            js.add(k, avg, 1, g * 1.1, pr=64, xw=64, cb=8, layout="panels")
            ts.add(k, avg, 1, g * 1.1, pr=64, xw=64, cb=8, layout="panels",
                   backend=backend)
    return js, ts


def _weight(n=300, m=200, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, m)).astype(np.float32),
            rng.standard_normal(n).astype(np.float32))


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("matrix", ["fem", "pruned", "banded"])
def test_choose_block_matches_the_reference(matrix, workers):
    js, ts = _law_stores()
    if workers > 1:
        for k in JS.DEFAULT_KERNELS:
            for avg in (2.0, 9.0):
                js.add(k, avg, 8, avg * len(k))
                ts.add(k, avg, 8, avg * len(k), backend="cpu")
    if matrix == "pruned":
        w = TL.prune_by_magnitude(_weight()[0], 0.2)
        jcsr, tcsr = JF.csr_from_dense(w), TF.csr_from_dense(w)
    else:
        make = {"fem": lambda M: M.fem_blocks(400, 4, 6, seed=1),
                "banded": lambda M: M.banded(400, 3, 0.7, seed=2)}[matrix]
        jcsr, tcsr = make(JM), make(TM)
    got = TL.choose_block(tcsr, ts, workers, device="cpu")
    assert got == JL.choose_block(jcsr, js, workers=workers)
    # without a usable store: eq. 4, as the reference without one
    eq4 = JL.choose_block(jcsr)
    assert TL.choose_block(tcsr) == eq4
    assert TL.choose_block(tcsr, TS.RecordStore(), device="cpu") == eq4
    card = _law_stores(CARD)[1]
    assert TL.choose_block(tcsr, card, workers, device="cpu") == eq4


def test_choose_block_with_a_store_resolves_the_device():
    _, ts = _law_stores()
    csr = TM.banded(100, 3, 1.0)
    if torch.cuda.is_available():
        TL.choose_block(csr, ts)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TL.choose_block(csr, ts)


@pytest.mark.parametrize("store", ["laws", "empty", "card"])
def test_from_dense_with_a_store_builds_the_reference_layer(store):
    """``from_dense(store=...)``: the selector's block and the tuned plan,
    both as the reference's (an empty store, and one of another device,
    fall back to eq. 4 and the untuned plan)."""
    w, b = _weight()
    js, ts = _law_stores()
    if store == "empty":
        js, ts = JS.RecordStore(), TS.RecordStore()
    kw = dict(density=0.2, bias=b)
    if store == "card":
        _, ts = _law_stores(CARD)
        jl = JL.SparseLinear.from_dense(w, **kw)
    else:
        jl = JL.SparseLinear.from_dense(w, store=js, **kw)
    tl = TL.SparseLinear.from_dense(w, store=ts, device="cpu", **kw)
    assert (tl.plan.r, tl.plan.c) == (jl.handle.r, jl.handle.c)
    assert tl.plan.trace[0]["source"] == (
        "store" if store == "laws" else "no-store")
    assert_same_plan(tl.plan, jl.handle)
    x = np.random.default_rng(8).standard_normal((4, 200)).astype(np.float32)
    for xb in (x, x[0]):
        assert_close(tl(torch.from_numpy(xb)).numpy(),
                     jl(jnp.asarray(xb), use_pallas=False))
