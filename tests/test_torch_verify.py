"""The port's static plan verifier (``repro_torch.analysis.verify``) against
the JAX package's (``repro.analysis.verify``), on the host.

Both packages build the same plan from the same matrix:

* every layout x lowering x reorder x value dtype verifies clean in both,
  with the same rules checked (and a bounded fuzz over random matrices);
* each mutation of ``tests/test_verify.py`` (and the two rules PR 9 added
  there, ``descriptor-index-width`` and ``value-dtype``), applied to both
  plans the same way, fires exactly the same rule at the same path in
  both, with the same message where the two packages' figures agree (not
  for ``vmem-budget``'s second half, which holds the port's kernels to a
  Hopper CTA's 227 KB of shared memory where the reference holds its
  kernels to the TPU's VMEM, nor for ``value-dtype``'s dtype names);
* the report API and the ``verify=`` hooks of ``make_plan``, ``prepare``
  and ``SparseLinear.from_dense``, and a plan only the port's shared-memory
  contract refuses.
"""
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro._compat.hypothesis import given, settings, strategies as st
from repro.analysis import verify as JV
from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import plan as JP
from repro.core import reorder as JRE
from repro.core import selector as JS
from repro.kernels import ops as jops
from repro_torch.analysis import verify as TV
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import ref_spmv as TR
from repro_torch.core import reorder as TRE
from repro_torch.core import selector as TS
from repro_torch.core.sparse_linear import SparseLinear
from repro_torch.kernels import ops as tops
from repro_torch.kernels import spc5_spmm as KM
from repro_torch.kernels import spc5_spmm_desc as KDM
from repro_torch.kernels import spc5_spmv as K
from repro_torch.kernels import spc5_spmv_desc as KD

FUZZ_EXAMPLES = int(os.environ.get("SPC5_FUZZ_EXAMPLES", "10"))


def _csr(M, kind, n):
    if kind == "scrambled":
        return M.scrambled_banded(n, 4, 0.8, seed=3)
    return M.banded(n, 5, 0.8, seed=3)


def build(layout="whole_vector", lowering="mask", rc=(1, 8), n=96,
          reorder=None, kind="banded", **kw):
    """(reference plan, port plan) of the same matrix and request; a
    ``reorder`` callable makes each package's Reordering from its
    module."""
    out = []
    for F, M, P, RE, extra in ((JF, JM, JP, JRE, {}),
                               (TF, TM, TP, TRE, {"device": "cpu"})):
        reo = reorder(RE) if callable(reorder) else reorder
        out.append(P.make_plan(F.csr_to_spc5(_csr(M, kind, n), *rc),
                               layout=layout, lowering=lowering, tune=False,
                               reorder=reo, **extra, **kw))
    return tuple(out)


def _names(plan, P):
    meta = dict(plan.meta)
    return P.get_layout(plan.layout).plan_array_names(
        meta.get("lowering", "mask"), meta.get("vdtype", ""))


def corrupt(plans, name, fn):
    """Both plans with array ``name`` copied to the host, ``fn`` applied
    (in place, or returning a new array) and put back."""
    jplan, tplan = plans
    arrays = list(jplan.arrays)
    i = _names(jplan, JP).index(name)
    a = np.array(arrays[i])
    arrays[i] = jnp.asarray(a if (b := fn(a)) is None else b)
    jnew = dataclasses.replace(jplan, arrays=tuple(arrays))
    arrays = list(tplan.arrays)
    i = _names(tplan, TP).index(name)
    a = TV._host(arrays[i], name).copy()
    arrays[i] = TR.to_tensor(a if (b := fn(a)) is None else b, tplan.device)
    return jnew, dataclasses.replace(tplan, arrays=tuple(arrays))


def edit_meta(plans, **kv):
    return tuple(dataclasses.replace(p, meta=tuple(
        (k, kv.get(k, v)) for k, v in p.meta if kv.get(k, v) is not None))
        for p in plans)


def edit_trace(plans, fn):
    out = []
    for p in plans:
        trace = p.trace
        trace = fn(trace) or trace
        out.append(dataclasses.replace(p, trace_json=json.dumps(trace)))
    return tuple(out)


def same_report(plans, rule=None, messages=True, **kw):
    """Both reports, which must fire the same rules at the same paths
    (exactly ``{rule}``, or nothing for None), with the same messages where
    ``messages``, and check the same rules."""
    jr = JV.verify_plan(plans[0], **kw)
    tr = TV.verify_plan(plans[1], **kw)
    assert tr.rules_fired == jr.rules_fired == (
        frozenset() if rule is None else {rule}), (jr.summary(), tr.summary())
    assert ([(v.rule, v.path) for v in tr.violations]
            == [(v.rule, v.path) for v in jr.violations])
    if messages:
        assert ([v.message for v in tr.violations]
                == [v.message for v in jr.violations])
    assert tr.checked == jr.checked
    return jr, tr


# ----------------------------------------------------------------------------
# clean plans verify clean in both packages
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vdtype", ["auto", "bf16", "int8"])
@pytest.mark.parametrize("reorder", [None, "sigma", "rcm"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_all_combinations_verify_clean(layout, lowering, reorder, vdtype):
    plans = build(layout=layout, lowering=lowering, reorder=reorder,
                  vdtype=vdtype, rc=(2, 4), kind="scrambled",
                  **({} if layout == "whole_vector" else dict(pr=32, xw=32)))
    _, tr = same_report(plans)
    assert {"layout-registered", "trace-schema"} <= set(tr.checked)
    if layout != "test":
        assert "vmem-budget" in tr.checked
    if reorder == "rcm":
        assert plans[1].is_reordered


def test_explicit_reordering_verifies_clean():
    def reo(RE):
        rng = np.random.default_rng(7)
        return RE.Reordering(row_perm=np.arange(96, dtype=np.int64),
                             col_perm=rng.permutation(96).astype(np.int64),
                             strategy="explicit")
    plans = build(reorder=reo)
    _, tr = same_report(plans)
    assert plans[1].col_perm is not None and "permutation" in tr.checked


@settings(max_examples=FUZZ_EXAMPLES, deadline=None)
@given(n=st.integers(16, 120), m=st.integers(16, 120),
       density=st.floats(0.02, 0.7),
       rc=st.sampled_from([(1, 8), (2, 4), (4, 4), (2, 8)]),
       layout=st.sampled_from(["whole_vector", "panels", "test"]),
       lowering=st.sampled_from(["mask", "descriptor"]),
       reorder=st.sampled_from([None, "sigma", "rcm"]),
       seed=st.integers(0, 2**16))
def test_fuzz_random_matrices_verify_clean(n, m, density, rc, layout,
                                           lowering, reorder, seed):
    rng = np.random.default_rng(seed)
    d = ((rng.random((n, m)) < density)
         * rng.standard_normal((n, m))).astype(np.float32)
    plans = [P.make_plan(F.csr_to_spc5(F.csr_from_dense(d), *rc),
                         layout=layout, lowering=lowering, tune=False,
                         reorder=reorder, **extra)
             for F, P, extra in ((JF, JP, {}), (TF, TP, {"device": "cpu"}))]
    same_report(plans)


# ----------------------------------------------------------------------------
# mutations: corrupt both plans alike -> the same rule fires in both
# ----------------------------------------------------------------------------

def _last_multibit_block(mask2d):
    pop = TF.popcount_u32(mask2d)
    for ch in range(mask2d.shape[0] - 1, -1, -1):
        real = np.flatnonzero(mask2d[ch])
        if real.size and pop[ch, real[-1]] >= 2:
            return ch, int(real[-1])
    raise AssertionError("fixture matrix produced no pop>=2 tail block")


def _mask(plans):
    return np.array(plans[0].arrays[2]).reshape(-1, plans[0].cb)


def mut_mask_popcount(plans):
    mask = _mask(plans)
    ch, sl = _last_multibit_block(mask)
    bit = int(np.flatnonzero([(mask[ch, sl] >> b) & 1
                              for b in range(32)])[0])

    def clear_bit(a):
        a.reshape(-1, plans[0].cb)[ch, sl] &= ~np.uint32(1 << bit)
    return corrupt(plans, "chunk_mask", clear_bit)


def _first_real(plans):
    return int(np.flatnonzero(_mask(plans)[0])[0])


def mut_mask_voff_window(plans):
    sl = _first_real(plans)

    def bump(a):
        a.reshape(-1, plans[0].cb)[0, sl] += 1
    return corrupt(plans, "chunk_voff", bump)


def mut_values_window_bounds(plans):
    nvals = int(np.asarray(plans[0].arrays[0]).shape[0])

    def overrun(a):
        a.reshape(-1)[-1] = nvals
    return corrupt(plans, "chunk_vbase", overrun)


def mut_chunk_row_bounds(plans):
    sl = _first_real(plans)
    r = dict(plans[0].meta)["r"]
    big = ((plans[0].nrows // r) + 4) * r

    def oob(a):
        a.reshape(-1, plans[0].cb)[0, sl] = big
    return corrupt(plans, "chunk_row", oob)


def mut_chunk_col_bounds(plans):
    sl = _first_real(plans)

    def oob(a):
        a.reshape(-1, plans[0].cb)[0, sl] = plans[0].ncols
    return corrupt(plans, "chunk_col", oob)


def mut_panels_xbase(plans):
    g = dict(plans[0].meta)

    def overrun(a):
        a.flat[0] = g["ncols_pad"]
    return corrupt(plans, "chunk_xbase", overrun)


def _lanes(plans):
    g = dict(plans[0].meta)
    return g["cb"] * g["r"] * g["c"]


def mut_descriptor_valid(plans):
    lanes = _lanes(plans)
    valid = np.array(plans[0].arrays[1]).reshape(-1, lanes)
    ch = max(c for c in range(valid.shape[0]) if valid[c].any())
    ln = int(np.flatnonzero(valid[ch])[-1])

    def drop(a):
        a.reshape(-1, lanes)[ch, ln] = 0
    return corrupt(plans, "desc_valid", drop)


def mut_descriptor_bounds(plans):
    def oob(a):
        a.flat[0] = plans[0].ncols
    return corrupt(plans, "desc_xcol", oob)


def mut_descriptor_vidx(plans):
    lanes = _lanes(plans)
    valid = np.array(plans[0].arrays[1]).reshape(-1, lanes)
    ch = next(c for c in range(valid.shape[0])
              if np.flatnonzero(valid[c]).size >= 2)
    l0, l1 = np.flatnonzero(valid[ch])[:2]

    def swap(a):
        v = a.reshape(-1, lanes)
        v[ch, l0], v[ch, l1] = v[ch, l1].copy(), v[ch, l0].copy()
    return corrupt(plans, "desc_vidx", swap)


def mut_descriptor_widened(plans):
    return corrupt(plans, "desc_vidx", lambda a: a.astype(np.int32))


def mut_int8_scale(plans):
    def negate(a):
        a.flat[0] = -1.0
    return corrupt(plans, "value_scale", negate)


def mut_permutation(plans):
    out = []
    for p, back in ((plans[0], jnp.asarray),
                    (plans[1], lambda a: TR.to_tensor(a, "cpu"))):
        cp = TV._host(p.col_perm).copy()
        cp[0] = cp[1]
        out.append(dataclasses.replace(p, col_perm=back(cp)))
    return tuple(out)


def _explicit(RE):
    rng = np.random.default_rng(11)
    return RE.Reordering(row_perm=np.arange(96, dtype=np.int64),
                         col_perm=rng.permutation(96).astype(np.int64),
                         strategy="explicit")


def mut_trace_reason(plans):
    def flag(trace):
        next(e for e in trace if e["pass"] == "layout")["demoted"] = True
    return edit_trace(plans, flag)


def mut_trace_pass(plans):
    return edit_trace(plans, lambda t: [e for e in t
                                        if e["pass"] != "reorder"])


def mut_trace_duration(plans):
    def drop(trace):
        del next(e for e in trace if e["pass"] == "tune")["duration_s"]
    return edit_trace(plans, drop)


def mut_test_split(plans):
    return edit_meta(plans, n_single=dict(plans[0].meta)["n_single"] + 1)


MUTATIONS = {
    # name: (build kwargs, mutation, rule, same messages)
    "mask-popcount": ({}, mut_mask_popcount, "mask-popcount", True),
    "mask-voff-window": ({}, mut_mask_voff_window, "mask-voff-window", True),
    "values-window-bounds": ({}, mut_values_window_bounds,
                             "values-window-bounds", True),
    "chunk-row-bounds": ({}, mut_chunk_row_bounds, "chunk-row-bounds", True),
    "chunk-col-bounds": ({}, mut_chunk_col_bounds, "chunk-col-bounds", True),
    "panels-xbase": (dict(layout="panels", pr=32, xw=32), mut_panels_xbase,
                     "chunk-col-bounds", True),
    "panels-chunk-row": (dict(layout="panels", pr=32, xw=32),
                         mut_chunk_row_bounds, "chunk-row-bounds", True),
    "descriptor-valid-mask": (dict(lowering="descriptor"),
                              mut_descriptor_valid, "descriptor-valid-mask",
                              True),
    "descriptor-bounds": (dict(lowering="descriptor"), mut_descriptor_bounds,
                          "descriptor-bounds", True),
    "descriptor-vidx": (dict(lowering="descriptor"), mut_descriptor_vidx,
                        "descriptor-vidx-consistent", True),
    "descriptor-index-width": (dict(lowering="descriptor"),
                               mut_descriptor_widened,
                               "descriptor-index-width", True),
    "value-dtype-scale": (dict(vdtype="int8"), mut_int8_scale, "value-dtype",
                          True),
    "value-dtype-store": (dict(vdtype="bf16"),
                          lambda p: corrupt(p, "values",
                                            lambda a: a.astype(np.float32)),
                          "value-dtype", False),
    "permutation": (dict(reorder=_explicit), mut_permutation, "permutation",
                    True),
    "trace-missing-reason": ({}, mut_trace_reason, "trace-schema", True),
    "trace-missing-pass": ({}, mut_trace_pass, "trace-schema", True),
    "trace-missing-duration": ({}, mut_trace_duration, "trace-schema", True),
    "test-split-count": (dict(layout="test"), mut_test_split, "test-split",
                         True),
}


@pytest.mark.parametrize("name", sorted(MUTATIONS))
def test_mutation_fires_the_same_rule_in_both(name):
    kw, mutate, rule, messages = MUTATIONS[name]
    plans = build(**kw)
    same_report(plans)
    same_report(mutate(plans), rule, messages)


def test_mutation_vmem_budget():
    """The registry cost can't fit a 1-byte budget: both prove the plan
    should have been demoted."""
    same_report(build(), "vmem-budget", budget_bytes=1)


def test_mutation_vmem_contract_missing(monkeypatch):
    from repro.kernels import spc5_spmv as JKV
    plans = build(layout="whole_vector", lowering="mask")
    contracts = dict(JKV.SPMV_VMEM_CONTRACTS)
    del contracts[("whole_vector", "mask")]
    monkeypatch.setattr(JKV, "SPMV_VMEM_CONTRACTS", contracts)
    contracts = dict(K.SMEM_CONTRACTS)
    del contracts[("whole_vector", "mask")]
    monkeypatch.setattr(K, "SMEM_CONTRACTS", contracts)
    _, tr = same_report(plans, "vmem-budget", messages=False)
    assert "no SpMV shared-memory contract" in tr.violations[0].message


def test_mutation_unregistered_layout():
    plans = tuple(dataclasses.replace(p, layout="bogus") for p in build())
    jr, tr = same_report(plans, "layout-registered", messages=False)
    assert tr.checked == jr.checked == ("layout-registered",)


def test_mutation_geometry_schema_skips_array_rules():
    jr, tr = same_report(edit_meta(build(), vmax=None), "geometry-schema")
    assert "mask-popcount" not in tr.checked
    assert "trace-schema" in tr.checked


@settings(max_examples=min(FUZZ_EXAMPLES, 6), deadline=None)
@given(name=st.sampled_from(sorted(MUTATIONS)))
def test_fuzz_mutations_fire_the_right_rule(name):
    test_mutation_fires_the_same_rule_in_both(name)


# ----------------------------------------------------------------------------
# vmem-budget's second half: the port's shared-memory contracts
# ----------------------------------------------------------------------------

def _dense_pair(layout, lowering, cb=2048, n=256):
    """A dense n x n matrix in beta(4,8): every block full, so one chunk
    of ``cb`` blocks holds a 32 * cb value window."""
    d = np.random.default_rng(0).standard_normal((n, n)).astype(np.float32)
    geom = dict(cb=cb) if layout == "whole_vector" else dict(cb=cb, pr=n,
                                                             xw=n)
    return tuple(P.make_plan(F.csr_to_spc5(F.csr_from_dense(d), 4, 8),
                             layout=layout, lowering=lowering, tune=False,
                             **extra, **geom)
                 for F, P, extra in ((JF, JP, {}),
                                     (TF, TP, {"device": "cpu"})))


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_only_the_ports_contract_refuses_a_window_past_a_cta(layout):
    """A 2,048-block chunk of full beta(4,8) blocks stages a 256 KB f32
    value window: past a Hopper CTA's 227 KB of shared memory, so the
    port's mask kernels could not launch it, where the TPU's 16 MiB VMEM
    contract passes it."""
    jplan, tplan = _dense_pair(layout, "mask")
    assert JV.verify_plan(jplan).ok
    report = TV.verify_plan(tplan)
    assert report.rules_fired == {"vmem-budget"}
    assert all(v.path == "plan" for v in report.violations)
    assert "SpMV" in report.violations[0].message
    assert str(K.MAX_SMEM_BYTES) in report.summary()
    contract = (K.whole_contract if layout == "whole_vector"
                else K.panels_contract)
    assert contract(dict(tplan.meta), 4) > K.MAX_SMEM_BYTES
    # a chunk of 64 blocks fits: both clean
    same_report(_dense_pair(layout, "mask", cb=64))


def _occupancy(*args, **kw):
    return (2, 132)


@pytest.mark.parametrize("vdtype", ["auto", "bf16", "int8"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_contracts_are_the_launch_plans_shared_memory(layout, lowering,
                                                      vdtype, monkeypatch):
    """Each contract is the shared memory the wrapper's launch plan asks
    for at its fewest stages (the occupancy faked: it does not enter the
    figure), on a plan's real geometry and value width."""
    for mod, name in ((K, "whole_occupancy"), (K, "panels_occupancy"),
                      (KD, "_occupancy"), (KM, "whole_occupancy"),
                      (KM, "panels_occupancy"), (KDM, "whole_occupancy"),
                      (KDM, "panels_occupancy")):
        monkeypatch.setattr(mod, name, _occupancy)
    _, plan = build(layout=layout, lowering=lowering, vdtype=vdtype,
                    rc=(2, 4), kind="scrambled", n=400,
                    **({} if layout == "whole_vector"
                       else dict(pr=64, xw=64, cb=16)))
    g = dict(plan.meta)
    vsize = plan.values.element_size()
    dev = torch.device("cuda", 0)
    geo = dict(cb=g["cb"], r=g["r"], vmax=g["vmax"], device=dev, vsize=vsize)
    nch = plan.chunk_vbase.shape[-1]
    if lowering == "mask" and layout == "whole_vector":
        spmv = K.whole_launch(1, nch, **geo)
        spmm = KM.whole_launch(nch, c=g["c"], nvec=16, vec=4, **geo)
    elif lowering == "mask":
        spmv = K.panels_launch(1, g["npanels"], nch, pr=g["pr"], **geo)
        spmm = KM.panels_launch(1, g["npanels"], nch, c=g["c"], pr=g["pr"],
                                nvec=16, vec=4, **geo)
    else:
        wv, wx = plan.desc_vidx.element_size(), plan.desc_xcol.element_size()
        assert (wv, wx) == KD.table_widths(g, layout)
        if layout == "whole_vector":
            spmv = KD.whole_launch(1, nch, c=g["c"], wv=wv, wx=wx, **geo)
            spmm = KDM.whole_launch(nch, c=g["c"], nvec=16, vec=4, wv=wv,
                                    wx=wx, **geo)
        else:
            spmv = KD.panels_launch(1, g["npanels"], nch, c=g["c"],
                                    xw=g["xw"], pr=g["pr"], wv=wv, wx=wx,
                                    **geo)
            spmm = KDM.panels_launch(1, g["npanels"], nch, c=g["c"],
                                     pr=g["pr"], nvec=16, vec=4, wv=wv,
                                     wx=wx, **geo)
    contracts = TV.smem_contracts()
    key = (layout, lowering)
    assert contracts["SpMV"][key](g, vsize) == spmv["smem_bytes"]
    assert contracts["SpMM"][key](g, vsize, nvec=16) == spmm["smem_bytes"]
    assert TV.verify_plan(plan, nvec=16).ok


def test_every_registered_lowering_has_contracts():
    contracts = TV.smem_contracts()
    for name in ("whole_vector", "panels"):
        for lowering in TP.get_layout(name).lowerings:
            assert (name, lowering) in contracts["SpMV"]
            assert (name, lowering) in contracts["SpMM"]


# ----------------------------------------------------------------------------
# the report API and the verify= hooks
# ----------------------------------------------------------------------------

def test_report_api_and_raise():
    _, plan = build()
    good = TV.verify_plan(plan)
    assert good.ok and good.raise_if_failed() is good
    assert "ok" in good.summary()
    bad = TV.verify_plan(dataclasses.replace(plan, layout="bogus"))
    with pytest.raises(TV.PlanVerificationError) as ei:
        bad.raise_if_failed()
    assert ei.value.report is bad
    assert isinstance(ei.value, ValueError)
    assert "layout-registered" in str(ei.value)
    assert TV.plan_rule_names() == JV.plan_rule_names()
    assert set(TV.plan_rule_names()) >= set(good.checked)
    assert str(bad.violations[0]).startswith("plan: [layout-registered]")


def test_analysis_package_exports_the_verifier():
    import repro_torch.analysis as A
    for name in ("PlanVerificationError", "VerifyReport", "Violation",
                 "plan_rule_names", "verify_plan", "verify_records"):
        assert getattr(A, name) is getattr(TV, name)
    assert not hasattr(A, "hlo") and not hasattr(A, "analyze_hlo")


def test_make_plan_verify_hook():
    mat = TF.csr_to_spc5(TM.banded(64, 4, 1.0, seed=5), 1, 8)
    TP.make_plan(mat, device="cpu", layout="whole_vector", tune=False,
                 verify=True)
    seen = []
    TP.make_plan(mat, device="cpu", layout="panels", tune=False,
                 verify=seen.append)
    assert len(seen) == 1 and seen[0].ok
    TP.make_plan(mat, device="cpu", layout="test", tune=False,
                 verify=seen.append)
    assert len(seen) == 2 and seen[1].ok
    assert "test-split" in seen[1].checked


@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
def test_verify_hooks_refuse_a_plan_past_a_cta(layout):
    """``verify=True`` raises on the plan only the port's contract refuses;
    a callable receives the report instead."""
    d = np.random.default_rng(0).standard_normal((256, 256)).astype(
        np.float32)
    mat = TF.csr_to_spc5(TF.csr_from_dense(d), 4, 8)
    geom = dict(cb=2048) if layout == "whole_vector" else dict(cb=2048,
                                                               pr=256,
                                                               xw=256)
    with pytest.raises(TV.PlanVerificationError, match="vmem-budget"):
        tops.prepare(mat, device="cpu", layout=layout, lowering="mask",
                     tune=False, verify=True, **geom)
    seen = []
    plan = TP.make_plan(mat, device="cpu", layout=layout, lowering="mask",
                        tune=False, verify=seen.append, **geom)
    assert plan.layout == layout
    assert seen[0].rules_fired == {"vmem-budget"}
    with pytest.raises(TV.PlanVerificationError):
        SparseLinear.from_dense(d, block=(4, 8), layout=layout,
                                lowering="mask", tune=False, verify=True,
                                device="cpu", **geom)


def test_ops_prepare_and_from_dense_verify_hooks():
    csr = TM.banded(64, 4, 1.0, seed=5)
    plan = tops.prepare(TF.csr_to_spc5(csr, 1, 8), dtype=np.float32,
                        verify=True, device="cpu")
    assert TV.verify_plan(plan).ok
    w = np.random.default_rng(1).standard_normal((120, 80)).astype(
        np.float32)
    seen = []
    layer = SparseLinear.from_dense(w, density=0.3, verify=seen.append,
                                    device="cpu")
    assert seen[0].ok and layer.plan.layout == "whole_vector"
    SparseLinear.from_dense(w, density=0.3, layout="test", verify=True,
                            device="cpu")


def test_tune_demotion_verifies_clean_in_both():
    """A tuned whole-vector pick demoted at nvec=128 (the reference's TPU
    budget) carries its explained demotion; both verify it clean."""
    plans = []
    for S, F, M, ops, extra in ((JS, JF, JM, jops, {}),
                                (TS, TF, TM, tops, {"device": "cpu"})):
        store = S.RecordStore()
        f = S.MatrixFeatures(0, 0, 0, 4.0, 2.0, 4.0, 0.5)
        kw = {} if S is JS else {"backend": "cpu"}
        store.add_measurement("1x8", f, S.PanelConfig("whole", 0, 0, 512), 1,
                              9.0, **kw)
        mat = F.csr_to_spc5(M.banded(2400, 4, 1.0, seed=9), 1, 8)
        plans.append(ops.prepare(mat, store=store, nvec=128, **extra))
    for p in plans:
        assert p.trace[0]["demoted"] is True
        assert p.trace[0]["demoted_reason"] == "vmem-budget"
    same_report(plans, nvec=128)


def test_layout_demotion_reason_verifies_clean(monkeypatch):
    spec = TP._REGISTRY[TP.LAYOUT_WHOLE]
    monkeypatch.setitem(TP._REGISTRY, TP.LAYOUT_WHOLE,
                        dataclasses.replace(spec, lowerings=("mask",)))
    mat = TF.csr_to_spc5(TM.banded(96, 4, 1.0, seed=31), 1, 8)
    plan = tops.prepare(mat, cb=32, layout="whole_vector",
                        lowering="descriptor", device="cpu")
    lay = next(e for e in plan.trace if e["pass"] == "layout")
    assert lay["lowering_demoted"] is True
    assert TV.verify_plan(plan).ok
