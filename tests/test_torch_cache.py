"""The port's cache substrate (``repro_torch.core.plan``:
``matrix_fingerprint``, ``plan_cache_key``, ``append_trace_entries``,
``plan_nbytes``) against the JAX package's, on the host.

Both packages convert the same CSR matrix to byte-equal beta(r,c) arrays,
so their fingerprints and cache keys must be the same hex digests, digit
for digit; one flipped mask bit or one edited value changes both, alike.
``plan_nbytes`` counts the port's tensors by ``numel() * element_size()``
and must equal the reference's figure on byte-equal plans of every layout,
lowering, value dtype and reordering.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import plan as JP
from repro.core import selector as JS
from repro_torch.analysis import verify as TV
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import plan as TP
from repro_torch.core import selector as TS


def _pair(rc=(2, 4), n=300, seed=3):
    return (JF.csr_to_spc5(JM.fem_blocks(n, 4, 5, seed=seed), *rc),
            TF.csr_to_spc5(TM.fem_blocks(n, 4, 5, seed=seed), *rc))


def _replace(mat, F, **arrays):
    kw = {f.name: getattr(mat, f.name) for f in dataclasses.fields(mat)}
    kw.update(arrays)
    return F.SPC5Matrix(**kw)


@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_fingerprint_is_the_references_digest(rc):
    jmat, tmat = _pair(rc)
    digest = TP.matrix_fingerprint(tmat)
    assert digest == JP.matrix_fingerprint(jmat)
    assert len(digest) == 32 and int(digest, 16) >= 0
    # a copy of every array fingerprints the same
    clone = _replace(tmat, TF, **{f: getattr(tmat, f).copy() for f in (
        "block_rowptr", "block_colidx", "block_masks", "block_voffset",
        "values")})
    assert TP.matrix_fingerprint(clone) == digest


@pytest.mark.parametrize("edit", ["mask-bit", "value", "column", "shape",
                                  "dtype"])
def test_fingerprint_changes_with_the_content_like_the_reference(edit):
    jmat, tmat = _pair()
    digests = []
    for mat, F, P in ((jmat, JF, JP), (tmat, TF, TP)):
        if edit == "mask-bit":
            masks = mat.block_masks.copy()
            masks[3] ^= np.uint32(1 << 5)
            new = _replace(mat, F, block_masks=masks)
        elif edit == "value":
            vals = mat.values.copy()
            vals[0] += 1.0
            new = _replace(mat, F, values=vals)
        elif edit == "column":
            cols = mat.block_colidx.copy()
            cols[-1] += 1
            new = _replace(mat, F, block_colidx=cols)
        elif edit == "shape":
            new = _replace(mat, F, shape=(mat.shape[0], mat.shape[1] + 1))
        else:
            new = _replace(mat, F, values=mat.values.astype(np.float32))
        assert P.matrix_fingerprint(new) != P.matrix_fingerprint(mat)
        digests.append(P.matrix_fingerprint(new))
    assert digests[0] == digests[1]


@pytest.mark.parametrize("request_kw", [
    {},
    dict(layout="auto", lowering="auto", reorder=None, config=None,
         verify=False, vdtype="", store=None),
    dict(layout="panels", pr=64, xw=64, cb=8),
    dict(lowering="descriptor", reorder="sigma"),
    dict(reorder="sigma", lowering="descriptor"),
    dict(lowering="mask", reorder="rcm", nvec=128, align=4),
    dict(dtype=np.float32, vdtype="bf16", tune=True),
    dict(vdtype="int8", layout="test", multi_layout="panels"),
    dict(verify=True, tune=False, nvec=1.5),
])
def test_cache_key_is_the_references_digest(request_kw):
    jmat, tmat = _pair()
    assert (TP.plan_cache_key(tmat, **request_kw)
            == JP.plan_cache_key(jmat, **request_kw))


def test_cache_key_normalises_defaults_and_order():
    _, tmat = _pair()
    assert TP.plan_cache_key(tmat, dtype=torch.float32) == TP.plan_cache_key(
        tmat, dtype=np.float32)
    assert TP.plan_cache_key(tmat) == TP.plan_cache_key(
        tmat, layout="auto", lowering="auto", reorder=None, config=None,
        verify=False)
    a = TP.plan_cache_key(tmat, lowering="descriptor", reorder="sigma")
    assert a == TP.plan_cache_key(tmat, reorder="sigma", lowering="descriptor")
    assert a != TP.plan_cache_key(tmat, lowering="mask", reorder="sigma")
    assert a != TP.plan_cache_key(tmat, lowering="descriptor", reorder="rcm")


def test_cache_key_of_a_config_matches_the_reference():
    """A PanelConfig goes into the key as its repr: the two packages'
    configs of the same fields give the same key."""
    jmat, tmat = _pair()
    kw = dict(layout="panels", pr=32, xw=64, cb=8, lowering="descriptor")
    jc, tc = JS.PanelConfig(**kw), TS.PanelConfig(**kw)
    assert repr(tc).split("(", 1)[1] == repr(jc).split("(", 1)[1]
    assert TP.plan_cache_key(tmat, config=tc) == JP.plan_cache_key(
        jmat, config=jc)


GEOM = {"whole_vector": dict(cb=16), "panels": dict(pr=64, xw=64, cb=8),
        "test": dict(pr=64, xw=64, cb=8)}


@pytest.mark.parametrize("vdtype", ["auto", "bf16", "int8"])
@pytest.mark.parametrize("reorder", [None, "rcm"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
@pytest.mark.parametrize("layout", ["whole_vector", "panels", "test"])
def test_plan_nbytes_matches_reference(layout, lowering, reorder, vdtype):
    csr = (JM.scrambled_banded(240, 4, 0.9, seed=5), TM.scrambled_banded(
        240, 4, 0.9, seed=5))
    jmat, tmat = (JF.csr_to_spc5(csr[0], 2, 4), TF.csr_to_spc5(csr[1], 2, 4))
    kw = dict(layout=layout, lowering=lowering, reorder=reorder,
              vdtype=vdtype, tune=False, **GEOM[layout])
    jplan = JP.make_plan(jmat, **kw)
    tplan = TP.make_plan(tmat, device="cpu", **kw)
    assert tplan.is_reordered == jplan.is_reordered
    assert TP.plan_nbytes(tplan) == JP.plan_nbytes(jplan) > 0
    want = sum(int(np.asarray(a).nbytes) for a in jplan.arrays)
    if layout != "test":
        assert TP.plan_nbytes(tplan) == want + sum(
            int(np.asarray(p).nbytes) for p in (jplan.col_perm,
                                                jplan.row_iperm)
            if p is not None)


def _strip(trace):
    return [{k: v for k, v in e.items() if k != "duration_s"} for e in trace]


def test_append_trace_entries_matches_reference():
    """A copy with the entries appended (the original untouched); the
    verifier's trace-schema rule admits trailing degrade entries with a
    rung, a reason and a duration, and nothing else after build."""
    jmat, tmat = _pair()
    kw = dict(layout="panels", lowering="mask", tune=False, **GEOM["panels"])
    jplan = JP.make_plan(jmat, **kw)
    tplan = TP.make_plan(tmat, device="cpu", **kw)
    entry = {"pass": "degrade", "rung": "mask", "reason": "launch-failed",
             "duration_s": 0.0}
    jnew = JP.append_trace_entries(jplan, [entry])
    tnew = TP.append_trace_entries(tplan, [entry])
    assert len(tplan.trace) == 4 and len(tnew.trace) == 5
    assert _strip(tnew.trace) == _strip(jnew.trace)
    assert tnew.trace[-1] == entry
    assert tnew.arrays is tplan.arrays
    assert json.loads(tnew.trace_json) == tnew.trace
    assert TV.verify_plan(tnew).ok
    bad = TP.append_trace_entries(tplan, [{"pass": "degrade", "rung": "mask",
                                           "duration_s": 0.0}])
    assert TV.verify_plan(bad).rules_fired == {"trace-schema"}
    bad = TP.append_trace_entries(tplan, [{"pass": "tune", "source": "store",
                                           "duration_s": 0.0}])
    assert TV.verify_plan(bad).rules_fired == {"trace-schema"}
