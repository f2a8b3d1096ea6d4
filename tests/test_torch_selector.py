"""The port's record-based selector (``repro_torch.core.selector``) against
the JAX package's (``repro.core.selector``), on the host.

Both stores hold the same records; the port's also carry
``backend="cpu"`` (schema v5), so a filter on the host's backend keeps them
all and the port's arithmetic must be the reference's: the same numpy
calls on the same numbers, so predictions agree to ``PRED_RTOL`` (1e-12,
relative; they are in fact bit-equal here) and every choice (kernel,
configuration, clamp) is equal. Records of another backend, and every
record loaded from the reference's files (``backend=""``), take no part in
a filtered fit. ``verify_records`` reports the same violations in both
packages on the same stores.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

from repro.analysis import verify as JV
from repro.core import formats as JF
from repro.core import matgen as JM
from repro.core import selector as JS
from repro.core import structure as JST
from repro_torch.analysis import verify as TV
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TM
from repro_torch.core import selector as TS
from repro_torch.core import structure as TST

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_STORE = os.path.join(REPO, "benchmarks", "records", "spmv_quick.jsonl")
PRED_RTOL = 1e-12


@pytest.fixture(autouse=True)
def _no_ambient_store(monkeypatch):
    """Keep an env-configured default store out of these tests."""
    for S in (JS, TS):
        monkeypatch.delenv(S.RECORDS_ENV, raising=False)
        S.set_default_store(None)
    yield
    for S in (JS, TS):
        S.set_default_store(None)


def _fields(rec):
    """A record's fields, the port's ``backend`` left out."""
    d = dataclasses.asdict(rec)
    d.pop("backend", None)
    return d


def mirror(jstore, backend="cpu"):
    """The port's store holding the reference store's records, each with
    ``backend``."""
    t = TS.RecordStore()
    for r in jstore.records:
        t.records.append(TS.Record(**_fields(r), backend=backend))
    return t


def assert_pred_equal(a, b):
    if np.isinf(a) or np.isinf(b):
        assert a == b
    else:
        assert a == pytest.approx(b, rel=PRED_RTOL, abs=0.0)


def _law_store():
    """Per-kernel linear laws (paper fig. 5): large blocks win at high
    fill."""
    st = JS.RecordStore()
    for k in JS.DEFAULT_KERNELS:
        r, c = JS.kernel_block(k)
        for avg in (1.0, 4.0, 12.0, 30.0):
            st.add(k, avg, 1, avg * (r * c) ** 0.25)
    return st


def planted(best, worse, kernel="2x8", S=JS):
    """A store where ``best`` measures strictly faster than ``worse``."""
    st = S.RecordStore()
    r, c = S.kernel_block(kernel)
    for avg in (1.0, 3.0, 6.0):
        f = S.MatrixFeatures(0, 0, 0, 5.0, 2.0, avg, avg / (r * c))
        st.add_measurement(kernel, f, best, 1, 2.0 + avg)
        st.add_measurement(kernel, f, worse, 1, 1.0)
    return st


def _cfg(S, **kw):
    return S.PanelConfig(**kw)


# ----------------------------------------------------------------------------
# features
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("rc", TF.SUPPORTED_BLOCKS)
def test_features_match_reference(rc):
    jcsr = JM.fem_blocks(600, 4, 5, seed=2)
    tcsr = TM.fem_blocks(600, 4, 5, seed=2)
    assert TS.csr_features(tcsr, *rc) == TS.MatrixFeatures(
        *dataclasses.astuple(JS.csr_features(jcsr, *rc)))
    jf = JS.spc5_features(JF.csr_to_spc5(jcsr, *rc))
    tf = TS.spc5_features(TF.csr_to_spc5(tcsr, *rc))
    assert dataclasses.astuple(tf) == dataclasses.astuple(jf)
    assert np.array_equal(tf.vector(4), jf.vector(4))
    assert TS.matrix_features(tcsr) == JS.matrix_features(jcsr)


def test_structure_profile_features_match_reference():
    jp = JST.profile(JM.banded(300, 4, 0.9, seed=1))
    tp = TST.profile(TM.banded(300, 4, 0.9, seed=1))
    for kernel in (None, "1x8", "2x4", "4x4"):
        assert (dataclasses.astuple(tp.features(kernel))
                == dataclasses.astuple(jp.features(kernel)))
    for prof in (jp, tp):
        with pytest.raises(KeyError, match="not profiled"):
            prof.features("8x4")


# ----------------------------------------------------------------------------
# predictors and choices
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("pr", [0, 512])
def test_sequential_predictor_matches_reference(degree, pr):
    js = JS.RecordStore()
    rng = np.random.default_rng(degree + pr)
    for avg in (1.0, 2.0, 4.0, 8.0, 16.0, 24.0):
        for k in ("4x8", "1x8", "2x4"):
            js.add(k, avg, 1, float(rng.random() + 0.1 * avg), pr=pr)
        js.add("4x8", avg, 1, 99.0, pr=512 - pr)     # the other layout
    jp = JS.SequentialPredictor(js, degree=degree, pr=pr)
    tp = TS.SequentialPredictor(mirror(js), degree=degree, pr=pr,
                                backend="cpu")
    assert tp.clip == jp.clip
    for k in ("4x8", "1x8", "2x4", "8x4"):
        for avg in (-5.0, 0.5, 3.0, 10.0, 1000.0):
            assert_pred_equal(tp.predict(k, avg), jp.predict(k, avg))


def test_parallel_predictor_matches_reference():
    js = JS.RecordStore()
    for avg in (1.0, 4.0, 16.0):
        for w in (1, 4, 16, 52):
            js.add("2x4", avg, w, 0.2 * avg + 0.5 * np.log2(w) + 1.0)
            js.add("4x4", avg, w, 0.1 * avg * avg - w / 10.0)
    jp = JS.ParallelPredictor(js)
    tp = TS.ParallelPredictor(mirror(js), backend="cpu")
    assert tp.clip == jp.clip
    for k in ("2x4", "4x4", "1x8"):
        for avg, w in ((8.0, 8), (0.1, 1), (50.0, 64)):
            assert_pred_equal(tp.predict(k, avg, w), jp.predict(k, avg, w))


@pytest.mark.parametrize("workers", [1, 8])
@pytest.mark.parametrize("matrix", ["fem", "banded", "uniform"])
def test_select_kernel_matches_reference(matrix, workers):
    make = {"fem": lambda M: M.fem_blocks(400, 4, 6, seed=1),
            "banded": lambda M: M.banded(400, 3, 0.7, seed=2),
            "uniform": lambda M: M.uniform_random(300, 6, seed=3)}[matrix]
    js = _law_store()
    if workers > 1:
        for k in JS.DEFAULT_KERNELS:
            for avg in (2.0, 9.0):
                js.add(k, avg, 16, avg + len(k))
    jbest, jscore, jscores = JS.select_kernel(make(JM), js, workers=workers)
    tbest, tscore, tscores = TS.select_kernel(make(TM), mirror(js),
                                              workers=workers, backend="cpu")
    assert tbest == jbest
    assert set(tscores) == set(jscores)
    for k in jscores:
        assert_pred_equal(tscores[k], jscores[k])


def test_select_kernel_on_an_empty_store_matches_reference():
    jbest, _, _ = JS.select_kernel(JM.banded(100, 3, 1.0), JS.RecordStore())
    tbest, _, _ = TS.select_kernel(TM.banded(100, 3, 1.0), TS.RecordStore(),
                                   backend="cpu")
    assert tbest == jbest


@pytest.mark.parametrize("case", ["panels-best", "whole-best", "lowering",
                                  "vdtype", "reorder"])
def test_tune_matches_reference(case):
    """The same planted records give the same tuned configuration, for
    the kernel, for another kernel (the kernel-agnostic fall-back) and
    over a candidate subset; ConfigPredictor's scores agree."""
    best, worse = {
        "panels-best": (dict(layout="panels", pr=16, xw=32, cb=8),
                        dict(layout="whole_vector", pr=0, xw=0, cb=256)),
        "whole-best": (dict(layout="whole", pr=0, xw=0, cb=128),
                       dict(layout="panels", pr=64, xw=64, cb=8)),
        "lowering": (dict(layout="panels", pr=32, xw=64, cb=16,
                          lowering="descriptor"),
                     dict(layout="panels", pr=32, xw=64, cb=16)),
        "vdtype": (dict(layout="whole_vector", cb=64, vdtype="bf16"),
                   dict(layout="whole_vector", cb=64, vdtype="int8")),
        "reorder": (dict(layout="panels", pr=32, xw=32, cb=8,
                         reorder="rcm"),
                    dict(layout="panels", pr=32, xw=32, cb=8)),
    }[case]
    js = planted(_cfg(JS, **best), _cfg(JS, **worse))
    ts = planted(_cfg(TS, **best), _cfg(TS, **worse), S=TS)
    for r in ts.records:
        r.backend = "cpu"
    assert [_fields(r) for r in ts.records] == [_fields(r) for r in
                                                js.records]
    for avg in (0.5, 4.0, 9.0):
        jf = JS.MatrixFeatures(0, 0, 0, 5.0, 2.0, avg, avg / 16)
        tf = TS.MatrixFeatures(0, 0, 0, 5.0, 2.0, avg, avg / 16)
        for kernel in ("2x8", "8x4", None):
            jc = JS.tune(jf, store=js, kernel=kernel)
            tc = TS.tune(tf, store=ts, kernel=kernel, backend="cpu")
            assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        jcand = [_cfg(JS, **worse)]
        tcand = [_cfg(TS, **worse)]
        assert (dataclasses.asdict(TS.tune(tf, store=ts, candidates=tcand,
                                           backend="cpu"))
                == dataclasses.asdict(JS.tune(jf, store=js,
                                              candidates=jcand)))
        jp = JS.ConfigPredictor(js, kernel="2x8")
        tp = TS.ConfigPredictor(ts, kernel="2x8", backend="cpu")
        assert np.array_equal(tp.scale, jp.scale)
        for cfg in (best, worse):
            assert_pred_equal(tp.predict(tf, _cfg(TS, **cfg)),
                              jp.predict(jf, _cfg(JS, **cfg)))


def test_tune_empty_store_falls_back_like_the_reference():
    tf = TS.MatrixFeatures(0, 0, 0, 5.0, 2.0, 4.0, 0.25)
    jf = JS.MatrixFeatures(0, 0, 0, 5.0, 2.0, 4.0, 0.25)
    for tstore, jstore in ((TS.RecordStore(), JS.RecordStore()),
                           (None, None)):
        assert (dataclasses.asdict(TS.tune(tf, store=tstore))
                == dataclasses.asdict(JS.tune(jf, store=jstore)))
    assert dataclasses.asdict(TS.DEFAULT_CONFIG) == dataclasses.asdict(
        JS.DEFAULT_CONFIG)


@pytest.mark.parametrize("cfg", [
    dict(layout="panels", pr=2048, xw=4096, cb=512),
    dict(layout="panels", pr=3, xw=5, cb=1),
    dict(layout="whole_vector", pr=0, xw=0, cb=999, lowering="descriptor"),
    dict(layout="test", pr=64, xw=64, cb=8, lowering="descriptor"),
    dict(layout="auto", pr=512, xw=512, cb=None, vdtype="int8"),
])
@pytest.mark.parametrize("dims", [(8, 8, 2, 8, 4), (1000, 300, 4, 4, 900),
                                  (37, 5000, 1, 8, 12)])
def test_clamp_config_matches_reference(cfg, dims):
    nrows, ncols, r, c, nblocks = dims
    kw = dict(nrows=nrows, ncols=ncols, r=r, c=c, nblocks=nblocks)
    for align in (4, 8):
        assert (dataclasses.asdict(TS.clamp_config(_cfg(TS, **cfg), **kw,
                                                   align=align))
                == dataclasses.asdict(JS.clamp_config(_cfg(JS, **cfg), **kw,
                                                      align=align)))


def test_clamp_config_demotes_an_unregistered_lowering_like_the_reference(
        monkeypatch):
    from repro.core import plan as JP
    from repro_torch.core import plan as TP
    for P in (JP, TP):
        spec = P._REGISTRY[P.LAYOUT_PANELS]
        monkeypatch.setitem(P._REGISTRY, P.LAYOUT_PANELS,
                            dataclasses.replace(spec, lowerings=("mask",)))
    kw = dict(nrows=100, ncols=100, r=2, c=4, nblocks=50)
    cfg = dict(layout="panels", pr=32, xw=32, cb=8, lowering="descriptor")
    t = TS.clamp_config(_cfg(TS, **cfg), **kw)
    assert t.lowering == "mask"
    assert dataclasses.asdict(t) == dataclasses.asdict(
        JS.clamp_config(_cfg(JS, **cfg), **kw))


# ----------------------------------------------------------------------------
# the backend field
# ----------------------------------------------------------------------------

def test_backend_filter_keeps_one_devices_records():
    """Records of another backend take no part in a filtered fit: the
    mixed store tunes, selects and predicts exactly as the store of the
    host's records alone (and, unfiltered, as the reference on all of
    them); the predictor cache keeps one fit per backend."""
    best = dict(layout="panels", pr=16, xw=32, cb=8)
    worse = dict(layout="whole_vector", pr=0, xw=0, cb=256)
    cpu = planted(_cfg(TS, **best), _cfg(TS, **worse), S=TS)
    card = planted(_cfg(TS, **worse), _cfg(TS, **best), S=TS)  # reversed
    for r in cpu.records:
        r.backend = "cpu"
    for r in card.records:
        r.backend = "cuda:NVIDIA H100 80GB HBM3"
        r.gflops *= 10.0
    mixed = TS.RecordStore().extend(card).extend(cpu)
    f = TS.MatrixFeatures(0, 0, 0, 5.0, 2.0, 4.0, 0.25)
    assert TS.tune(f, store=mixed, kernel="2x8", backend="cpu") == \
        TS.tune(f, store=cpu, kernel="2x8") == _cfg(TS, **best)
    assert TS.tune(f, store=mixed, kernel="2x8",
                   backend="cuda:NVIDIA H100 80GB HBM3") == _cfg(TS, **worse)
    assert {k[2] for k in mixed.__dict__["_predictor_cache"]} == {
        "cpu", "cuda:NVIDIA H100 80GB HBM3"}
    # unfiltered: the reference's arithmetic on every record
    js = JS.RecordStore()
    js.records = [JS.Record(**_fields(r)) for r in mixed.records]
    jf = JS.MatrixFeatures(0, 0, 0, 5.0, 2.0, 4.0, 0.25)
    assert dataclasses.asdict(TS.tune(f, store=mixed, kernel="2x8")) == \
        dataclasses.asdict(JS.tune(jf, store=js, kernel="2x8"))
    # a backend with no record: the defaults
    assert TS.tune(f, store=mixed, backend="cuda:other") == \
        TS.DEFAULT_CONFIG
    assert TS.has_backend(mixed, "cpu") and not TS.has_backend(mixed, "")
    assert not TS.has_backend(None, "cpu")
    seq = TS.SequentialPredictor(mixed, backend="cpu")
    assert seq.coeffs.keys() == TS.SequentialPredictor(cpu).coeffs.keys()


def test_backend_of_names_the_device():
    import torch
    assert TS.backend_of("cpu") == "cpu"
    assert TS.backend_of(torch.device("cpu")) == "cpu"
    if torch.cuda.is_available():
        assert TS.backend_of("cuda") == \
            f"cuda:{torch.cuda.get_device_name(0)}"


# ----------------------------------------------------------------------------
# stores on disk
# ----------------------------------------------------------------------------

def test_jsonl_round_trip_v5(tmp_path):
    st = planted(_cfg(TS, layout="panels", pr=16, xw=32, cb=8),
                 _cfg(TS, layout="whole_vector", cb=256), S=TS)
    for i, r in enumerate(st.records):
        r.backend = "cpu" if i % 2 else "cuda:NVIDIA H100 80GB HBM3"
    p = str(tmp_path / "records.jsonl")
    st.save_jsonl(p)
    with open(p) as f:
        assert json.loads(f.readline()) == {"spc5_records_version": 5}
    assert TS.RecordStore(p).records == st.records
    assert TS.load_records(str(tmp_path)).records == st.records
    # the legacy single-array format keeps the field too
    lp = str(tmp_path / "legacy.json")
    st.save(lp)
    assert TS.RecordStore(lp).records == st.records
    # a newer schema than the port's is refused, as in the reference
    newer = tmp_path / "newer.jsonl"
    newer.write_text('{"spc5_records_version": 6}\n'
                     '{"kernel": "1x8", "avg": 2.0, "workers": 1, '
                     '"gflops": 1.0}\n')
    with pytest.raises(ValueError, match="newer"):
        TS.load_records(str(newer))


def test_reference_files_load_with_no_backend(tmp_path):
    """A v4 file the reference writes, and the reference's committed store
    (measured in CPU interpret mode), load into the port with
    ``backend=""`` and otherwise the reference's records."""
    js = planted(_cfg(JS, layout="panels", pr=16, xw=32, cb=8),
                 _cfg(JS, layout="whole_vector", cb=256))
    js.add("4x4", 2.0, 8, 9.9, pr=512, xw=1024, cb=64, layout="panels")
    p = str(tmp_path / "ref.jsonl")
    js.save_jsonl(p)
    t = TS.load_records(p)
    assert [_fields(r) for r in t.records] == [_fields(r) for r in
                                               js.records]
    assert {r.backend for r in t.records} == {""}
    ref = TS.load_records(REF_STORE)
    jref = JS.load_records(REF_STORE)
    assert len(ref.records) == len(jref.records) > 0
    assert {r.backend for r in ref.records} == {""}
    assert [_fields(r) for r in ref.records] == [_fields(r) for r in
                                                 jref.records]
    assert not TS.has_backend(ref, "cpu")


def test_load_records_merges_dedups_and_skips_like_the_reference(tmp_path):
    js = planted(_cfg(JS, layout="panels", pr=16, xw=32, cb=8),
                 _cfg(JS, layout="whole_vector", cb=256))
    js.save_jsonl(str(tmp_path / "a.jsonl"))
    js.save_jsonl(str(tmp_path / "a_copy.jsonl"))
    with open(tmp_path / "b.jsonl", "w") as f:
        f.write('{"spc5_records_version": 4}\n')
        f.write('{"kernel": "1x8", "avg": 2.0, "workers": 1, "gflops": 1.0}\n')
        f.write("not json\n")
        f.write('{"kernel": "1x8", "bogus": 1}\n')
    with pytest.warns(UserWarning):
        t = TS.load_records(str(tmp_path))
    with pytest.warns(UserWarning):
        j = JS.load_records(str(tmp_path))
    assert t.skipped == j.skipped == 2
    assert [_fields(r) for r in t.records] == [_fields(r) for r in
                                               j.records]


def test_env_var_and_default_store(tmp_path, monkeypatch):
    st = TS.RecordStore()
    st.add("1x8", 3.0, 1, 2.0, cb=64, layout="panels", pr=32, xw=32,
           backend="cpu")
    p = str(tmp_path / "records.jsonl")
    st.save_jsonl(p)
    monkeypatch.setenv(TS.RECORDS_ENV, p)
    got = TS.get_default_store()
    assert got is not None and got.records == st.records
    assert TS.get_default_store() is got            # cached until it changes
    TS.set_default_store(TS.RecordStore())
    assert TS.get_default_store().records == []     # explicit wins
    TS.set_default_store(None)
    monkeypatch.setenv(TS.RECORDS_ENV, str(tmp_path / "missing.jsonl"))
    with pytest.warns(RuntimeWarning, match="DISABLED"):
        assert TS.get_default_store() is None


# ----------------------------------------------------------------------------
# verify_records
# ----------------------------------------------------------------------------

def _stores():
    clean = JS.RecordStore()
    clean.add("1x8", 4.0, 1, 9.0, layout="whole_vector", lowering="mask")
    clean.add("2x4_test", 3.0, 2, 7.0, layout="test")
    bad = JS.RecordStore()
    bad.records.append(dataclasses.replace(JS.Record("1x8", 4.0, 1, 9.0),
                                           kernel="9x9"))
    bad.records.append(dataclasses.replace(JS.Record("1x8", 4.0, 1, 9.0),
                                           gflops=float("nan")))
    bad.records.append(dataclasses.replace(JS.Record("1x8", 4.0, 1, 9.0),
                                           workers=0))
    bad.records.append(dataclasses.replace(JS.Record("1x8", 4.0, 1, 9.0),
                                           pr=-1))
    skipped = JS.RecordStore()
    skipped.skipped = 2
    return {"clean": clean, "bad": bad, "skipped": skipped}


@pytest.mark.parametrize("name", ["clean", "bad", "skipped"])
@pytest.mark.parametrize("backend", ["", "cpu", "cuda:NVIDIA H100 80GB HBM3"])
def test_verify_records_matches_reference(name, backend):
    jstore = _stores()[name]
    tstore = mirror(jstore, backend)
    tstore.skipped = jstore.skipped
    jr, tr = JV.verify_records(jstore), TV.verify_records(tstore)
    assert tr.violations == tuple(TV.Violation(*dataclasses.astuple(v))
                                  for v in jr.violations)
    assert tr.checked == jr.checked
    # the reference's own store objects read as backend ""
    assert TV.verify_records(jstore).violations == tr.violations


@pytest.mark.parametrize("backend", ["cuda", "cuda:", "gpu", "tpu:v5e"])
def test_verify_records_flags_a_bad_backend(backend):
    st = TS.RecordStore()
    st.add("1x8", 4.0, 1, 9.0, layout="whole_vector", backend=backend)
    report = TV.verify_records(st)
    assert report.rules_fired == {"record-schema"}
    assert "backend" in report.violations[0].message
