"""The port's observability layer (``repro_torch.obs``) against the JAX
package's (``repro.obs``), and the spans and fault points of the port's
plan pipeline.

Both packages get the same observations, spans and fault specs; their
percentiles, bucket bounds, Prometheus text, JSON snapshots, Chrome-trace
events (timestamps, durations and thread ids aside) and fault draws must be
the same. Each package keeps its own global registry and fault set.
"""
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from repro import obs as jobs
from repro.obs import export as JE
from repro.obs import faults as JFL
from repro.obs import metrics as JM
from repro_torch import obs as tobs
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TMG
from repro_torch.kernels import ops
from repro_torch.obs import export as TE
from repro_torch.obs import faults as TFL
from repro_torch.obs import metrics as TM

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _disarmed():
    """Every test leaves both packages' global fault sets disarmed."""
    prev = TFL.set_faults(None), JFL.set_faults(None)
    yield
    TFL.set_faults(prev[0])
    JFL.set_faults(prev[1])


def _samples(seed=0, n=3000):
    return [float(x) for x in
            np.random.default_rng(seed).lognormal(-7.0, 1.5, n)]


def _twin_registries(samples):
    """The same instruments and observations in both packages."""
    out = []
    for M in (TM, JM):
        reg = M.Registry()
        reg.counter("req_total", "requests").inc(42)
        reg.gauge("widest", "widest batch").set_max(7.0)
        h = reg.histogram("lat_seconds", "latency")
        for x in samples:
            h.observe(x)
        reg.histogram("empty_seconds")
        out.append(reg)
    return out


# ----------------------------------------------------------------------------
# Instruments
# ----------------------------------------------------------------------------

def test_bucket_bounds_are_the_references():
    assert TM.HISTOGRAM_BOUNDS == JM.HISTOGRAM_BOUNDS
    assert TM.BUCKET_RATIO == JM.BUCKET_RATIO
    assert tobs.monotonic is time.perf_counter


@pytest.mark.parametrize("q", [0, 1, 25, 50, 90, 99, 99.9, 100])
def test_histogram_percentiles_equal_the_references(q):
    samples = _samples() + [1e-9, 5e3]      # below the first bound, overflow
    th, jh = TM.Histogram("t"), JM.Histogram("j")
    for x in samples:
        th.observe(x)
        jh.observe(x)
    assert th.percentile(q) == jh.percentile(q)
    assert (th.count, th.sum, th.min, th.max, th.mean) == \
        (jh.count, jh.sum, jh.min, jh.max, jh.mean)
    assert th.state() == jh.state()
    want = float(np.percentile(samples, q))
    if 1 <= q <= 99:
        assert want / TM.BUCKET_RATIO <= th.percentile(q) \
            <= want * TM.BUCKET_RATIO


def test_disabled_registry_hands_out_shared_no_ops():
    reg = TM.Registry(enabled=False)
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")
    assert c is TM.NULL_COUNTER and g is TM.NULL_GAUGE \
        and h is TM.NULL_HISTOGRAM
    assert reg.counter("other") is c
    c.inc(5)
    g.set(7.0)
    h.observe(1.0)
    assert (c.value, g.value, h.count) == (0, 0.0, 0)
    with reg.span("work", k=1) as sp:
        pass
    assert sp.span_id == 0 and sp.duration_s == 0.0
    assert reg.spans() == [] and reg.instruments() == {}
    enabled = TM.Registry()
    assert enabled.counter("x_total") is enabled.counter("x_total")
    with pytest.raises(ValueError, match="already registered"):
        enabled.histogram("x_total")


def test_instruments_exact_under_thread_storm():
    """More threads than cores and a short switch interval: a lost update
    in inc / set_max / observe would break the totals."""
    import sys
    reg = TM.Registry()
    c, g, h = reg.counter("c"), reg.gauge("g"), reg.histogram("h")

    def work(k):
        for i in range(2000):
            c.inc()
            g.set_max(k * 2000 + i)
            h.observe(1e-3)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(prev)
    assert not any(t.is_alive() for t in ts)
    assert c.value == h.count == 16 * 2000
    assert g.value == 16 * 2000 - 1


# ----------------------------------------------------------------------------
# Exporters, on the same observations
# ----------------------------------------------------------------------------

def test_prometheus_text_is_the_references():
    treg, jreg = _twin_registries(_samples(1))
    text = TE.to_prometheus(treg)
    assert text == JE.to_prometheus(jreg)
    samples = TE.parse_prometheus(text)
    assert samples == JE.parse_prometheus(text)
    assert samples["req_total"] == 42.0
    assert samples['lat_seconds_bucket{le="+Inf"}'] == 3000.0


def _strip_spans(snap):
    return dict(snap, spans=[{k: v for k, v in s.items()
                              if k not in ("t_start", "duration_s",
                                           "thread_id")}
                             for s in snap["spans"]])


def test_snapshot_and_load_snapshot_round_trip_like_the_reference():
    treg, jreg = _twin_registries(_samples(2))
    for reg in (treg, jreg):
        with reg.span("outer", n=3):
            with reg.span("inner"):
                pass
    tsnap = json.loads(json.dumps(TE.snapshot(treg)))
    jsnap = json.loads(json.dumps(JE.snapshot(jreg)))
    assert _strip_spans(tsnap) == _strip_spans(jsnap)
    t2, j2 = TE.load_snapshot(tsnap), JE.load_snapshot(jsnap)
    assert isinstance(t2, TM.Registry)
    # help texts are not part of a snapshot, in either package
    assert TE.to_prometheus(t2) == JE.to_prometheus(j2)
    assert TE.parse_prometheus(TE.to_prometheus(t2)) == \
        TE.parse_prometheus(TE.to_prometheus(treg))
    for q in (50, 99):
        assert t2.histogram("lat_seconds").percentile(q) == \
            treg.histogram("lat_seconds").percentile(q)


def test_chrome_trace_events_are_the_references(tmp_path):
    regs = TM.Registry(), JM.Registry()
    for reg in regs:
        ctx = {}

        def worker(reg=reg):
            with reg.span("serve.batch", parent=ctx["id"], n=4):
                pass

        with reg.span("serve.submit") as sp:
            ctx["id"] = sp.span_id
            t = threading.Thread(target=worker)
            t.start()
            t.join()
        with reg.span("plan.build", layout="panels"):
            pass
    path = str(tmp_path / "trace.json")
    TE.dump_chrome_trace(regs[0], path)
    with open(path) as f:
        tdoc = json.load(f)
    jdoc = JE.to_chrome_trace(regs[1])

    def fields(doc):
        return [{k: v for k, v in ev.items() if k not in ("ts", "dur", "tid")}
                for ev in doc["traceEvents"]]

    assert fields(tdoc) == fields(jdoc)
    assert tdoc["displayTimeUnit"] == jdoc["displayTimeUnit"] == "ms"
    ev = {e["name"]: e for e in tdoc["traceEvents"]}
    assert ev["serve.batch"]["args"]["parent_id"] == \
        ev["serve.submit"]["args"]["span_id"]
    assert ev["serve.batch"]["tid"] != ev["serve.submit"]["tid"]
    assert all(e["ph"] == "X" and e["dur"] >= 0 and e["ts"] >= 0
               for e in tdoc["traceEvents"])


def test_dump_helpers_write_what_the_exporters_render(tmp_path):
    treg, _ = _twin_registries(_samples(3, 100))
    jpath, ppath = str(tmp_path / "o.json"), str(tmp_path / "o.prom")
    TE.dump_json(treg, jpath)
    TE.dump_prometheus(treg, ppath)
    with open(jpath) as f:
        assert json.load(f)["counters"]["req_total"]["value"] == 42
    with open(ppath) as f:
        assert f.read() == TE.to_prometheus(treg)


def test_span_buffer_is_bounded_and_nests():
    reg = TM.Registry(max_spans=4)
    with reg.span("outer") as so:
        for i in range(6):
            with reg.span(f"s{i}"):
                pass
    names = [e.name for e in reg.spans()]
    assert names == ["s3", "s4", "s5", "outer"]
    assert all(e.parent_id == so.span_id for e in reg.spans()[:3])


# ----------------------------------------------------------------------------
# Fault injection
# ----------------------------------------------------------------------------

def test_catalogue_and_spec_grammar_are_the_references():
    assert sorted(TFL.CATALOGUE) == sorted(JFL.CATALOGUE)
    assert len(TFL.CATALOGUE) == 6
    for spec in ("", "exec.spmv:0.5", " serve.exec:0.1:7 , plan.build:1 ",
                 ",".join(f"{p}:0.1:{i}" for i, p in
                          enumerate(sorted(JFL.CATALOGUE)))):
        assert TFL.Faults.parse_spec(spec) == JFL.Faults.parse_spec(spec)


@pytest.mark.parametrize("spec", ["serve.gathr:0.1", "exec.spmv",
                                  "exec.spmv:1.5", "nowhere:0.1:3",
                                  "exec.spmv:0.1:1:2"])
def test_bad_specs_raise_the_references_error(spec):
    with pytest.raises(ValueError) as te:
        TFL.Faults(spec)
    with pytest.raises(ValueError) as je:
        JFL.Faults(spec)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("spec", ["exec.spmv:0.3:42", "exec.spmv:0.1:0",
                                  "exec.spmv:0.5:9,serve.exec:0.5:1",
                                  "plan.build:0:3,cache.admit:1:4"])
def test_seeded_draws_are_the_references(spec):
    tf, jf = TFL.Faults(spec), JFL.Faults(spec)
    points = sorted(TFL.CATALOGUE)
    rng = np.random.default_rng(5)
    order = [points[i] for i in rng.integers(0, len(points), 400)]
    assert [tf.check(p) for p in order] == [jf.check(p) for p in order]
    assert tf.stats() == jf.stats()
    assert tf.points == jf.points


def test_maybe_fail_suppress_and_null_faults():
    f = TFL.Faults("exec.spmv:1:0")
    with pytest.raises(TFL.FaultError) as e:
        f.maybe_fail("exec.spmv")
    assert e.value.point == "exec.spmv"
    assert str(e.value) == str(JFL.FaultError("exec.spmv"))
    seen = {}

    def probe():
        seen["fired"] = f.check("exec.spmv")

    with f.suppress():
        assert not f.check("exec.spmv")
        t = threading.Thread(target=probe)
        t.start()
        t.join()
    assert seen["fired"] and f.check("exec.spmv")
    assert not TFL.NULL_FAULTS and not TFL.NULL_FAULTS.enabled
    TFL.NULL_FAULTS.maybe_fail("exec.spmv")
    assert TFL.get_faults() is TFL.NULL_FAULTS


def test_faults_from_env_reads_spc5_faults():
    assert TFL.faults_from_env({}) is TFL.NULL_FAULTS
    env = {"SPC5_FAULTS": "serve.exec:0.25:3"}
    assert TFL.faults_from_env(env).points == ("serve.exec",)
    code = ("from repro_torch.obs import faults as F\n"
            "print(F.get_faults().points)\n")
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        timeout=120, env=dict(os.environ, SPC5_FAULTS="exec.spmm:0.5:2",
                              PYTHONPATH=os.path.join(REPO, "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "('exec.spmm',)"


def test_each_package_has_its_own_registry_and_fault_set():
    assert tobs.get_registry() is not jobs.get_registry()
    armed = TFL.Faults("exec.spmv:1:0")
    TFL.set_faults(armed)
    assert JFL.get_faults() is JFL.NULL_FAULTS
    JFL.set_faults(JFL.Faults("serve.exec:1:0"))
    assert TFL.get_faults() is armed
    prev = tobs.set_registry(TM.Registry())
    try:
        with tobs.span("port.only"):
            pass
        assert "port.only" in {e.name for e in tobs.get_registry().spans()}
        assert "port.only" not in {e.name for e in jobs.get_registry().spans()}
    finally:
        tobs.set_registry(prev)


# ----------------------------------------------------------------------------
# The plan pipeline's spans, trace and fault points
# ----------------------------------------------------------------------------

def _mat(rc=(1, 8)):
    csr = TMG.pruned_weight(256, 128, 0.05, rc, seed=0)
    return TF.csr_to_spc5(csr, *rc)


PLANS = [dict(layout="whole_vector", cb=64, tune=False, lowering="mask"),
         dict(layout="panels", pr=64, xw=16, cb=32, tune=False,
              lowering="descriptor"),
         dict(layout="test", tune=False),
         dict(reorder="rcm", layout="panels", pr=64, xw=16, cb=32,
              tune=False),
         {}]


@pytest.mark.parametrize("kw", PLANS, ids=lambda kw: kw.get("layout", "auto")
                         + ("-" + kw["reorder"] if "reorder" in kw else ""))
def test_every_pass_runs_under_a_span_and_stamps_its_duration(kw):
    prev = tobs.set_registry(TM.Registry())
    try:
        plan = ops.prepare(_mat(), device="cpu", **kw)
        spans = tobs.get_registry().spans()
    finally:
        tobs.set_registry(prev)
    trace = plan.trace
    assert [e["pass"] for e in trace][:4] == ["tune", "reorder", "layout",
                                              "build"]
    assert all(isinstance(e["duration_s"], float) and e["duration_s"] >= 0
               for e in trace)
    # the outer plan's passes are the top-level spans (a test plan's multi
    # sub-plan runs its passes inside the outer build span)
    top = {ev.name: ev for ev in spans if ev.parent_id is None}
    assert sorted(top) == ["plan.build", "plan.layout", "plan.reorder",
                           "plan.tune"]
    for e in trace[:4]:
        assert top[f"plan.{e['pass']}"].duration_s == e["duration_s"]
    assert top["plan.build"].attrs == {"layout": plan.layout}
    inner = [ev for ev in spans if ev.parent_id is not None]
    assert all(ev.parent_id == top["plan.build"].span_id for ev in inner)
    assert len(inner) == 4 * len(plan.children)


def test_a_disabled_global_registry_stamps_zero_durations():
    prev = tobs.set_registry(TM.Registry(enabled=False))
    try:
        plan = ops.prepare(_mat(), device="cpu", **PLANS[0])
    finally:
        tobs.set_registry(prev)
    assert [e["duration_s"] for e in plan.trace] == [0.0] * 4


def test_fault_points_fire_in_the_build_and_the_executors():
    mat = _mat()
    plan = ops.prepare(mat, device="cpu", **PLANS[0])
    x = torch.ones(plan.ncols)
    TFL.set_faults(TFL.Faults("plan.build:1:0"))
    with pytest.raises(TFL.FaultError, match="plan.build"):
        ops.prepare(mat, device="cpu", **PLANS[0])
    TFL.set_faults(TFL.Faults("exec.spmv:1:0"))
    with pytest.raises(TFL.FaultError, match="exec.spmv"):
        ops.spmv(plan, x)
    ops.spmm(plan, torch.ones(plan.ncols, 4))       # unarmed point
    TFL.set_faults(TFL.Faults("exec.spmm:1:0"))
    with pytest.raises(TFL.FaultError, match="exec.spmm"):
        ops.spmm(plan, torch.ones(plan.ncols, 4))
    with TFL.get_faults().suppress():
        ops.spmm(plan, torch.ones(plan.ncols, 4))
    # arming the reference fails nothing of the port
    TFL.set_faults(None)
    JFL.set_faults(JFL.Faults("plan.build:1:0,exec.spmv:1:0"))
    ops.spmv(ops.prepare(mat, device="cpu", **PLANS[0]), x)
