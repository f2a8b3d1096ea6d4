"""The port's serving tier (``repro_torch.launch.server`` / ``.serve``)
against the reference's, on the host.

Both packages get the same numpy inputs: ``ServeConfig`` and its argparse
round trip, ``plan_request`` and the cache keys, the plans ``start`` builds
on the default matrix (byte-equal), coalesced results, admission and the
open-loop counts. The port's plans live on the CPU here
(``builder=functools.partial(ops.prepare, device="cpu")``, ``start(...,
device="cpu")``); on the CPU a coalesced SpMM column is bit for bit a lone
SpMV, as the reference pins. The differences ROADMAP §3 lists (the card's
roofline constant, float32 admission, the CLI without a decode loop) are
pinned here too.
"""
import argparse
import concurrent.futures
import dataclasses
import functools
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JMG
from repro.core import plan as JP
from repro.launch import resilience as JR
from repro.launch import server as JSV
from repro_torch import obs
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TMG
from repro_torch.core import plan as TP
from repro_torch.kernels import ops
from repro_torch.launch import resilience as R
from repro_torch.launch import serve
from repro_torch.launch import server as SV

WAIT_S = 60
CPU_PREPARE = functools.partial(ops.prepare, device="cpu")


def _pair(dim=512, density=0.05, seed=0, rc=(1, 8), cols=None):
    cols = dim // 2 if cols is None else cols
    return (TF.csr_to_spc5(TMG.pruned_weight(dim, cols, density, rc,
                                             seed=seed), *rc),
            JF.csr_to_spc5(JMG.pruned_weight(dim, cols, density, rc,
                                             seed=seed), *rc))


def _cache(**kw):
    return SV.PlanCache(builder=CPU_PREPARE, **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The server's threads and the host's other test workers already
    fill the cores: one intra-op thread each keeps small products from
    oversubscribing them."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Held(SV.SPC5Server):
    """A server whose gather thread starts only at :meth:`release`, so
    every request submitted before lands in one batch (up to the cap)
    however slowly the submits run."""

    def __init__(self, *a, **kw):
        self._go = threading.Event()
        super().__init__(*a, **kw)

    def release(self):
        self._go.set()

    def _gather_once(self):
        self._go.wait(WAIT_S)
        return super()._gather_once()


def _xs(n, ncols, seed=4, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(ncols).astype(dtype) for _ in range(n)]


def _bits(a):
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _assert_plans_equal(tplan, jplan):
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
            assert t.numpy().tobytes() == np.asarray(j).tobytes()
    assert tplan.rows_fused == jplan.rows_fused
    assert len(tplan.children) == len(jplan.children)
    for tc, jc in zip(tplan.children, jplan.children):
        _assert_plans_equal(tc, jc)


# ----------------------------------------------------------------------------
# ServeConfig, plan_request, cache keys
# ----------------------------------------------------------------------------

def test_serve_config_fields_defaults_and_choices_are_the_references():
    tf = dataclasses.fields(SV.ServeConfig)
    jf = dataclasses.fields(JSV.ServeConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert (a.type, a.default) == (b.type, b.default), a.name
        assert {k: v for k, v in a.metadata.items() if k != "help"} == \
            {k: v for k, v in b.metadata.items() if k != "help"}, a.name
    assert dataclasses.asdict(SV.ServeConfig()) == \
        dataclasses.asdict(JSV.ServeConfig())


ARGVS = [
    [],
    ["--vocab-spmv", "0.05", "--panel", "128,64,32", "--lowering",
     "descriptor", "--qps", "250", "--cache-mb", "16", "--verify"],
    ["--max-pending", "32", "--deadline-ms", "5", "--faults",
     "serve.exec:0.1:7", "--no-degrade", "--vdtype", "bf16"],
    ["--reorder", "rcm", "--metrics", "--metrics-path", "m.prom",
     "--trace-path", "t.json", "--window-us", "50", "--max-batch", "64",
     "--arch", "gemma-2b", "--kv-dtype", "int8"],
]


@pytest.mark.parametrize("argv", ARGVS, ids=range(len(ARGVS)))
def test_argparse_round_trip_and_plan_request_are_the_references(argv):
    configs = []
    for M in (SV, JSV):
        ap = argparse.ArgumentParser()
        M.add_config_args(ap)
        configs.append(M.config_from_args(ap.parse_args(argv)))
    tcfg, jcfg = configs
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert SV.plan_request(tcfg) == JSV.plan_request(jcfg)
    tmat, jmat = _pair(seed=2)
    req = SV.plan_request(tcfg)
    assert TP.plan_cache_key(tmat, **req) == JP.plan_cache_key(jmat, **req)


def test_bad_choices_are_refused_by_both_parsers():
    for M in (SV, JSV):
        ap = argparse.ArgumentParser()
        M.add_config_args(ap)
        with pytest.raises(SystemExit):
            ap.parse_args(["--lowering", "dense"])


def test_smoke_shapes_are_the_references_smoke_configs():
    from repro.configs import SMOKE_REGISTRY
    assert {arch: SV.smoke_shape(arch) for arch in SMOKE_REGISTRY} == \
        {arch: (cfg.vocab, cfg.d_model)
         for arch, cfg in SMOKE_REGISTRY.items()}
    with pytest.raises(KeyError):
        SV.smoke_shape("gpt-17")


START_CONFIGS = [
    dict(vocab_spmv=0.1),
    dict(vocab_spmv=0.1, lowering="mask"),
    dict(vocab_spmv=0.2, panel="128,32,16", lowering="mask"),
    dict(vocab_spmv=0.1, vdtype="bf16"),
    dict(vocab_spmv=0.1, reorder="rcm", lowering="mask", arch="gemma-2b"),
    dict(vocab_spmv=0.3, arch="granite-moe-3b-a800m", vdtype="int8",
         verify=True),
]


@pytest.mark.parametrize("kw", START_CONFIGS, ids=range(len(START_CONFIGS)))
def test_start_builds_the_references_plan(kw):
    tcfg, jcfg = SV.ServeConfig(**kw), JSV.ServeConfig(**kw)
    _assert_mats_equal(SV._default_matrix(tcfg), JSV._default_matrix(jcfg))
    with SV.start(tcfg, device="cpu") as tsrv, JSV.start(jcfg) as jsrv:
        _assert_plans_equal(tsrv.plan, jsrv.plan)
        assert tsrv.max_batch == jsrv.max_batch
        assert tsrv.cache.stats()["misses"] == 1
        assert tsrv.plan.device == torch.device("cpu")
        x = _xs(1, tsrv.plan.ncols)[0]
        np.testing.assert_allclose(
            tsrv.spmv(torch.from_numpy(x), timeout=WAIT_S).numpy(),
            np.asarray(jsrv.spmv(jnp.asarray(x), timeout=WAIT_S)),
            rtol=1e-5, atol=1e-6)


def _assert_mats_equal(tm, jm):
    assert (tm.shape, tm.r, tm.c) == (jm.shape, jm.r, jm.c)
    for name in ("block_rowptr", "block_colidx", "block_masks",
                 "block_voffset", "values"):
        assert getattr(tm, name).tobytes() == getattr(jm, name).tobytes()


def test_start_refuses_without_a_matrix_or_a_card():
    with pytest.raises(ValueError, match="needs a matrix"):
        SV.start(SV.ServeConfig(), device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SV.start(SV.ServeConfig(vocab_spmv=0.1))
    # a cache handed in keeps its builder's device
    tmat, _ = _pair(seed=5)
    cfg = SV.ServeConfig(panel="128,32,32", lowering="mask", window_us=500,
                         max_batch=4, cache_mb=8, verify=True)
    with SV.start(cfg, mat=tmat, cache=_cache(verify_on_admit=True)) as srv:
        assert srv.max_batch == 4 and srv.plan.device.type == "cpu"
        x = torch.ones(tmat.shape[1])
        assert torch.equal(srv.spmv(x, timeout=WAIT_S),
                           ops.spmv(srv.plan, x))


# ----------------------------------------------------------------------------
# PlanCache
# ----------------------------------------------------------------------------

PANELS = dict(layout="panels", pr=128, xw=32, cb=32, tune=False,
              lowering="mask")
WHOLE = dict(layout="whole_vector", cb=64, tune=False, lowering="mask")


def test_cache_hit_miss_eviction_like_the_reference():
    tmat, jmat = _pair()
    counts = []
    for M, mat, cache_of in ((SV, tmat, _cache), (JSV, jmat, JSV.PlanCache)):
        cache = cache_of(capacity_bytes=1 << 30, verify_on_admit=True)
        p1 = cache.get_or_build(mat, **PANELS)
        assert cache.get_or_build(mat, **PANELS) is p1
        cache.get_or_build(mat, **WHOLE)
        small = cache_of(capacity_bytes=M.P.plan_nbytes(p1) + 1)
        small.get_or_build(mat, **PANELS)
        small.get_or_build(mat, **WHOLE)
        small.get_or_build(mat, **PANELS)
        st, sm = cache.stats(), small.stats()
        counts.append((st["hits"], st["misses"], st["entries"], st["bytes"],
                       sm["hits"], sm["misses"], sm["evictions"],
                       sm["entries"], sm["bytes"]))
    assert counts[0] == counts[1]


def test_an_oversized_plan_is_admitted_after_evicting_everything():
    tmat, _ = _pair()
    cache = _cache(capacity_bytes=1)
    cache.get_or_build(tmat, **PANELS)
    plan = cache.get_or_build(tmat, **WHOLE)
    assert len(cache) == 1 and cache.evictions == 1
    assert cache.stats()["bytes"] == TP.plan_nbytes(plan)
    assert cache.get_or_build(tmat, **WHOLE) is plan


def test_verify_on_admission_rejects_a_corrupt_build():
    tmat, _ = _pair()
    good = _cache().get_or_build(tmat, **PANELS)
    corrupt = dataclasses.replace(
        good, arrays=(good.arrays[0][:3],) + good.arrays[1:])
    cache = SV.PlanCache(verify_on_admit=True, builder=lambda m, **kw:
                         corrupt, degrade=False)
    from repro_torch.analysis.verify import PlanVerificationError
    with pytest.raises(PlanVerificationError):
        cache.get_or_build(tmat, **PANELS)
    assert len(cache) == 0


def test_the_default_builder_is_ops_prepare_on_the_card():
    cache = SV.PlanCache()
    assert cache._build is ops.prepare
    if not torch.cuda.is_available():
        tmat, _ = _pair(dim=64)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            SV.PlanCache(degrade=False).get_or_build(tmat, **WHOLE)


# ----------------------------------------------------------------------------
# PlanExecStats: the card's roofline
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [WHOLE, PANELS,
                                dict(PANELS, lowering="descriptor"),
                                dict(WHOLE, vdtype="bf16"),
                                dict(WHOLE, lowering="descriptor",
                                     vdtype="int8")],
                         ids=range(5))
def test_roofline_is_the_references_at_the_cards_memory_rate(kw):
    tmat, jmat = _pair(seed=6, rc=(2, 4))
    tst = SV.PlanExecStats(ops.prepare(tmat, device="cpu", **kw))
    jst = JSV.PlanExecStats(JSV.PlanCache().get_or_build(jmat, **kw))
    assert SV.CARD_HBM_BW == 3.35e12 and TP.LOWERING_HBM_BW == 819e9
    assert jst.gflops_roofline > 0
    assert tst.gflops_roofline == pytest.approx(
        jst.gflops_roofline * 3.35e12 / 819e9, rel=1e-12)
    for st in (tst, jst):
        st.record(4, 1e-3)
        st.record(1, 1e-3)
    td, jd = tst.as_dict(), jst.as_dict()
    assert {k: td[k] for k in ("calls", "columns", "seconds",
                               "gflops_achieved")} == \
        {k: jd[k] for k in ("calls", "columns", "seconds",
                            "gflops_achieved")}


# ----------------------------------------------------------------------------
# Coalescing
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["whole_vector", "panels"])
@pytest.mark.parametrize("lowering", ["mask", "descriptor"])
def test_coalesced_spmm_is_bit_identical_on_the_cpu(layout, lowering):
    tmat, jmat = _pair(seed=3)
    kw = dict(layout=layout, cb=32, tune=False, lowering=lowering)
    if layout == "panels":
        kw.update(pr=128, xw=32)
    plan = _cache(verify_on_admit=True).get_or_build(tmat, **kw)
    xs = _xs(13, tmat.shape[1])         # odd count: the pow2 padding
    with _Held(plan, window_us=200, max_batch=16) as srv:
        futs = [srv.submit(torch.from_numpy(x)) for x in xs]
        srv.release()
        ys = [f.result(timeout=WAIT_S) for f in futs]
        assert srv.widest_batch == 13 and srv.batches == 1
    jplan = JSV.PlanCache().get_or_build(jmat, **kw)
    for y, x in zip(ys, xs):
        assert torch.equal(y, ops.spmv(plan, torch.from_numpy(x)))
        np.testing.assert_allclose(
            y.numpy(), np.asarray(JP.execute_spmv(jplan, jnp.asarray(x))),
            rtol=1e-5, atol=1e-5 * float(y.abs().max()))


def test_a_panel_tier_coalesces_to_width_256():
    """``--panel 128,512,32``: the cap is the plan's xw, 512, so 200
    requests held in one window make one SpMM at width 256."""
    tmat, _ = _pair(dim=600, cols=700, seed=11)
    cfg = SV.ServeConfig(panel="128,512,32", lowering="mask", cache_mb=64)
    with SV.start(cfg, mat=tmat, device="cpu") as started:
        assert started.max_batch == 512
    xs = _xs(200, 700, seed=12)
    with _Held(started.plan, cache=started.cache) as srv:
        assert srv.max_batch == 512
        futs = [srv.submit(torch.from_numpy(x)) for x in xs]
        srv.release()
        ys = [f.result(timeout=WAIT_S) for f in futs]
        assert srv.widest_batch == 200 and srv.batches == 1
        assert srv.stats()["degraded"] == 0
        assert SV._pow2_width(200, srv.max_batch) == 256
    _check_columns(ys, xs, tmat, srv.plan, bitwise=True)


def _check_columns(ys, xs, tmat, plan, bitwise):
    """Every column within 1e-5 of max|y| of the f64 product, and a
    spread of eight against a lone ``ops.spmv`` (bit for bit where
    ``bitwise``): a lone SpMV per column is slow on a loaded host."""
    dense = TF.spc5_to_csr(tmat).to_dense().astype(np.float64)
    y64 = dense @ np.stack(xs, axis=1).astype(np.float64)
    got = torch.stack(ys, dim=1).double().numpy()
    assert np.abs(got - y64).max() <= 1e-5 * np.abs(y64).max()
    n = len(xs)
    for j in sorted({0, 1, n // 3, n // 2, 2 * n // 3, n - 3, n - 2, n - 1}):
        lone = ops.spmv(plan, torch.from_numpy(xs[j]))
        if bitwise:
            assert torch.equal(ys[j], lone)
        else:
            torch.testing.assert_close(ys[j], lone, rtol=1e-5, atol=1e-6)


def test_a_cap_off_the_column_tile_degrades_like_the_reference():
    """A cap of 192 makes a 150-wide batch an SpMM at nvec 192, which the
    port's SpMM refuses on every device (the nvt rule, as the reference's
    kernels do): the batch is served by the oracle rung, counted."""
    tmat, _ = _pair(dim=256, seed=13)
    plan = _cache().get_or_build(tmat, **WHOLE)
    xs = _xs(150, tmat.shape[1], seed=14)
    with _Held(plan, max_batch=192) as srv:
        futs = [srv.submit(torch.from_numpy(x)) for x in xs]
        srv.release()
        ys = [f.result(timeout=WAIT_S) for f in futs]
        st = srv.stats()
    assert st["batches"] == 1 and st["degraded"] == 1
    assert SV._pow2_width(150, 192) == JSV._pow2_width(150, 192) == 192
    with pytest.raises(ValueError, match="not divisible"):
        ops.spmm(plan, torch.zeros(tmat.shape[1], 192))
    _check_columns(ys, xs, tmat, plan, bitwise=False)


class _CardLike(_Held):
    """A held server whose executor sees a card plan: ``_device`` turns to
    ``cuda`` at :meth:`release` (after the submits have been admitted on
    the host), there is nothing to synchronise, and the first dispatch of
    each batch raises ``exc``."""

    def __init__(self, *a, exc, **kw):
        self._exc = exc
        super().__init__(*a, **kw)

    def release(self):
        self._device = torch.device("cuda")
        super().release()

    def _ready(self):
        pass

    def _run_batch(self, reqs, oracle=False):
        if not oracle:
            raise self._exc
        return super()._run_batch(reqs, oracle=True)


@pytest.mark.parametrize("exc,degrades", [
    (obs.faults.FaultError("exec.spmm"), True),
    (ValueError("not divisible by the column tile"), False),
    (RuntimeError("the kernel did not build"), False)],
    ids=["injected-fault", "wrapper-refusal", "build-failure"])
def test_a_card_plan_takes_the_oracle_rung_only_for_an_injected_fault(
        plan, exc, degrades):
    """ROADMAP §3: on the card only an injected fault is served by the
    plain version; any other dispatch failure fails its callers, counted
    by the breaker, with nothing degraded (the CPU keeps the reference's
    ladder, as the column-tile test above shows)."""
    xs = _xs(3, plan.shape[1], seed=21)
    with _CardLike(plan, max_batch=8, exc=exc) as srv:
        futs = [srv.submit(torch.from_numpy(x)) for x in xs]
        srv.release()
        concurrent.futures.wait(futs, timeout=WAIT_S)
        st = srv.stats()
        if degrades:
            ys = [f.result(timeout=WAIT_S) for f in futs]
            for x, y in zip(xs, ys):
                assert torch.equal(y, ops.spmv(plan, torch.from_numpy(x)))
        else:
            for f in futs:
                with pytest.raises(type(exc)):
                    f.result(timeout=WAIT_S)
        assert srv._degradable(exc) is degrades
        assert srv._degradable(obs.faults.FaultError("exec.spmv"))
    assert st["batches"] == (1 if degrades else 0)
    assert st["degraded"] == (1 if degrades else 0)
    # the CPU degrades on any failure, unless the ladder is off
    with SV.SPC5Server(plan, max_batch=8) as cpu:
        assert cpu._degradable(exc)
    with SV.SPC5Server(plan, max_batch=8, degrade=False) as off:
        assert not off._degradable(obs.faults.FaultError("exec.spmm"))


@pytest.mark.parametrize("n,cap", [(1, 8), (3, 8), (8, 8), (9, 8), (5, 4),
                                   (100, 128), (129, 512), (300, 512)])
def test_pow2_width_is_the_references(n, cap):
    assert SV._pow2_width(n, cap) == JSV._pow2_width(n, cap)


# ----------------------------------------------------------------------------
# Admission
# ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def plan():
    return _cache().get_or_build(_pair()[0], **PANELS)


@pytest.fixture(scope="module")
def jplan():
    return JSV.PlanCache().get_or_build(_pair()[1], **PANELS)


def test_validation_rejects_poison_alone_like_the_reference(plan, jplan):
    ncols = plan.ncols
    bad = [np.full(ncols, np.nan, np.float32), np.ones(ncols + 1, np.float32),
           np.ones(ncols, np.int32), np.ones((2, ncols), np.float32),
           np.full(ncols, np.inf, np.float64)]
    with SV.SPC5Server(plan, window_us=20000, max_batch=8) as srv, \
            JSV.SPC5Server(jplan, window_us=100, max_batch=8) as jsrv:
        good = torch.ones(ncols)
        fut = srv.submit(good)
        for x in bad:
            with pytest.raises(ValueError) as e:
                srv.submit(torch.from_numpy(x))
            with pytest.raises(ValueError) as je:
                jsrv.submit(x)
            # the same reason; the dtype is spelled by each package
            assert str(e.value).split(", got")[0] == \
                str(je.value).split(", got")[0]
        assert torch.equal(fut.result(timeout=WAIT_S), ops.spmv(plan, good))
        assert srv.stats()["invalid"] == jsrv.stats()["invalid"] == len(bad)


@pytest.mark.parametrize("dtype", [np.float64, np.float16, "bfloat16",
                                   "list"])
def test_other_floating_x_is_cast_to_float32_at_admission(plan, jplan,
                                                           dtype):
    """The port's kernels take float32 x only: any other floating x is
    cast at admission, and its y holds to the reference's f64 result at
    the f32 tolerance."""
    x64 = np.random.default_rng(21).standard_normal(plan.ncols)
    if dtype == "bfloat16":
        x = torch.from_numpy(x64).to(torch.bfloat16)
        xref = x.float().double().numpy()
    elif dtype == "list":
        x, xref = x64.tolist(), x64
    else:
        x = x64.astype(dtype)
        xref = x.astype(np.float64)
    with SV.SPC5Server(plan, window_us=100, max_batch=8) as srv:
        y = srv.spmv(x, timeout=WAIT_S)
    assert y.dtype == torch.float32 and y.device == plan.device
    with JSV.SPC5Server(jplan, window_us=100, max_batch=8) as jsrv:
        jy = np.asarray(jsrv.spmv(xref, timeout=WAIT_S))
    np.testing.assert_allclose(y.numpy(), jy, rtol=1e-5,
                               atol=1e-5 * float(np.abs(jy).max()))


def test_a_value_past_float32_is_refused_as_non_finite(plan):
    x = np.ones(plan.ncols)
    x[3] = 1e300
    with SV.SPC5Server(plan) as srv:
        with pytest.raises(ValueError, match="non-finite"):
            srv.submit(x)


def test_single_request_and_a_closed_server(plan):
    srv = SV.SPC5Server(plan, window_us=100, max_batch=8)
    x = torch.ones(plan.ncols)
    assert torch.equal(srv.spmv(x, timeout=WAIT_S), ops.spmv(plan, x))
    srv.close()
    with pytest.raises(RuntimeError, match="closed"):
        srv.submit(x)


def test_stats_are_registry_views_and_one_trace(plan):
    reg = obs.Registry()
    tmat, _ = _pair(seed=15)
    cache = _cache(registry=reg, verify_on_admit=True)
    p = cache.get_or_build(tmat, **WHOLE)
    with SV.SPC5Server(p, cache=cache, window_us=500, max_batch=8) as srv:
        srv.submit(torch.ones(p.ncols)).result(timeout=WAIT_S)
        st = srv.stats()
    assert st["requests"] == reg.counter("spc5_server_requests_total").value \
        == 1
    assert st["batches"] == reg.counter("spc5_server_batches_total").value
    assert cache.misses == reg.counter(
        "spc5_plan_cache_misses_total").value == 1
    assert reg.histogram("spc5_server_batch_seconds").count == 1
    evs = {e.name: e for e in reg.spans()}
    assert evs["serve.batch"].parent_id == evs["serve.submit"].span_id
    assert evs["cache.verify"].parent_id == evs["cache.build"].span_id
    assert st["plan"]["calls"] == 1 and st["plan"]["gflops_achieved"] > 0
    names = {n for n in reg.instruments()}
    jnames = {"spc5_plan_cache_hits_total", "spc5_plan_cache_misses_total",
              "spc5_plan_cache_evictions_total",
              "spc5_plan_cache_degraded_total",
              "spc5_plan_cache_build_seconds", "spc5_server_requests_total",
              "spc5_server_batches_total", "spc5_server_coalesced_total",
              "spc5_server_widest_batch", "spc5_server_batch_seconds",
              "spc5_server_request_seconds", "spc5_server_shed_total",
              "spc5_server_expired_total", "spc5_server_invalid_total",
              "spc5_server_degraded_total",
              "spc5_server_worker_restarts_total"}
    assert names == jnames


def test_cache_and_server_totals_hold_under_a_thread_storm():
    """16 client threads (more than the cores) with a short switch
    interval share one cache and one server: every get_or_build counts
    one hit or miss, and every request one result."""
    import sys
    tmat, _ = _pair(dim=256, seed=16)
    cache = _cache(capacity_bytes=1 << 30)
    plan = cache.get_or_build(tmat, **WHOLE)
    x = torch.ones(plan.ncols)
    ref = ops.spmv(plan, x)
    bad = []
    srv = SV.SPC5Server(plan, cache=cache, window_us=200, max_batch=8,
                        max_pending=0)

    def client():
        for _ in range(10):
            if cache.get_or_build(tmat, **WHOLE) is not plan:
                bad.append("plan")
            if not torch.equal(srv.spmv(x, timeout=WAIT_S), ref):
                bad.append("y")

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=client) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=2 * WAIT_S)
    finally:
        sys.setswitchinterval(prev)
        srv.close()
    assert not any(t.is_alive() for t in ts) and bad == []
    assert cache.hits + cache.misses == 1 + 16 * 10 and cache.misses == 1
    st = srv.stats()
    assert st["requests"] == 16 * 10
    assert st["coalesced"] == st["requests"] - sum(
        1 for e in srv.registry.spans()
        if e.name == "serve.batch" and e.attrs["n"] == 1)


# ----------------------------------------------------------------------------
# open_loop
# ----------------------------------------------------------------------------

class _Scripted:
    """Submit outcomes scripted by their index: success, shed, failure,
    expiry; ``errors`` picks each package's typed errors."""

    def __init__(self, errors):
        self.n = 0
        self.errors = errors

    def spmv(self, x, timeout=None):
        return x

    def submit(self, x, **kw):
        self.n += 1
        mode = self.n % 4
        if mode == 1:
            raise self.errors.ShedError("scripted shed")
        fut = concurrent.futures.Future()
        if mode == 2:
            fut.set_exception(RuntimeError("scripted failure"))
        elif mode == 3:
            fut.set_exception(self.errors.DeadlineExceededError("expiry"))
        else:
            fut.set_result(x)
        return fut


def test_open_loop_counts_are_the_references():
    keys = ("qps_offered", "submitted", "completed", "shed", "expired",
            "errors")
    res = [M.open_loop(_Scripted(E), [np.ones(4)], qps=400,
                       duration_s=0.1, seed=3, warmup=0)
           for M, E in ((SV, R), (JSV, JR))]
    assert {k: res[0][k] for k in keys} == {k: res[1][k] for k in keys}
    r = res[0]
    assert r["submitted"] == r["completed"] + r["shed"] + r["expired"] + \
        r["errors"]
    assert r["shed"] > 0 and r["errors"] > 0 and r["expired"] > 0
    assert r["qps_achieved"] == pytest.approx(r["completed"] /
                                              r["elapsed_s"])


def test_open_loop_and_sweep_on_a_real_tier(plan):
    xs = [torch.ones(plan.ncols)]
    with SV.SPC5Server(plan, window_us=500, max_batch=16) as srv:
        res = SV.open_loop(srv, xs, qps=200, duration_s=0.2, seed=7)
        pts = SV.saturation_sweep(srv, xs, qps0=100, factor=2,
                                  max_points=2, duration_s=0.1)
    assert res["completed"] >= 1
    assert res["shed"] == res["expired"] == res["errors"] == 0
    assert 0 < res["p50_us"] <= res["p99_us"]
    assert 1 <= len(pts) <= 2 and pts[0]["qps_offered"] == 100


# ----------------------------------------------------------------------------
# The CLI
# ----------------------------------------------------------------------------

def test_the_cli_with_vocab_spmv_0_decodes_and_builds_no_plan(
        capsys, monkeypatch):
    """``--vocab-spmv 0`` runs the decode loop and stops, as the
    reference does: no plan is built and no tier starts."""
    from repro_torch.core import sparse_linear
    from repro_torch.kernels import ops

    def refuse(*a, **k):
        raise AssertionError("a plan was built")
    monkeypatch.setattr(ops, "prepare", refuse)
    monkeypatch.setattr(sparse_linear.SparseLinear, "from_dense", refuse)
    monkeypatch.setattr(SV, "start", refuse)
    serve.main(["--vocab-spmv", "0", "--arch", "gemma-2b", "--batch", "2",
                "--tokens", "8"], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1
    assert out[0].startswith("gemma-2b: 2x8 tokens, ")
    assert out[0].endswith(" tok/s (kv=bfloat16, mesh=1 device)")


@pytest.mark.parametrize("flag,value,line", [
    ("--batch", "3", "yi-6b: 3x32 tokens, "),
    ("--tokens", "6", "yi-6b: 4x6 tokens, "),
    ("--kv-dtype", "int8", "(kv=int8, mesh=1 device)"),
])
def test_decode_knobs_go_to_the_decode_loop(flag, value, line, capsys):
    """``--batch``, ``--tokens`` and ``--kv-dtype`` configure the decode
    loop, which prints the reference's tok/s line before the vocab bench;
    ``start`` takes them and serves as before."""
    serve.main(["--vocab-spmv", "0.1", flag, value], device="cpu")
    out = capsys.readouterr().out.strip().splitlines()
    assert line in out[0] and " tok/s (kv=" in out[0]
    assert out[1].startswith("vocab_spmv[256x64@0.1]: ")
    ap = argparse.ArgumentParser()
    SV.add_config_args(ap)
    cfg = SV.config_from_args(ap.parse_args(["--vocab-spmv", "0.1", flag,
                                             value]))
    tmat, _ = _pair(seed=3)
    SV.start(cfg, mat=tmat, device="cpu").close()


def test_mesh_still_names_item_13(capsys):
    """``--mesh`` shards the decode loop, which the port does not yet: the
    CLI and ``start`` refuse it, naming the item, before anything runs."""
    with pytest.raises(SystemExit) as e:
        serve.main(["--vocab-spmv", "0.1", "--mesh", "1x4"], device="cpu")
    assert "ROADMAP queue 1 item 13" in str(e.value.code)
    assert "--mesh 1x4" in str(e.value.code)
    assert capsys.readouterr().out == ""
    tmat, _ = _pair(seed=3)
    with pytest.raises(SystemExit, match="item 13"):
        SV.start(SV.ServeConfig(vocab_spmv=0.1, mesh="1x4"), mat=tmat,
                 device="cpu")
    SV.refuse_decode_knobs(SV.ServeConfig(vocab_spmv=0.1, arch="gemma-2b",
                                          batch=8, tokens=64,
                                          kv_dtype="int8"))


@pytest.mark.parametrize("arch,part", [("phi3.5-moe-42b-a6.6b", "13a"),
                                       ("mamba2-370m", "13b"),
                                       ("recurrentgemma-9b", "13b"),
                                       ("seamless-m4t-medium", "13c")])
def test_an_unported_arch_names_its_part_of_item_13(arch, part, capsys):
    with pytest.raises(SystemExit) as e:
        serve.main(["--arch", arch, "--vocab-spmv", "0.1"], device="cpu")
    assert f"ROADMAP queue 1 item {part}" in str(e.value.code)
    assert capsys.readouterr().out == ""


def test_the_cli_serves_and_exports_on_the_host(tmp_path, capsys):
    prom, trace = str(tmp_path / "m.prom"), str(tmp_path / "t.json")
    prev = obs.set_registry(obs.Registry())
    try:
        serve.main(["--vocab-spmv", "0.1", "--qps", "300", "--duration-s",
                    "0.2", "--metrics", "--metrics-path", prom,
                    "--trace-path", trace, "--lowering", "mask"],
                   device="cpu")
    finally:
        obs.set_registry(prev)
    out = capsys.readouterr().out
    assert "vocab_serve[256x64@0.1]" in out and "errors=0" in out
    with open(prom) as f:
        samples = obs.export.parse_prometheus(f.read())
    assert samples["spc5_server_requests_total"] >= 1
    assert samples["spc5_plan_cache_misses_total"] == 1
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    ids = {e["args"]["span_id"]: e["name"] for e in events}
    batches = [e for e in events if e["name"] == "serve.batch"]
    assert batches and all(ids.get(e["args"].get("parent_id")) ==
                           "serve.submit" for e in batches)
    assert {"plan.tune", "plan.build", "cache.build"} <= set(ids.values())


def test_the_cli_bench_runs_on_the_host(capsys):
    serve.main(["--vocab-spmv", "0.2", "--lowering", "mask", "--verify"],
               device="cpu")
    out = capsys.readouterr().out
    assert "verify: plan ok" in out
    assert "vocab_spmv[256x64@0.2]" in out and "lowering=mask" in out
