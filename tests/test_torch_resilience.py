"""The port's resilience layer and its chaos contract, on the host.

``repro_torch.launch.resilience`` (the degradation ladder, the circuit
breaker, supervised workers) against the reference's, and the port's
serving tier (``repro_torch.launch.server``, plans on the CPU) held to the
reference's resilience contract: with the catalogued fault points armed,
nothing deadlocks, shed / expired / degraded requests are typed and
counted, and every request that resolves with a result matches the plain
product. Fault sequences are seed-pinned, so a failure here replays.

The handoff race of the reference's server (a batch put on the prefetch
queue after the executor's give-up drained it, so its future never
resolves) is forced here by hooks and must fail the batch in the port.
"""
import collections
import concurrent.futures
import functools
import queue
import threading

import numpy as np
import pytest
import torch

from repro.core import formats as JF
from repro.core import matgen as JMG
from repro.launch import resilience as JR
from repro.launch import server as JSV
from repro.obs import faults as JFL
from repro_torch import obs
from repro_torch.core import formats as TF
from repro_torch.core import matgen as TMG
from repro_torch.kernels import ops
from repro_torch.launch import resilience as R
from repro_torch.launch import server as SV
from repro_torch.obs import faults as FL

#: Every wait on a future: an upper bound, never a pace.
WAIT_S = 60

PANELS = dict(layout="panels", pr=64, xw=16, cb=32, tune=False,
              lowering="mask")
CPU_PREPARE = functools.partial(ops.prepare, device="cpu")


def _mat(dim=256, density=0.05, seed=0, rc=(1, 8)):
    csr = TMG.pruned_weight(dim, dim // 2, density, rc, seed=seed)
    return TF.csr_to_spc5(csr, *rc)


def _jmat(dim=256, density=0.05, seed=0, rc=(1, 8)):
    csr = JMG.pruned_weight(dim, dim // 2, density, rc, seed=seed)
    return JF.csr_to_spc5(csr, *rc)


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


@pytest.fixture(autouse=True)
def _disarm_faults():
    """Every test leaves both packages' global fault sets disarmed."""
    prev = FL.set_faults(None), JFL.set_faults(None)
    yield
    FL.set_faults(prev[0])
    JFL.set_faults(prev[1])


def _arm(spec):
    FL.set_faults(FL.Faults(spec))
    return FL.get_faults()


@pytest.fixture(scope="module")
def plan():
    return _cache().get_or_build(_mat(), **PANELS)


def _server(plan, **kw):
    kw.setdefault("window_us", 200)
    kw.setdefault("max_batch", 8)
    return SV.SPC5Server(plan, **kw)


def _ones(plan):
    return torch.ones(plan.ncols)


# ----------------------------------------------------------------------------
# The ladder, the breaker, the supervisor
# ----------------------------------------------------------------------------

REQUESTS = [
    {"lowering": "auto", "vdtype": "auto"},
    dict(PANELS),
    dict(PANELS, vdtype="bf16"),
    {"lowering": "descriptor", "vdtype": "int8", "reorder": "rcm",
     "layout": "whole_vector", "cb": 64},
    {"lowering": "mask", "vdtype": "f32", "tune": False, "reorder": None},
    {"dtype": "float32", "lowering": "auto", "config": "cfg"},
    {},
]


@pytest.mark.parametrize("request_", REQUESTS, ids=range(len(REQUESTS)))
def test_ladder_yields_the_references_rungs(request_):
    assert list(R.ladder_requests(dict(request_))) == \
        list(JR.ladder_requests(dict(request_)))


def test_ladder_rungs_from_an_auto_request():
    rungs = list(R.ladder_requests({"lowering": "auto", "vdtype": "auto"}))
    assert [r[0] for r in rungs] == ["mask-lowering", "f32-values",
                                     "reference"]
    assert [r[2] for r in rungs] == [False, False, True]
    assert rungs[2][1]["tune"] is False and rungs[2][1]["reorder"] is None


class _Clock:
    """A hand-moved ``obs.monotonic`` for the breaker's reset window."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_circuit_breaker_trips_half_opens_and_closes(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(obs, "monotonic", clock)
    br = R.CircuitBreaker(threshold=2, reset_s=5.0)
    assert br.state == "closed" and br.allow()
    br.record_failure()
    assert br.allow()                       # below threshold
    br.record_failure()
    assert br.state == "open" and not br.allow()
    clock.t += 4.9
    assert br.state == "open" and not br.allow()
    clock.t += 0.2
    assert br.state == "half-open"
    assert br.allow()                       # ONE probe gets through
    assert not br.allow()
    br.record_success()
    assert br.state == "closed" and br.allow()
    br.record_failure()
    br.record_failure()
    clock.t += 5.0
    assert br.allow()
    br.record_failure()                     # a failed probe re-opens
    assert not br.allow()
    br.force_open()
    clock.t += 100.0
    br.record_success()
    assert br.state == "open" and not br.allow()


def test_supervised_worker_restarts_and_resets_its_streak():
    restarts = obs.Registry().counter("t_restarts")
    calls = {"n": 0}

    def iteration():
        calls["n"] += 1
        if calls["n"] in (1, 2, 4):
            raise RuntimeError(f"crash {calls['n']}")
        if calls["n"] >= 5:
            return R.DONE
        return None

    w = R.SupervisedWorker("t", iteration, restarts=restarts,
                           max_restarts=2, backoff_s=0.001).start()
    assert w.join(WAIT_S)
    assert w.done and not w.gave_up
    assert w.crashes == 3 and restarts.value == 3 and calls["n"] == 5


def test_supervised_worker_gives_up_after_its_budget():
    gave = []

    def iteration():
        raise RuntimeError("hard wedge")

    w = R.SupervisedWorker("t", iteration, max_restarts=2, backoff_s=0.001,
                           on_give_up=gave.append).start()
    assert w.join(WAIT_S)
    assert w.gave_up and w.done and w.crashes == 3
    assert len(gave) == 1 and "hard wedge" in str(gave[0])


def test_typed_errors_are_the_references_kinds():
    assert issubclass(R.ShedError, RuntimeError)
    assert issubclass(R.DeadlineExceededError, TimeoutError)
    assert issubclass(R.CircuitOpenError, RuntimeError)
    assert R.FaultError is FL.FaultError
    assert R.DONE is not JR.DONE            # each package its own sentinel


# ----------------------------------------------------------------------------
# The build-side ladder: PlanCache.get_or_build under injected failures
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("spec,verify", [("plan.build:1:0", False),
                                         ("cache.admit:1:0", True)])
@pytest.mark.parametrize("request_", [PANELS, {}], ids=["mask", "auto"])
def test_build_ladder_lands_on_the_references_rungs(spec, verify, request_):
    FL.set_faults(FL.Faults(spec))
    JFL.set_faults(JFL.Faults(spec))
    tplan = _cache(verify_on_admit=verify).get_or_build(_mat(), **request_)
    jplan = JSV.PlanCache(verify_on_admit=verify).get_or_build(
        _jmat(), **request_)
    tdeg = [e for e in tplan.trace if e["pass"] == "degrade"]
    jdeg = [e for e in jplan.trace if e["pass"] == "degrade"]
    assert [e["rung"] for e in tdeg] == [e["rung"] for e in jdeg]
    assert tdeg[-1]["rung"] == "reference"
    assert [e["reason"] for e in tdeg] == [e["reason"] for e in jdeg]
    assert all(e["duration_s"] >= 0 for e in tdeg)
    FL.set_faults(None)
    from repro_torch.analysis.verify import verify_plan
    verify_plan(tplan).raise_if_failed()
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        tplan.ncols).astype(np.float32))
    ref = ops.prepare(_mat(), device="cpu", **PANELS)
    torch.testing.assert_close(ops.spmv(tplan, x), ops.spmv(ref, x),
                               rtol=1e-5, atol=1e-6)


def test_degrade_off_raises_and_caches_nothing():
    _arm("plan.build:1:0")
    cache = _cache(degrade=False)
    with pytest.raises(FL.FaultError):
        cache.get_or_build(_mat(), **PANELS)
    assert len(cache) == 0 and cache.stats()["degraded"] == 0


def test_partial_ladder_stops_at_the_first_working_rung():
    calls = []

    def builder(m, **kw):
        calls.append(dict(kw))
        if kw.get("vdtype") != "f32":
            raise RuntimeError("quantised store corrupt")
        return ops.prepare(m, device="cpu", **kw)

    plan = SV.PlanCache(builder=builder).get_or_build(
        _mat(), vdtype="bf16", **PANELS)
    assert [e["rung"] for e in plan.trace if e["pass"] == "degrade"] == \
        ["f32-values"]
    assert calls[-1]["vdtype"] == "f32"


# ----------------------------------------------------------------------------
# Admission control: shedding, deadlines, close
# ----------------------------------------------------------------------------

def test_admission_bound_sheds_instead_of_queueing(plan):
    x = _ones(plan)
    with _server(plan, window_us=500000, max_batch=1, max_pending=4) as srv:
        admitted, shed = [], 0
        for _ in range(64):
            try:
                admitted.append(srv.submit(x))
            except R.ShedError:
                shed += 1
        assert shed > 0 and len(srv._pending) <= srv.max_pending
        assert srv.stats()["shed"] == shed
        ref = ops.spmv(plan, x)
        for f in admitted:
            assert torch.equal(f.result(timeout=WAIT_S), ref)


def test_deadline_drops_before_dispatch(plan):
    x = _ones(plan)
    with _server(plan, window_us=50000, max_batch=8) as srv:
        doomed = srv.submit(x, deadline_s=1e-7)
        live = srv.submit(x)
        with pytest.raises(R.DeadlineExceededError):
            doomed.result(timeout=WAIT_S)
        assert torch.equal(live.result(timeout=WAIT_S), ops.spmv(plan, x))
        assert srv.stats()["expired"] == 1


def test_deadline_propagation_property(plan):
    """A deadline no thread handoff can meet never yields a result, a
    generous one always does, and the middle ground resolves to exactly
    one of {result, DeadlineExceededError}."""
    rng = np.random.default_rng(11)
    x = _ones(plan)
    ref = ops.spmv(plan, x)
    with _server(plan, window_us=5000, max_batch=4) as srv:
        futs = []
        for _ in range(48):
            kind = int(rng.integers(0, 3))
            dl = (float(rng.uniform(1e-8, 1e-7)) if kind == 0 else
                  60.0 if kind == 1 else float(rng.uniform(1e-3, 2e-2)))
            futs.append((kind, srv.submit(x, deadline_s=dl)))
        for kind, f in futs:
            try:
                y = f.result(timeout=WAIT_S)
                assert kind != 0, "an unreachable deadline produced a result"
                assert torch.equal(y, ref)
            except R.DeadlineExceededError:
                assert kind != 1, "a generous deadline expired"
        st = srv.stats()
        assert st["expired"] >= sum(1 for k, _ in futs if k == 0)
        assert st["expired"] + st["requests"] == len(futs)


def test_submit_racing_close_is_clean(plan):
    x = _ones(plan)
    outcomes = collections.Counter()
    srv = _server(plan)
    futs = []

    def hammer():
        for _ in range(200):
            try:
                futs.append(srv.submit(x))
                outcomes["admitted"] += 1
            except RuntimeError:
                outcomes["refused"] += 1

    t = threading.Thread(target=hammer)
    t.start()
    srv.close()
    t.join()
    assert outcomes["admitted"] + outcomes["refused"] == 200
    assert not concurrent.futures.wait(futs, timeout=WAIT_S).not_done


def test_close_is_loud_when_stuck_and_resolves_every_future(plan,
                                                             monkeypatch):
    from repro_torch.core import plan as P
    x = _ones(plan)
    unwedge = threading.Event()
    orig = P.execute_spmv

    def wedged(plan_, x_, **kw):
        unwedge.wait(WAIT_S)
        return orig(plan_, x_, **kw)

    monkeypatch.setattr(P, "execute_spmv", wedged)
    srv = _server(plan, max_batch=1, prefetch_depth=1)
    futs = [srv.submit(x) for _ in range(6)]
    with pytest.raises(RuntimeError, match="still running"):
        srv.close(timeout=0.3)
    unwedge.set()
    assert not concurrent.futures.wait(futs, timeout=WAIT_S).not_done


def test_close_is_idempotent_and_drains(plan):
    x = _ones(plan)
    srv = _server(plan)
    futs = [srv.submit(x) for _ in range(8)]
    srv.close()
    srv.close()
    ref = ops.spmv(plan, x)
    for f in futs:
        assert torch.equal(f.result(timeout=WAIT_S), ref)
    with pytest.raises(RuntimeError):
        srv.submit(x)


# ----------------------------------------------------------------------------
# Supervised workers and the exec ladder under injected crashes
# ----------------------------------------------------------------------------

def test_worker_crashes_restart_without_losing_requests(plan):
    _arm("serve.gather:0.4:5,serve.exec:0.4:6")
    x = _ones(plan)
    ref = ops.spmv(plan, x)
    with _server(plan) as srv:
        futs = [srv.submit(x) for _ in range(24)]
        for f in futs:
            assert torch.equal(f.result(timeout=WAIT_S), ref)
        assert srv.stats()["worker_restarts"] >= 1


def test_exec_ladder_serves_through_kernel_faults(plan):
    _arm("exec.spmv:1:0,exec.spmm:1:0")
    x = _ones(plan)
    with _server(plan, window_us=20000, max_batch=8) as srv:
        ys = [f.result(timeout=WAIT_S) for f in
              [srv.submit(x) for _ in range(8)]]
        assert srv.stats()["degraded"] >= 1
    FL.set_faults(None)
    ref = ops.spmv(plan, x)
    for y in ys:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)


class _Gated(SV.SPC5Server):
    """The executor's first iteration waits for :meth:`open_gate`: a
    request submitted before is admitted by a closed breaker however
    slowly the submitting thread runs."""

    def __init__(self, *a, **kw):
        self._gate = threading.Event()
        super().__init__(*a, **kw)

    def open_gate(self):
        self._gate.set()

    def _exec_once(self):
        self._gate.wait(WAIT_S)
        return super()._exec_once()


def test_wedged_tier_opens_breaker_and_fails_fast(plan):
    """The port's copy of the reference's test, gated: in the reference's
    the executor may give up (two crashes, 10 ms apart) before the test's
    first submit, which then raises CircuitOpenError outside the check
    meant for the future (how it fails under load)."""
    _arm("serve.exec:1:0")                  # the executor cannot run at all
    x = _ones(plan)
    srv = _Gated(plan, window_us=200, max_batch=8, max_restarts=1)
    try:
        fut = srv.submit(x)
        srv.open_gate()
        with pytest.raises(R.CircuitOpenError):
            fut.result(timeout=WAIT_S)
        assert srv._exec_worker.join(WAIT_S) and srv._exec_worker.gave_up
        assert srv._breaker.state == "open"
        with pytest.raises(R.CircuitOpenError):
            srv.submit(x)
    finally:
        FL.set_faults(None)
        srv.close(timeout=10)


class _HandoffRace(SV.SPC5Server):
    """Forces the reference's handoff race: the executor crashes (and,
    at ``max_restarts=0``, gives up and drains the queue) only after the
    gather thread passed its liveness check and entered the put, and the
    put lands only after that drain."""

    def __init__(self, *a, **kw):
        self.put_entered = threading.Event()
        self.gave_up = threading.Event()
        super().__init__(*a, **kw)

    def _exec_once(self):
        self.put_entered.wait(WAIT_S)
        raise RuntimeError("executor wedged")

    def _on_worker_give_up(self, exc):
        super()._on_worker_give_up(exc)
        self.gave_up.set()


class _PutAfterGiveUp(queue.Queue):
    def __init__(self, srv, maxsize):
        super().__init__(maxsize)
        self.srv = srv

    def put(self, item, block=True, timeout=None):
        assert not self.srv._exec_worker.done   # the check has passed
        self.srv.put_entered.set()
        assert self.srv.gave_up.wait(WAIT_S)    # give-up and drain ran
        super().put(item, block, timeout)


def test_a_batch_handed_off_during_the_give_up_is_failed_not_stranded(plan):
    srv = _HandoffRace(plan, max_restarts=0)
    srv._batches = _PutAfterGiveUp(srv, 2)
    try:
        fut = srv.submit(_ones(plan))
        with pytest.raises(R.CircuitOpenError, match="handed off"):
            fut.result(timeout=WAIT_S)
        assert srv._batches.empty()
    finally:
        srv.close(timeout=10)


def test_no_degrade_server_fails_callers_typed(plan):
    _arm("exec.spmv:1:0,exec.spmm:1:0")
    with _server(plan, degrade=False) as srv:
        with pytest.raises(FL.FaultError):
            srv.submit(_ones(plan)).result(timeout=WAIT_S)


# ----------------------------------------------------------------------------
# The chaos storm: every catalogued point at 10 %, threaded clients
# ----------------------------------------------------------------------------

def test_chaos_storm_all_points_ten_percent():
    mat = _mat(seed=7)
    ref_plan = _cache().get_or_build(mat, **PANELS)
    x_pool = [torch.from_numpy(np.random.default_rng(i).standard_normal(
        ref_plan.ncols).astype(np.float32)) for i in range(4)]
    refs = [ops.spmv(ref_plan, x) for x in x_pool]
    _arm(",".join(f"{p}:0.1:{i}" for i, p in enumerate(sorted(
        FL.CATALOGUE))))
    cache = _cache(verify_on_admit=True)
    plan_ = cache.get_or_build(mat, **PANELS)
    srv = SV.SPC5Server(plan_, window_us=500, max_batch=8, max_pending=64)
    outcomes = collections.Counter()
    mismatches = []
    lock = threading.Lock()

    def client(tid):
        rng = np.random.default_rng(tid)
        for i in range(20):
            j = int(rng.integers(0, len(x_pool)))
            try:
                fut = srv.submit(x_pool[j])
            except (R.ShedError, R.CircuitOpenError) as e:
                with lock:
                    outcomes[type(e).__name__] += 1
                continue
            try:
                y = fut.result(timeout=WAIT_S)
            except (R.DeadlineExceededError, FL.FaultError,
                    R.CircuitOpenError,
                    concurrent.futures.CancelledError) as e:
                with lock:
                    outcomes[type(e).__name__] += 1
                continue
            with lock:
                outcomes["ok"] += 1
                if not torch.allclose(y, refs[j], rtol=1e-5, atol=1e-6):
                    mismatches.append((tid, i))

    threads = [threading.Thread(target=client, args=(t,)) for t in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=2 * WAIT_S)
    assert all(not t.is_alive() for t in threads), "a client hung"
    srv.close()
    assert mismatches == []
    assert outcomes["ok"] >= 1 and sum(outcomes.values()) == 6 * 20
    assert srv.stats()["requests"] == outcomes["ok"]
    stats = FL.get_faults().stats()
    for point in ("serve.gather", "serve.exec", "exec.spmv"):
        assert stats[point]["checks"] > 0


@pytest.mark.parametrize("point", ["plan.build", "cache.admit", "exec.spmv",
                                   "exec.spmm", "serve.gather"])
def test_every_single_point_is_survivable(point):
    mat = _mat(seed=8)
    x = torch.ones(mat.shape[1])
    rate = 0.5 if point == "serve.gather" else 1.0
    _arm(f"{point}:{rate}:0")
    plan_ = _cache(verify_on_admit=True).get_or_build(mat, **PANELS)
    with SV.SPC5Server(plan_, window_us=500, max_batch=4) as srv:
        ys = [f.result(timeout=WAIT_S) for f in
              [srv.submit(x) for _ in range(6)]]
    FL.set_faults(None)
    ref = ops.spmv(_cache().get_or_build(mat, **PANELS), x)
    for y in ys:
        torch.testing.assert_close(y, ref, rtol=1e-5, atol=1e-6)


def test_serve_config_resilience_knobs_flow_to_the_tier():
    mat = _mat(seed=9)
    cfg = SV.ServeConfig(panel="64,16,32", lowering="mask", max_pending=7,
                         deadline_ms=250.0, cache_mb=8)
    with SV.start(cfg, mat=mat, device="cpu") as srv:
        assert srv.max_pending == 7 and srv.degrade
        assert srv.deadline_s == pytest.approx(0.25)
    cfg2 = SV.ServeConfig(panel="64,16,32", lowering="mask",
                          no_degrade=True, cache_mb=8,
                          faults="exec.spmv:0:0")
    with SV.start(cfg2, mat=mat, device="cpu") as srv:
        assert not srv.degrade and not srv.cache.degrade
        assert FL.get_faults().points == ("exec.spmv",)
        assert JFL.get_faults() is JFL.NULL_FAULTS
