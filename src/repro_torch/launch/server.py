"""Persistent SpMV serving tier on the card: plan cache, request coalescing,
traffic.

The port of ``repro.launch.server``, with the same names, knobs, counters
and contracts; the persistent tier behind ``repro_torch.launch.serve`` and
the programmatic ``start(config)`` path:

  * :class:`ServeConfig` -- every serve knob as one frozen dataclass (the
    reference's fields, defaults and choices). The CLI's argparse flags
    are GENERATED from its fields (:func:`add_config_args` /
    :func:`config_from_args`).
  * :class:`PlanCache` -- built plans keyed by
    ``plan.plan_cache_key(mat, **request)`` (matrix content fingerprint +
    the normalised prepare request; the device is not part of the key),
    verified at admission time (``repro_torch.analysis.verify``), evicted
    LRU by tensor footprint (``plan.plan_nbytes``). Its default builder is
    ``ops.prepare``, so its plans go on the card.
  * :class:`SPC5Server` -- request coalescing: concurrent ``submit`` calls
    gather into ONE SpMM up to the plan's ``xw`` (128 where the plan has
    none) under a bounded-wait batching window, with the next microbatch
    prefetched (a depth-2 handoff queue). Batches pad to power-of-two
    widths with zero columns. A batch is ready when the card has finished
    it: the executor thread synchronises its current CUDA stream inside
    the ``serve.batch`` span, before any future resolves.
  * :func:`open_loop` / :func:`saturation_sweep` -- the open-loop traffic
    harness: Poisson arrivals at a configured QPS, p50/p99 from a
    ``repro_torch.obs`` histogram, achieved-vs-offered QPS.

Coalesced results. On the CPU the plain versions compute each column of a
coalesced SpMM bit for bit as a lone SpMV, as the reference pins. On the
card the whole-vector kernels and the split panel kernels add into Y with
global atomics, so a coalesced column agrees with a lone ``ops.spmv`` to
f32 rounding, not bit for bit (ROADMAP §3, deliberate differences).

The tier degrades, not falls over (``repro_torch.launch.resilience``,
``repro_torch.obs.faults``): admission control (validation, the
``max_pending`` bound, deadlines, the circuit breaker), supervised gather
and exec workers, and the degradation ladder -- a failed build or
admission retries down ``resilience.ladder_requests``, a failed dispatch
retries once on the plain PyTorch oracle (``use_pallas=False``) on the
plan's device, counted in ``spc5_server_degraded_total``. On the card only
an injected fault takes that rung; any other dispatch failure fails its
callers.

Every counter, latency distribution and timed region here is a
``repro_torch.obs`` instrument or span under the reference's names
(``spc5_plan_cache_*``, ``spc5_server_*``, ``serve.submit`` ->
``serve.batch``).
"""
from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import dataclasses
import functools
import queue
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import formats as F
from repro_torch.core import plan as P
from repro_torch.launch import resilience


# ----------------------------------------------------------------------------
# ServeConfig: the one declaration of every serve knob
# ----------------------------------------------------------------------------

def _knob(default, help: str, **meta):
    meta["help"] = help
    return dataclasses.field(default=default, metadata=meta)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Every serve knob, CLI and programmatic alike: the reference's fields,
    defaults and choices, so both packages' CLIs take the same flags.

    The field set is the source of truth: ``add_config_args`` generates one
    ``--flag`` per field (``_`` -> ``-``). The decode-loop knobs (``arch``,
    ``batch``, ``tokens``, ``mesh``, ``kv_dtype``) feed the CLI's decode
    loop (``mesh`` lays it out over the ranks ``torchrun`` starts); ``arch``
    also picks the default matrix's shape."""

    # --- decode-loop launcher (arch: also the vocab shape) ---
    arch: str = _knob("yi-6b", "model architecture for the decode loop")
    batch: int = _knob(4, "decode batch size")
    tokens: int = _knob(32, "tokens to decode")
    mesh: str = _knob("", "DxM device mesh, e.g. 1x4 (empty = 1 device)")
    kv_dtype: str = _knob("bfloat16", "KV-cache dtype",
                          choices=["bfloat16", "int8"])

    # --- sparse-layer build inputs ---
    records: str = _knob("", "SPC5 record store (file or dir) for "
                             "auto-tuned sparse-layer configs")
    vocab_spmv: float = _knob(0.0, "bench/serve a pruned vocab projection "
                                   "at this density (0 = off)",
                              metavar="DENSITY")
    panel: str = _knob("", "explicit pr,xw,cb (overrides the tuned config)")
    reorder: str = _knob("", "reordering strategy (sigma, rcm, colwindow, "
                             "auto; empty = none)")
    lowering: str = _knob("auto", "kernel lowering",
                          choices=["auto", "mask", "descriptor"])
    vdtype: str = _knob("auto", "stored value dtype for the sparse layer "
                                "(quantised stores accumulate in f32)",
                        choices=["auto", "f32", "bf16", "int8"])
    verify: bool = _knob(False, "statically verify records on load and "
                                "every plan at cache-admission time")

    # --- serving tier ---
    cache_mb: int = _knob(256, "plan-cache capacity in MiB (LRU by plan "
                               "device-array bytes)")
    window_us: float = _knob(200.0, "coalescing bounded-wait window in "
                                    "microseconds")
    max_batch: int = _knob(0, "coalescing cap (0 = the plan's tuned xw)")
    prefetch_depth: int = _knob(2, "microbatches stacked ahead of the "
                                   "executor")
    qps: float = _knob(0.0, "open-loop Poisson arrival rate; with "
                            "--vocab-spmv routes the bench through the "
                            "serving tier (0 = closed-loop microbench)")
    duration_s: float = _knob(0.5, "open-loop bench duration per QPS point")

    # --- resilience (repro_torch.launch.resilience / obs.faults) ---
    max_pending: int = _knob(1024, "admission-control bound on queued "
                                   "requests; submit sheds beyond it "
                                   "(0 = unbounded)")
    deadline_ms: float = _knob(0.0, "per-request deadline in milliseconds; "
                                    "expired requests drop before dispatch "
                                    "(0 = none)")
    faults: str = _knob("", "arm fault injection: point:rate[:seed],... "
                            "over repro_torch.obs.faults.CATALOGUE (chaos "
                            "runs; same spec as SPC5_FAULTS)")
    no_degrade: bool = _knob(False, "disable the graceful-degradation "
                                    "ladder: fail a broken build/dispatch "
                                    "instead of demoting down the lattice")

    # --- observability (repro_torch.obs) ---
    metrics: bool = _knob(False, "record serve metrics/spans on the global "
                                 "obs registry and export them at exit")
    metrics_path: str = _knob("serve_metrics.prom", "Prometheus text "
                              "snapshot path (with --metrics)")
    trace_path: str = _knob("serve_trace.json", "Chrome trace_event "
                            "timeline path (with --metrics)")


def add_config_args(ap: argparse.ArgumentParser,
                    cls=ServeConfig) -> argparse.ArgumentParser:
    """Generate one ``--flag`` per ``cls`` field (the only argparse source
    for serve knobs; bools become ``store_true`` switches)."""
    for f in dataclasses.fields(cls):
        flag = "--" + f.name.replace("_", "-")
        meta = dict(f.metadata)
        if isinstance(f.default, bool):
            ap.add_argument(flag, action="store_true",
                            help=meta.get("help"))
        else:
            ap.add_argument(flag, type=type(f.default), default=f.default,
                            **meta)
    return ap


def config_from_args(args: argparse.Namespace, cls=ServeConfig):
    """The parsed-namespace -> config half of the argparse round trip."""
    return cls(**{f.name: getattr(args, f.name)
                  for f in dataclasses.fields(cls)})


def plan_request(config: ServeConfig) -> Dict[str, object]:
    """The ``ops.prepare`` keyword request a config describes -- also the
    cache-key payload (``plan.plan_cache_key`` normalises the defaults)."""
    req: Dict[str, object] = {"lowering": config.lowering,
                              "vdtype": config.vdtype}
    if config.panel:
        pr, xw, cb = (int(v) for v in config.panel.split(","))
        req.update(layout="panels", pr=pr, xw=xw, cb=cb, tune=False)
    if config.reorder:
        req["reorder"] = config.reorder
    return req


# ----------------------------------------------------------------------------
# PlanCache: fingerprint-keyed, verify-on-admission, LRU by plan bytes
# ----------------------------------------------------------------------------

#: The card's memory rate for :class:`PlanExecStats`' roofline: the H100
#: SXM's 3.35 TB/s (NVIDIA data sheet, at 700 W). ``plan.LOWERING_HBM_BW``
#: keeps the TPU's 819 GB/s, which only the reference's lowering choice
#: reads (ROADMAP §3, deliberate differences).
CARD_HBM_BW = 3.35e12


class PlanExecStats:
    """Per-plan execution stats, recorded on the cache entry: how many
    dispatches this plan served, how many request columns they carried,
    and the achieved gflops against the roofline ceiling for THIS plan's
    layout x lowering x value dtype (``formats.spmv_bytes_per_nnz`` at the
    plan's avg nnz/block, its value itemsize and descriptor lane bytes,
    x the card's memory rate :data:`CARD_HBM_BW`). The seconds are each
    batch's ``serve.batch`` span, which ends after the card finished."""

    def __init__(self, plan: P.SPC5Plan):
        meta = dict(plan.meta)
        self.nnz = int(meta.get("nnz") or 0)
        self._lock = threading.Lock()
        self.calls = 0
        self.columns = 0
        self.seconds = 0.0
        self.gflops_roofline = 0.0
        r, c, nblocks = meta.get("r"), meta.get("c"), meta.get("nblocks")
        lowering = meta.get("lowering")
        if self.nnz and r and c and nblocks and lowering in (
                P.LOWERING_MASK, P.LOWERING_DESC):
            bpn = F.spmv_bytes_per_nnz(
                int(r), int(c), self.nnz / nblocks, lowering,
                s_float=F.value_itemsize(meta.get("vdtype") or ""),
                desc_lane_nbytes=meta.get("desc_lane_nbytes"))
            self.gflops_roofline = 2.0 / bpn * CARD_HBM_BW / 1e9

    def record(self, ncols: int, seconds: float) -> None:
        with self._lock:
            self.calls += 1
            self.columns += int(ncols)
            self.seconds += seconds

    @property
    def gflops_achieved(self) -> float:
        return (2.0 * self.nnz * self.columns / self.seconds / 1e9
                if self.seconds > 0 else 0.0)

    def as_dict(self) -> Dict[str, float]:
        ach = self.gflops_achieved
        return {"calls": self.calls, "columns": self.columns,
                "seconds": self.seconds, "gflops_achieved": ach,
                "gflops_roofline": self.gflops_roofline,
                "roofline_fraction": (ach / self.gflops_roofline
                                      if self.gflops_roofline else 0.0)}


class PlanCache:
    """Built plans keyed by (matrix fingerprint, normalised request), as in
    the reference.

    ``get_or_build`` hashes the matrix CONTENT plus every requested build
    decision, so a re-uploaded but identical matrix hits while one flipped
    mask bit or a different lowering misses. Admission optionally proves
    the fresh plan (``repro_torch.analysis.verify.verify_plan``) before it
    can serve a request; eviction is LRU by ``plan.plan_nbytes`` against
    ``capacity_bytes`` (a plan larger than the capacity is still admitted,
    after everything else is evicted). Thread-safe.

    ``builder`` defaults to ``ops.prepare``: plans on the card. Pass
    ``functools.partial(ops.prepare, device="cpu")`` for plans on the
    host. The counters are ``repro_torch.obs`` counters on ``registry``
    (a private registry per cache by default); each entry carries a
    :class:`PlanExecStats` the serving tier feeds per dispatch.

    With ``degrade=True`` (the default) a failed build or admission -- a
    builder exception, a verify rejection, an injected ``plan.build`` or
    ``cache.admit`` fault -- retries down
    :func:`resilience.ladder_requests`; the plan the ladder lands on is
    cached under the ORIGINAL request's key with each demotion appended to
    ``plan.trace`` as a ``{"pass": "degrade"}`` entry and counted in
    ``spc5_plan_cache_degraded_total``.
    """

    def __init__(self, capacity_bytes: int = 256 << 20, *,
                 verify_on_admit: bool = False,
                 builder: Optional[Callable[..., P.SPC5Plan]] = None,
                 registry: Optional[obs.Registry] = None,
                 degrade: bool = True):
        self.capacity_bytes = int(capacity_bytes)
        self.verify_on_admit = verify_on_admit
        self.degrade = degrade
        if builder is None:
            from repro_torch.kernels import ops
            builder = ops.prepare
        self._build = builder
        self._entries: "collections.OrderedDict[str, tuple]" = \
            collections.OrderedDict()   # key -> (plan, nbytes, PlanExecStats)
        self._bytes = 0
        self._lock = threading.Lock()
        self.registry = registry if registry is not None else obs.Registry()
        self._hits = self.registry.counter(
            "spc5_plan_cache_hits_total", "plan-cache hits")
        self._misses = self.registry.counter(
            "spc5_plan_cache_misses_total", "plan-cache misses")
        self._evictions = self.registry.counter(
            "spc5_plan_cache_evictions_total", "plan-cache LRU evictions")
        self._degraded = self.registry.counter(
            "spc5_plan_cache_degraded_total",
            "builds served by a degradation-ladder rung")
        self._build_seconds = self.registry.histogram(
            "spc5_plan_cache_build_seconds", "cold plan-build wall time")

    # counters are views over the registry, never writable ints
    @property
    def hits(self) -> int:
        return self._hits.value

    @property
    def misses(self) -> int:
        return self._misses.value

    @property
    def evictions(self) -> int:
        return self._evictions.value

    def _build_attempt(self, mat: F.SPC5Matrix, request: Dict[str, object],
                       *, suppress: bool = False) -> P.SPC5Plan:
        """One ladder rung: build, verify (when configured), admit. The
        injected ``cache.admit`` fault fires AFTER a successful build,
        exactly where a verify rejection would surface; the reference
        rung runs with injection suppressed on this thread."""
        faults = obs.faults.get_faults()
        with faults.suppress() if suppress else contextlib.nullcontext():
            plan = self._build(mat, **request)
            if self.verify_on_admit:
                from repro_torch.analysis.verify import verify_plan
                with self.registry.span("cache.verify"):
                    verify_plan(plan).raise_if_failed()
            faults.maybe_fail("cache.admit")
        return plan

    def _admit(self, mat: F.SPC5Matrix,
               request: Dict[str, object]) -> P.SPC5Plan:
        """Build the requested plan, demoting down the ladder on failure
        (when ``degrade``); raises the LAST rung's error if every rung
        fails. The returned plan's trace carries one ``degrade`` entry
        per rung tried, so "which rung served this" is auditable."""
        try:
            return self._build_attempt(mat, request)
        except Exception as e:      # noqa: BLE001 -- ladder entry point
            if not self.degrade:
                raise
            last: Exception = e
        entries: List[dict] = []
        for rung, req, suppress in resilience.ladder_requests(request):
            with self.registry.span("cache.degrade", rung=rung) as sp:
                try:
                    plan = self._build_attempt(mat, req, suppress=suppress)
                    err = None
                except Exception as e:  # noqa: BLE001 -- try the next rung
                    err = e
            entries.append({"pass": "degrade", "rung": rung,
                            "reason": f"{type(last).__name__}: {last}",
                            "duration_s": sp.duration_s})
            if err is None:
                self._degraded.inc()
                return P.append_trace_entries(plan, entries)
            last = err
        raise last

    def get_or_build(self, mat: F.SPC5Matrix, **request) -> P.SPC5Plan:
        key = P.plan_cache_key(mat, **request)
        with self._lock:
            hit = self._entries.get(key)
            if hit is not None:
                self._entries.move_to_end(key)
                self._hits.inc()
                return hit[0]
            self._misses.inc()
        # build outside the lock: a slow build must not serialise hits
        with self.registry.span("cache.build") as sp:
            plan = self._admit(mat, request)
        self._build_seconds.observe(sp.duration_s)
        nbytes = P.plan_nbytes(plan)
        with self._lock:
            if key not in self._entries:
                while self._entries and self._bytes + nbytes > \
                        self.capacity_bytes:
                    _, (_, old, _) = self._entries.popitem(last=False)
                    self._bytes -= old
                    self._evictions.inc()
                self._entries[key] = (plan, nbytes, PlanExecStats(plan))
                self._bytes += nbytes
        return plan

    def stats_for(self, plan: P.SPC5Plan) -> PlanExecStats:
        """The exec-stats slot for a cached plan (by identity); plans the
        cache no longer holds get a fresh, unattached slot."""
        with self._lock:
            for p, _, st in self._entries.values():
                if p is plan:
                    return st
        return PlanExecStats(plan)

    def __len__(self) -> int:
        return len(self._entries)

    def stats(self) -> Dict[str, float]:
        total = self.hits + self.misses
        out = {"hits": self.hits, "misses": self.misses,
               "evictions": self.evictions,
               "degraded": self._degraded.value,
               "entries": len(self._entries),
               "bytes": self._bytes, "capacity_bytes": self.capacity_bytes,
               "hit_rate": self.hits / total if total else 0.0}
        with self._lock:
            out["plans"] = [dict(st.as_dict(), layout=p.layout)
                            for p, _, st in self._entries.values()]
        return out


# ----------------------------------------------------------------------------
# SPC5Server: bounded-wait coalescing with async microbatch prefetch
# ----------------------------------------------------------------------------

#: ``ctx`` is the submit span's id: the exec thread opens its batch span
#: with ``parent=ctx`` so the cross-thread request lifetime is one trace.
#: ``deadline`` is an ABSOLUTE ``obs.monotonic`` time (or None).
_Request = collections.namedtuple("_Request", "x future t_submit deadline ctx")


def _pow2_width(n: int, cap: int) -> int:
    """Batches pad to power-of-two widths (capped at the coalescing limit)
    so the executor sees a bounded set of SpMM shapes."""
    w = 1
    while w < n:
        w <<= 1
    return min(w, max(cap, n))


class SPC5Server:
    """Coalesce concurrent SpMV requests into one SpMM on the plan's device.

    ``submit(x)`` enqueues a vector and returns a future. A gather thread
    drains the queue into microbatches: it takes the first waiter, then
    holds the batch open for at most ``window_us`` or until ``max_batch``
    columns -- the plan's ``xw`` by default, 128 for a plan without one (a
    whole-vector plan). Finished batches land on a depth-
    ``prefetch_depth`` handoff queue that the executor thread takes from.
    A single-request batch runs ``execute_spmv``; a wider one is stacked
    into an (ncols, width) X padded with zero columns to the next power of
    two and runs ``execute_spmm``. The executor launches on its own
    current CUDA stream and synchronises it inside the ``serve.batch``
    span, so ``spc5_server_batch_seconds`` covers the kernel and a future
    resolves to a y the card has finished.

    Both threads are :class:`resilience.SupervisedWorker` iterations;
    ``submit`` is the admission-control gate (validation, ``max_pending``
    shedding, deadlines, circuit breaker); a failed dispatch retries once
    on the plain PyTorch oracle (``use_pallas=False, double_buffer=False``)
    under ``faults.suppress()`` before failing its callers -- on the card
    only when the failure is an injected fault (:meth:`_degradable`).

    Unlike the reference's copy, a batch handed off while the executor
    gives up is never stranded: :meth:`_handoff` re-checks the executor
    after its put and fails what the give-up's drain could not see.
    """

    def __init__(self, plan: P.SPC5Plan, *, cache: Optional[PlanCache] = None,
                 window_us: float = 200.0, max_batch: int = 0,
                 prefetch_depth: int = 2,
                 registry: Optional[obs.Registry] = None,
                 max_pending: int = 1024, deadline_s: float = 0.0,
                 degrade: bool = True, max_restarts: int = 8,
                 breaker_threshold: int = 8, breaker_reset_s: float = 0.5):
        self.plan = plan
        self.cache = cache
        meta = dict(plan.meta)
        self.max_batch = int(max_batch) if max_batch and max_batch > 0 \
            else int(meta.get("xw") or 128)
        self.window_s = float(window_us) * 1e-6
        self.max_pending = max(0, int(max_pending))
        self.deadline_s = float(deadline_s)
        self.degrade = degrade
        self._ncols = int(meta.get("ncols") or 0)
        self._device = plan.device
        self._pending: "collections.deque[_Request]" = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._batches: "queue.Queue" = queue.Queue(maxsize=max(
            1, int(prefetch_depth)))
        # instruments live on the cache's registry when one is attached
        # (one scrape covers the whole tier), else a private registry
        self.registry = registry if registry is not None else (
            cache.registry if cache is not None else obs.Registry())
        self._requests = self.registry.counter(
            "spc5_server_requests_total", "requests submitted")
        self._batches_total = self.registry.counter(
            "spc5_server_batches_total", "coalesced batches executed")
        self._coalesced = self.registry.counter(
            "spc5_server_coalesced_total",
            "requests that shared a multi-request batch")
        self._widest = self.registry.gauge(
            "spc5_server_widest_batch", "widest batch coalesced so far")
        self._batch_seconds = self.registry.histogram(
            "spc5_server_batch_seconds", "batch dispatch-to-ready time")
        self._request_seconds = self.registry.histogram(
            "spc5_server_request_seconds", "submit-to-result latency")
        self._shed = self.registry.counter(
            "spc5_server_shed_total",
            "requests shed by admission control (pending bound)")
        self._expired = self.registry.counter(
            "spc5_server_expired_total",
            "requests dropped because their deadline passed before "
            "dispatch")
        self._invalid = self.registry.counter(
            "spc5_server_invalid_total",
            "requests rejected by submit-time validation")
        self._degraded = self.registry.counter(
            "spc5_server_degraded_total",
            "batches served by the reference-oracle ladder rung")
        self._restarts = self.registry.counter(
            "spc5_server_worker_restarts_total",
            "supervised worker crash-restarts")
        self._plan_stats = (cache.stats_for(plan) if cache is not None
                            else PlanExecStats(plan))
        self._breaker = resilience.CircuitBreaker(
            threshold=breaker_threshold, reset_s=breaker_reset_s)
        # exec first: the gather handoff checks the exec worker's
        # liveness before blocking on a full prefetch queue
        self._exec_worker = resilience.SupervisedWorker(
            "spc5-exec", self._exec_once, restarts=self._restarts,
            max_restarts=max_restarts,
            on_give_up=self._on_worker_give_up).start()
        self._gather_worker = resilience.SupervisedWorker(
            "spc5-gather", self._gather_once, restarts=self._restarts,
            max_restarts=max_restarts,
            on_give_up=self._on_worker_give_up).start()

    def _faults_now(self):
        """The process-global fault registry, resolved per call so a test
        arming ``set_faults`` after construction still injects here."""
        return obs.faults.get_faults()

    # -- client API ----------------------------------------------------------

    def _validate(self, x) -> torch.Tensor:
        """Admission validation: shape, dtype, finiteness. ``x`` is a
        tensor or array; a 1-D floating one of length ncols is admitted as
        a contiguous float32 tensor on the plan's device (the port's
        kernels take float32 x only, so any other floating dtype is cast
        here, and a value that overflows float32 counts as non-finite). A
        poisoned vector fails HERE, alone, with :class:`ValueError`."""
        xv = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        ok = (xv.dim() == 1
              and (self._ncols == 0 or int(xv.shape[0]) == self._ncols)
              and xv.is_floating_point())
        if ok:
            xv = xv.to(device=self._device,
                       dtype=torch.float32).contiguous()
            if not bool(torch.isfinite(xv).all()):
                ok = False
                why = "contains non-finite values (NaN/Inf)"
        else:
            why = (f"must be a 1-D floating vector of length "
                   f"{self._ncols or 'ncols'}, got shape "
                   f"{tuple(xv.shape)} dtype {xv.dtype}")
        if not ok:
            self._invalid.inc()
            raise ValueError(f"invalid request vector: {why}")
        return xv

    def submit(self, x, *,
               deadline_s: Optional[float] = None
               ) -> "concurrent.futures.Future":
        """Enqueue y = A @ x; the future resolves to y (float32, original
        row order, on the plan's device, finished on the card).

        The admission-control gate, in order: :class:`CircuitOpenError`
        when the breaker is open, :class:`ValueError` for an invalid
        vector, ``RuntimeError`` after :meth:`close`, :class:`ShedError`
        once ``max_pending`` requests are queued. ``deadline_s`` (relative,
        seconds; default the server's ``deadline_s``) stamps the request
        with an absolute expiry the coalescing pipeline honours. The
        ``serve.submit`` span covers the validation too (its finiteness
        check waits for the card), so that span holds the submit's cost.
        """
        if not self._breaker.allow():
            raise resilience.CircuitOpenError(
                "circuit open: the serving tier is failing; submit "
                "rejected fast instead of queueing into a wedged tier")
        with self.registry.span("serve.submit") as sp:
            xv = self._validate(x)
            dl = self.deadline_s if deadline_s is None else float(deadline_s)
            now = obs.monotonic()
            req = _Request(xv, concurrent.futures.Future(), now,
                           now + dl if dl > 0 else None, sp.span_id)
            # closed-check and append under ONE lock: submit can never
            # slip a request into a server that is concurrently closing
            with self._cv:
                if self._closed:
                    raise RuntimeError("server is closed")
                if self.max_pending and \
                        len(self._pending) >= self.max_pending:
                    self._shed.inc()
                    raise resilience.ShedError(
                        f"pending queue at its admission bound "
                        f"({self.max_pending}); request shed")
                self._pending.append(req)
                self._cv.notify_all()
        return req.future

    def spmv(self, x, timeout: Optional[float] = None) -> torch.Tensor:
        """Synchronous y = A @ x through the coalescing path."""
        return self.submit(x).result(timeout=timeout)

    def close(self, timeout: float = 5.0) -> None:
        """Stop admitting, drain what is queued, join both workers, and
        resolve EVERY outstanding future: whatever the drain did not
        serve is cancelled, never silently abandoned. Raises
        ``RuntimeError`` if a worker is still running after its
        ``timeout`` join."""
        with self._cv:
            if self._closed:
                return
            self._closed = True
            self._cv.notify_all()
        stuck = [w.name for w in (self._gather_worker, self._exec_worker)
                 if not w.join(timeout)]
        with self._cv:
            leftovers = list(self._pending)
            self._pending.clear()
        while True:
            try:
                leftovers.extend(self._batches.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            # cancel() alone leaves the future CANCELLED but un-notified:
            # the notify step completes the transition for waiters
            if r.future.cancel():
                r.future.set_running_or_notify_cancel()
        if stuck:
            raise RuntimeError(
                f"SPC5Server.close: worker(s) {stuck} still running "
                f"after a {timeout}s join; outstanding futures were "
                f"cancelled")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- registry views ------------------------------------------------------

    @property
    def requests(self) -> int:
        return self._requests.value

    @property
    def batches(self) -> int:
        return self._batches_total.value

    @property
    def widest_batch(self) -> int:
        return int(self._widest.value)

    def stats(self) -> Dict[str, object]:
        """Every number here is a view over ``self.registry`` -- the same
        instruments a Prometheus export or ``obs.snapshot`` reads."""
        out: Dict[str, object] = {
            "requests": self.requests, "batches": self.batches,
            "mean_batch": (self.requests / self.batches
                           if self.batches else 0.0),
            "widest_batch": self.widest_batch,
            "coalesced": self._coalesced.value,
            "shed": self._shed.value,
            "expired": self._expired.value,
            "invalid": self._invalid.value,
            "degraded": self._degraded.value,
            "worker_restarts": self._restarts.value,
            "breaker": self._breaker.state,
            "max_pending": self.max_pending,
            "max_batch": self.max_batch,
            "window_us": self.window_s * 1e6,
            "p50_us": self._request_seconds.percentile(50) * 1e6,
            "p99_us": self._request_seconds.percentile(99) * 1e6,
            "plan": self._plan_stats.as_dict(),
        }
        if self.cache is not None:
            out["cache"] = self.cache.stats()
        return out

    # -- supervised worker iterations ----------------------------------------

    @staticmethod
    def _fail_reqs(reqs: Sequence[_Request], exc: BaseException) -> None:
        for r in reqs:
            if not r.future.done():
                r.future.set_exception(exc)

    def _drop_expired(self, reqs: List[_Request]) -> List[_Request]:
        """Fail requests whose deadline passed; keep the live ones. Runs
        at gather (post-window) and again right before dispatch."""
        now = obs.monotonic()
        keep: List[_Request] = []
        for r in reqs:
            if r.deadline is not None and now > r.deadline:
                self._expired.inc()
                if not r.future.done():
                    r.future.set_exception(resilience.DeadlineExceededError(
                        f"deadline exceeded {(now - r.deadline) * 1e3:.2f}"
                        f"ms before dispatch"))
            else:
                keep.append(r)
        return keep

    def _fail_batches(self, exc: BaseException) -> None:
        """Fail every batch waiting on the handoff queue."""
        while True:
            try:
                self._fail_reqs(self._batches.get_nowait(), exc)
            except queue.Empty:
                break

    def _on_worker_give_up(self, exc: BaseException) -> None:
        """A worker exhausted its consecutive-crash budget: the tier is
        wedged. Latch the breaker open (submit fails fast from now on)
        and fail everything already queued."""
        self._breaker.force_open()
        with self._cv:
            orphans = list(self._pending)
            self._pending.clear()
        err = resilience.CircuitOpenError(
            f"serving tier wedged: a worker gave up after repeated "
            f"crashes ({type(exc).__name__}: {exc})")
        self._fail_reqs(orphans, err)
        self._fail_batches(err)

    def _handoff(self, reqs: List[_Request]) -> None:
        """Put a batch on the prefetch queue without deadlocking against,
        or stranding a batch behind, a dead executor.

        The executor sets ``done`` before its give-up drains the queue.
        A put that lands after that drain would sit on a queue nobody
        reads (the reference's race: liveness check, give-up and drain,
        then the put), so the liveness check is repeated AFTER the put:
        if the executor is gone by then, this thread fails what is queued
        itself. A put before the drain is failed by the drain."""
        while True:
            if self._exec_worker.done:
                self._fail_reqs(reqs, resilience.CircuitOpenError(
                    "executor worker is gone; batch dropped"))
                return
            try:
                self._batches.put(reqs, timeout=0.05)
            except queue.Full:
                continue
            if self._exec_worker.done:
                self._fail_batches(resilience.CircuitOpenError(
                    "executor worker gave up while the batch was handed "
                    "off; batch dropped"))
            return

    def _gather_once(self):
        """One gather iteration: coalesce a microbatch and hand it off.
        The ``serve.gather`` fault fires FIRST -- before any request is
        popped -- so an injected gather crash loses nothing."""
        self._faults_now().maybe_fail("serve.gather")
        with self._cv:
            if not self._pending:
                if self._closed:
                    return resilience.DONE
                self._cv.wait(timeout=0.05)
                if not self._pending:
                    return None     # short iterations: crisp supervision
            reqs = [self._pending.popleft()]
            deadline = obs.monotonic() + self.window_s
            while len(reqs) < self.max_batch:
                if self._pending:
                    reqs.append(self._pending.popleft())
                    continue
                remaining = deadline - obs.monotonic()
                if remaining <= 0 or self._closed:
                    break
                self._cv.wait(timeout=remaining)
        reqs = self._drop_expired(reqs)
        if reqs:
            self._handoff(reqs)
        return None

    def _ready(self) -> None:
        """Wait until the card has finished what this thread launched (its
        current stream); nothing to wait for on the CPU."""
        if self._device.type == "cuda":
            torch.cuda.current_stream(self._device).synchronize()

    def _stack(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        """The (ncols, width) operand of a coalesced batch: the request
        vectors as columns, zero columns up to its power-of-two width."""
        width = _pow2_width(len(xs), self.max_batch)
        X = torch.stack(list(xs), dim=1)
        if width > len(xs):
            X = torch.nn.functional.pad(X, (0, width - len(xs)))
        return X

    @staticmethod
    def _split(Y: torch.Tensor, n: int) -> List[torch.Tensor]:
        """The first ``n`` columns of a coalesced result, one a request."""
        return [Y[:, j] for j in range(n)]

    def _run_batch(self, reqs: List[_Request],
                   oracle: bool = False) -> List[torch.Tensor]:
        """Dispatch one coalesced batch and wait for the card;
        ``oracle=True`` is the ladder's last rung -- the plain PyTorch
        version on the plan's device."""
        kw = dict(use_pallas=False, double_buffer=False) if oracle else {}
        if len(reqs) == 1:
            ys = [P.execute_spmv(self.plan, reqs[0].x, **kw)]
        else:
            Y = P.execute_spmm(self.plan, self._stack([r.x for r in reqs]),
                               **kw)
            ys = self._split(Y, len(reqs))
        self._ready()
        return ys

    def _degradable(self, exc: BaseException) -> bool:
        """Whether a failed dispatch may retry on the oracle rung. On the
        CPU, any failure, as in the reference. On the card, only an
        injected fault: a kernel that does not build or launch, or a
        wrapper's refusal, fails its callers and feeds the breaker, so
        that no batch is served by the plain version unnoticed (ROADMAP
        §3, deliberate differences)."""
        return (self.degrade and (self._device.type != "cuda"
                                  or isinstance(exc, obs.faults.FaultError)))

    def _exec_once(self):
        """One executor iteration: take a batch, dispatch it, resolve its
        futures. The ``serve.exec`` fault fires BEFORE the queue take,
        so an injected executor crash loses no batch. A failed dispatch
        retries once on the plain oracle under ``faults.suppress()`` where
        :meth:`_degradable` allows; a batch that does not (or whose rung
        fails too) fails its callers, and THAT feeds the circuit
        breaker."""
        self._faults_now().maybe_fail("serve.exec")
        try:
            reqs = self._batches.get(timeout=0.05)
        except queue.Empty:
            gather = getattr(self, "_gather_worker", None)
            if self._closed and gather is not None and gather.done \
                    and self._batches.empty():
                return resilience.DONE
            return None
        reqs = self._drop_expired(reqs)
        if not reqs:
            return None
        try:
            # the batch span parents on the FIRST request's submit span:
            # submit -> coalesce window -> dispatch is one trace
            with self.registry.span("serve.batch", parent=reqs[0].ctx,
                                    n=len(reqs)) as sp:
                try:
                    ys = self._run_batch(reqs)
                except Exception as e:
                    if not self._degradable(e):
                        raise
                    with self._faults_now().suppress():
                        ys = self._run_batch(reqs, oracle=True)
                    self._degraded.inc()
            self._batches_total.inc()
            self._requests.inc(len(reqs))
            self._widest.set_max(len(reqs))
            if len(reqs) > 1:
                self._coalesced.inc(len(reqs))
            self._batch_seconds.observe(sp.duration_s)
            self._plan_stats.record(len(reqs), sp.duration_s)
            done = obs.monotonic()
            for r, y in zip(reqs, ys):
                self._request_seconds.observe(done - r.t_submit)
                if not r.future.done():
                    r.future.set_result(y)
            self._breaker.record_success()
        except Exception as e:      # noqa: BLE001 -- fail the callers
            self._breaker.record_failure()
            self._fail_reqs(reqs, e)
        return None


# ----------------------------------------------------------------------------
# Open-loop traffic harness
# ----------------------------------------------------------------------------

def open_loop(server: SPC5Server, xs: Sequence, qps: float,
              duration_s: float = 0.5, seed: int = 0,
              warmup: int = 2) -> Dict[str, float]:
    """Drive ``server`` open-loop: Poisson arrivals at ``qps`` for
    ``duration_s``, submissions never waiting on completions (the
    reference's harness).

    Arrival times are drawn up front; each request's latency is
    submit-to-future-resolution, measured by a done callback. Latencies
    land in a fresh ``repro_torch.obs`` histogram and p50/p99 come from
    bucket interpolation. Only SUCCESSFUL requests enter the latency
    histogram and the achieved-QPS numerator; shed, expired, failed,
    cancelled and timed-out requests are counted in ``shed`` /
    ``expired`` / ``errors``.
    """
    import time as _time    # sleep only; timestamps come from obs
    rng = np.random.default_rng(seed)
    for i in range(warmup):
        try:
            server.spmv(xs[i % len(xs)])
        except Exception:   # noqa: BLE001 -- warmup under chaos may fail
            pass
    arrivals, t = [], 0.0
    while True:
        t += rng.exponential(1.0 / qps)
        if t >= duration_s:
            break
        arrivals.append(t)
    if not arrivals:
        arrivals = [0.0]
    hist = obs.Histogram("open_loop_latency_seconds")
    counts = collections.Counter()
    counts_lock = threading.Lock()

    def _record(t_submit, fut):
        # classify BEFORE observing: a failed request has no honest
        # latency, only an error count
        if fut.cancelled():
            kind = "cancelled"
        else:
            exc = fut.exception()
            if exc is None:
                hist.observe(obs.monotonic() - t_submit)
                return
            kind = ("expired"
                    if isinstance(exc, resilience.DeadlineExceededError)
                    else "failed")
        with counts_lock:
            counts[kind] += 1

    t0 = obs.monotonic()
    futures, submitted = [], 0
    for t in arrivals:
        delay = t0 + t - obs.monotonic()
        if delay > 0:
            _time.sleep(delay)
        ts = obs.monotonic()
        submitted += 1
        try:
            fut = server.submit(xs[submitted % len(xs)])
        except resilience.ShedError:
            with counts_lock:
                counts["shed"] += 1
            continue
        except Exception:   # noqa: BLE001 -- breaker open, closed, ...
            with counts_lock:
                counts["rejected"] += 1
            continue
        fut.add_done_callback(lambda f, ts=ts: _record(ts, f))
        futures.append(fut)
    # bounded wait: an unresolved future is a timeout error, not a hang
    not_done = concurrent.futures.wait(
        futures, timeout=max(5.0, 4.0 * duration_s)).not_done
    with counts_lock:
        counts["timed_out"] += len(not_done)
    elapsed = obs.monotonic() - t0
    completed = hist.count      # one snapshot: a straggler resolving
    # after the bounded wait stays a timeout, not a late success
    errors = (counts["failed"] + counts["cancelled"] + counts["rejected"]
              + counts["timed_out"])
    return {
        "qps_offered": qps,
        "qps_achieved": completed / elapsed,
        "submitted": submitted,
        "completed": completed,
        "shed": counts["shed"],
        "expired": counts["expired"],
        "errors": errors,
        "elapsed_s": elapsed,
        "p50_us": hist.percentile(50) * 1e6,
        "p99_us": hist.percentile(99) * 1e6,
    }


def saturation_sweep(server: SPC5Server, xs: Sequence, *,
                     qps0: float = 50.0, factor: float = 2.0,
                     max_points: int = 5, duration_s: float = 0.5,
                     seed: int = 0) -> List[Dict[str, float]]:
    """Sweep offered QPS multiplicatively until the tier stops keeping up
    (achieved < 85% of offered) or ``max_points`` is reached; the last
    point's achieved QPS is the saturation throughput."""
    points, qps = [], qps0
    for _ in range(max_points):
        res = open_loop(server, xs, qps, duration_s=duration_s, seed=seed)
        points.append(res)
        if res["qps_achieved"] < 0.85 * res["qps_offered"]:
            break
        qps *= factor
    return points


# ----------------------------------------------------------------------------
# start(config): the programmatic entry point the CLI shares
# ----------------------------------------------------------------------------

def smoke_shape(arch: str) -> Tuple[int, int]:
    """(vocab, d_model) of ``arch``'s smoke configuration
    (:func:`repro_torch.configs.get_smoke_config`)."""
    from repro_torch.configs import get_smoke_config
    cfg = get_smoke_config(arch)
    return cfg.vocab, cfg.d_model


def _default_matrix(config: ServeConfig) -> F.SPC5Matrix:
    """The config's pruned vocab-projection matrix (the CLI's serve
    subject) at the architecture's smoke shape, in beta(1,8)."""
    if config.vocab_spmv <= 0:
        raise ValueError("start(config) needs a matrix: pass mat= or set "
                         "vocab_spmv > 0")
    from repro_torch.core import matgen
    vocab, d_model = smoke_shape(config.arch)
    csr = matgen.pruned_weight(vocab, d_model, config.vocab_spmv, (1, 8),
                               seed=0)
    return F.csr_to_spc5(csr, 1, 8)


def start(config: ServeConfig, mat: Optional[F.SPC5Matrix] = None, *,
          cache: Optional[PlanCache] = None, install_records: bool = True,
          device: Optional[P.Device] = None) -> SPC5Server:
    """Build the serving tier a config describes and return the running
    server: record store installed (unless ``install_records=False``),
    plan built through the cache (admission verify when
    ``config.verify``), coalescing threads started.

    ``device`` is resolved as ``ops.resolve_device`` does: None is the
    card (and raises without one), ``"cpu"`` the host. A ``cache`` passed
    in keeps its own builder, and so its device.

    With ``config.metrics`` the tier's instruments and spans land on the
    port's GLOBAL obs registry; otherwise the tier gets a private
    registry. ``config.faults`` arms the port's process-global fault set
    (the ``SPC5_FAULTS`` grammar). The decode knobs (``mesh`` among
    them) are the CLI's decode loop's and change nothing here."""
    if config.faults:
        obs.faults.set_faults(obs.faults.Faults(config.faults))
    if install_records and config.records:
        from repro_torch.core import selector as S
        store = S.load_records(config.records)
        if config.verify:
            from repro_torch.analysis.verify import verify_records
            verify_records(store).raise_if_failed()
        S.set_default_store(store)
    if mat is None:
        mat = _default_matrix(config)
    registry = obs.get_registry() if config.metrics else None
    if cache is None:
        from repro_torch.kernels import ops
        cache = PlanCache(capacity_bytes=config.cache_mb << 20,
                          verify_on_admit=config.verify,
                          builder=functools.partial(
                              ops.prepare,
                              device=ops.resolve_device(device)),
                          registry=registry,
                          degrade=not config.no_degrade)
    plan = cache.get_or_build(mat, **plan_request(config))
    return SPC5Server(plan, cache=cache, window_us=config.window_us,
                      max_batch=config.max_batch,
                      prefetch_depth=config.prefetch_depth,
                      registry=registry,
                      max_pending=config.max_pending,
                      deadline_s=config.deadline_ms * 1e-3,
                      degrade=not config.no_degrade)
