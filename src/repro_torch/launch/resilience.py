"""Resilience primitives for the serving tier: ladder, breaker, supervisor.

A copy of ``repro.launch.resilience`` for the port (numpy- and torch-free;
time from :data:`repro_torch.obs.monotonic`). The SPC5 registry's lattice
of interchangeable lowerings (descriptor vs mask, quantised vs f32 values,
the CUDA kernels vs the plain PyTorch oracle) is more than a tuning
space -- it is a graceful-degradation ladder: when the
tuned path fails (a build error, a verify rejection, an injected kernel
fault), an equivalent-but-simpler rung can still serve the request.
This module holds the pieces ``repro_torch.launch.server`` composes:

  * :func:`ladder_requests` -- the build-side ladder: given a prepare
    request, yield the successively-simpler requests to retry with
    (tuned -> mask lowering -> f32 values -> reference). The final
    ``reference`` rung is built (and the exec-side ladder's oracle rung
    is run) under ``faults.suppress()``, so injection can never re-fail
    the rung the ladder is guaranteed to land on.
  * :class:`CircuitBreaker` -- consecutive-failure trip + timed
    half-open probe, so a wedged executor fails submits fast instead of
    letting callers block on futures that will never resolve.
  * :class:`SupervisedWorker` -- a worker thread whose loop body is an
    *iteration* function: a crash increments a restart counter, backs
    off exponentially (bounded), and re-enters; the crash streak resets
    on every clean iteration, so a worker under, say, 10% injected crash
    rate runs indefinitely while a hard-wedged one gives up after
    ``max_restarts`` consecutive failures and trips its ``on_give_up``
    callback (the server opens its breaker and cancels what is queued).

Admission-control outcomes are typed so callers and the open-loop bench
can tell shed/expired/broken apart from real compute errors:
:class:`ShedError` (queue bound hit), :class:`DeadlineExceededError`
(request expired before exec), :class:`CircuitOpenError` (tier wedged).
"""
from __future__ import annotations

import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

from repro_torch import obs
from repro_torch.obs.faults import FaultError  # noqa: F401  -- re-exported

__all__ = ["ShedError", "DeadlineExceededError", "CircuitOpenError",
           "FaultError", "ladder_requests", "CircuitBreaker",
           "SupervisedWorker", "DONE"]


class ShedError(RuntimeError):
    """Admission control rejected the request: the pending queue is at
    its bound and the tier sheds instead of queueing unboundedly."""


class DeadlineExceededError(TimeoutError):
    """The request's deadline expired before it reached the executor (it
    was dropped from its coalesced batch, not computed-then-discarded)."""


class CircuitOpenError(RuntimeError):
    """The tier's circuit breaker is open (a worker gave up or the
    executor keeps failing); submits fail fast instead of hanging."""


# ----------------------------------------------------------------------------
# The degradation ladder (build side)
# ----------------------------------------------------------------------------

#: Rung order: the name of each demotion step and the request overrides it
#: applies on top of the previous rung. ``reference`` additionally builds
#: under ``faults.suppress()`` and drops tuning/reordering -- the minimal
#: trusted path.
_RUNGS: Tuple[Tuple[str, Dict[str, object]], ...] = (
    ("mask-lowering", {"lowering": "mask"}),
    ("f32-values", {"lowering": "mask", "vdtype": "f32"}),
    ("reference", {"lowering": "mask", "vdtype": "f32", "reorder": None,
                   "tune": False}),
)


def ladder_requests(request: Dict[str, object]) \
        -> Iterator[Tuple[str, Dict[str, object], bool]]:
    """Yield ``(rung, request, suppress_faults)`` down the ladder.

    Rungs that would rebuild the exact same request as the previous
    attempt are skipped (a request already at ``lowering="mask"`` starts
    demoting at the value dtype), so every yielded rung is a real
    demotion. The ``vdtype`` overrides drop a conflicting legacy
    ``dtype=`` passthrough -- the ladder owns the cast on those rungs.
    """
    prev = dict(request)
    for rung, overrides in _RUNGS:
        req = dict(request)
        req.pop("dtype", None)          # vdtype="f32" owns the cast
        req.update(overrides)
        if rung == "reference":
            # drop explicit layout/geometry too: the reference rung must
            # not re-fail on an oversized tuned configuration
            for k in ("layout", "pr", "xw", "cb", "config"):
                req.pop(k, None)
        if req == prev:
            continue
        prev = dict(req)
        yield rung, req, rung == "reference"


# ----------------------------------------------------------------------------
# Circuit breaker
# ----------------------------------------------------------------------------

class CircuitBreaker:
    """Consecutive-failure circuit with a timed half-open probe.

    ``allow()`` is True while closed; after ``threshold`` consecutive
    ``record_failure`` calls the circuit opens and ``allow()`` is False
    until ``reset_s`` has elapsed, when ONE caller is let through as a
    probe (half-open). A probe success closes the circuit; a failure
    re-opens it for another ``reset_s``. ``force_open()`` latches the
    circuit permanently (a worker that exhausted its restart budget is
    not coming back). Thread-safe; time comes from ``obs.monotonic``
    like every other deadline in the serving tier."""

    def __init__(self, threshold: int = 3, reset_s: float = 1.0):
        self.threshold = max(1, int(threshold))
        self.reset_s = float(reset_s)
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: Optional[float] = None
        self._latched = False
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            if self._latched:
                return "open"
            if obs.monotonic() - self._opened_at >= self.reset_s:
                return "half-open"
            return "open"

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if self._latched:
                return False
            if obs.monotonic() - self._opened_at >= self.reset_s \
                    and not self._probing:
                self._probing = True    # one half-open probe at a time
                return True
            return False

    def record_success(self) -> None:
        with self._lock:
            if self._latched:
                return
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> None:
        with self._lock:
            if self._latched:
                return
            self._failures += 1
            self._probing = False
            if self._failures >= self.threshold:
                self._opened_at = obs.monotonic()

    def force_open(self) -> None:
        """Latch the circuit open permanently (no half-open probes)."""
        with self._lock:
            self._latched = True
            if self._opened_at is None:
                self._opened_at = obs.monotonic()


# ----------------------------------------------------------------------------
# Supervised worker threads
# ----------------------------------------------------------------------------

#: Sentinel an iteration function returns to finish the worker cleanly.
DONE = object()


class SupervisedWorker:
    """A daemon thread running ``iteration()`` until it returns DONE.

    A raising iteration is a crash: the restart counter increments, the
    worker sleeps ``backoff_s * 2**(streak-1)`` (capped at
    ``max_backoff_s``) and re-enters the iteration. The crash streak
    resets on any iteration that returns normally; ``max_restarts``
    CONSECUTIVE crashes exhaust the budget -- the worker marks itself
    done and calls ``on_give_up(exc)`` exactly once, which is the
    server's cue to open its circuit breaker and cancel queued work.
    """

    def __init__(self, name: str, iteration: Callable[[], object], *,
                 restarts: Optional[obs.Counter] = None,
                 max_restarts: int = 5, backoff_s: float = 0.01,
                 max_backoff_s: float = 0.5,
                 on_give_up: Optional[Callable[[BaseException], None]] = None):
        self.name = name
        self._iteration = iteration
        self._restarts = restarts
        self.max_restarts = int(max_restarts)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self._on_give_up = on_give_up
        self.crashes = 0                # lifetime total, for stats
        self.gave_up = False
        self.done = False
        self.last_error: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)

    def start(self) -> "SupervisedWorker":
        self._thread.start()
        return self

    def _run(self) -> None:
        import time
        streak = 0
        while True:
            try:
                if self._iteration() is DONE:
                    break
                streak = 0
            except BaseException as e:  # noqa: BLE001 -- supervision point
                self.crashes += 1
                self.last_error = e
                streak += 1
                if self._restarts is not None:
                    self._restarts.inc()
                if streak > self.max_restarts:
                    self.gave_up = True
                    self.done = True
                    if self._on_give_up is not None:
                        self._on_give_up(e)
                    return
                time.sleep(min(self.backoff_s * (2 ** (streak - 1)),
                               self.max_backoff_s))
        self.done = True

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Join the thread; True when it actually finished."""
        self._thread.join(timeout)
        return not self._thread.is_alive()
