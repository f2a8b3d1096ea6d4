"""Metrics instruments: Counter / Gauge / Histogram + the Registry.

A copy of ``repro.obs.metrics``. Dependency-free (stdlib only) by
design: the serving tier and the plan pipeline import this module, and none of
them may grow a third-party telemetry dependency. Three properties the
rest of the repo leans on:

  * **thread safety** -- every increment/observe takes the instrument's
    lock, so ``PlanCache`` hit/miss totals and ``SPC5Server`` request
    counts stay exact under the coalescing tier's gather/exec threads
    (pinned by tests/test_torch_obs.py's threaded storms);
  * **bucketed percentiles** -- :class:`Histogram` uses FIXED log-spaced
    latency buckets (1e-6s .. 1e2s at ratio 10^0.1), so p50/p99 come from
    cumulative-count interpolation in O(buckets), never from sorting an
    O(requests) sample list (``launch.server.open_loop`` used to);
  * **near-zero cost when disabled** -- a ``Registry(enabled=False)``
    hands out shared no-op singletons whose ``inc``/``observe``/``set``
    bodies are a bare ``pass``, so instrumented code paths pay one
    attribute lookup and an empty call when observability is off.
"""
from __future__ import annotations

import bisect
import math
import threading
from typing import Dict, List, Optional

__all__ = ["Counter", "Gauge", "Histogram", "Registry",
           "NULL_COUNTER", "NULL_GAUGE", "NULL_HISTOGRAM",
           "HISTOGRAM_BOUNDS", "BUCKET_RATIO"]


# ----------------------------------------------------------------------------
# Instruments
# ----------------------------------------------------------------------------

class Counter:
    """Monotonically increasing count; ``inc`` is thread-safe and exact."""

    kind = "counter"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def state(self) -> dict:
        return {"value": self._value}

    def load_state(self, state: dict) -> None:
        self._value = state["value"]


class Gauge:
    """A value that goes up and down (or tracks a running maximum)."""

    kind = "gauge"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._value += n

    def set_max(self, v: float) -> None:
        """Keep the running maximum (e.g. widest coalesced batch)."""
        with self._lock:
            if v > self._value:
                self._value = v

    @property
    def value(self) -> float:
        return self._value

    def state(self) -> dict:
        return {"value": self._value}

    def load_state(self, state: dict) -> None:
        self._value = state["value"]


#: Fixed log-spaced bucket upper bounds: 10^-6 .. 10^2 seconds at ratio
#: 10^0.1 (~26% per step). 81 finite bounds + one overflow bucket. Fixed
#: (not per-instrument) so every histogram in a snapshot is mergeable and
#: the percentile error is bounded by one known ratio.
BUCKET_RATIO = 10 ** 0.1
HISTOGRAM_BOUNDS: List[float] = [10.0 ** (e / 10.0) for e in range(-60, 21)]


class Histogram:
    """Log-bucketed distribution; percentiles by bucket interpolation.

    ``observe(x)`` is O(log buckets) (a bisect into the fixed bounds);
    ``percentile(q)`` walks the cumulative counts and interpolates
    linearly inside the landing bucket, clamped to the observed
    ``min``/``max`` so single-sample histograms report exactly that
    sample. The relative error of an interior percentile is bounded by
    one bucket ratio (:data:`BUCKET_RATIO`, ~1.26x) -- the tolerance
    tests/test_obs.py pins against numpy's sorted percentiles.
    """

    kind = "histogram"

    def __init__(self, name: str, help: str = ""):
        self.name = name
        self.help = help
        self._lock = threading.Lock()
        self._counts = [0] * (len(HISTOGRAM_BOUNDS) + 1)
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def observe(self, x: float) -> None:
        i = bisect.bisect_left(HISTOGRAM_BOUNDS, x)
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += x
            if x < self._min:
                self._min = x
            if x > self._max:
                self._max = x

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    @property
    def min(self) -> float:
        return self._min if self._count else 0.0

    @property
    def max(self) -> float:
        return self._max if self._count else 0.0

    def percentile(self, q: float) -> float:
        """The q-th percentile (0..100) by cumulative-bucket interpolation."""
        with self._lock:
            total = self._count
            if not total:
                return 0.0
            target = (q / 100.0) * total
            cum = 0.0
            for i, n in enumerate(self._counts):
                if not n:
                    continue
                if cum + n >= target:
                    lo = HISTOGRAM_BOUNDS[i - 1] if i > 0 else 0.0
                    hi = (HISTOGRAM_BOUNDS[i] if i < len(HISTOGRAM_BOUNDS)
                          else self._max)
                    frac = (target - cum) / n
                    val = lo + (hi - lo) * max(0.0, min(1.0, frac))
                    return max(self._min, min(self._max, val))
                cum += n
            return self._max

    def state(self) -> dict:
        with self._lock:
            # sparse encoding: only occupied buckets travel in snapshots
            return {"count": self._count, "sum": self._sum,
                    "min": self._min if self._count else None,
                    "max": self._max if self._count else None,
                    "buckets": {str(i): n for i, n in
                                enumerate(self._counts) if n}}

    def load_state(self, state: dict) -> None:
        with self._lock:
            self._count = state["count"]
            self._sum = state["sum"]
            self._min = (math.inf if state.get("min") is None
                         else state["min"])
            self._max = (-math.inf if state.get("max") is None
                         else state["max"])
            self._counts = [0] * (len(HISTOGRAM_BOUNDS) + 1)
            for i, n in state.get("buckets", {}).items():
                self._counts[int(i)] = n


# ----------------------------------------------------------------------------
# No-op instruments: the disabled path
# ----------------------------------------------------------------------------

class _NullCounter(Counter):
    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v: float) -> None:
        pass

    def inc(self, n: float = 1.0) -> None:
        pass

    def set_max(self, v: float) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, x: float) -> None:
        pass


#: Shared singletons a disabled Registry hands out -- one allocation for
#: the whole process, empty method bodies on the hot path.
NULL_COUNTER = _NullCounter("null")
NULL_GAUGE = _NullGauge("null")
NULL_HISTOGRAM = _NullHistogram("null")


# ----------------------------------------------------------------------------
# Registry
# ----------------------------------------------------------------------------

class Registry:
    """Named instruments + the finished-span buffer, one scope per tier.

    ``counter``/``gauge``/``histogram`` get-or-create by name (asking for
    an existing name with a different kind raises -- names are the
    contract exporters key on). ``enabled=False`` returns the shared
    no-op singletons and records no spans, so a tier can be built fully
    instrumented and switched off wholesale.

    Span recording lives here too (see :mod:`repro_torch.obs.spans`): finished
    spans land in a bounded deque (oldest dropped), timestamps are
    relative to the registry's monotonic ``epoch`` so the Chrome trace
    exporter can emit a consistent timeline.
    """

    def __init__(self, enabled: bool = True, max_spans: int = 4096):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._instruments: Dict[str, object] = {}
        # imported here to keep metrics.py importable standalone
        from repro_torch.obs import spans as _spans
        self._spanner = _spans.Spanner(self, max_spans=max_spans)

    # -- instruments ---------------------------------------------------------

    def _get(self, cls, null, name: str, help: str):
        if not self.enabled:
            return null
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, help)
                self._instruments[name] = inst
            elif not type(inst) is cls:  # noqa: E721 -- exact kind match
                raise ValueError(
                    f"instrument {name!r} already registered as "
                    f"{inst.kind}, requested {cls.kind}")
            return inst

    def counter(self, name: str, help: str = "") -> Counter:
        return self._get(Counter, NULL_COUNTER, name, help)

    def gauge(self, name: str, help: str = "") -> Gauge:
        return self._get(Gauge, NULL_GAUGE, name, help)

    def histogram(self, name: str, help: str = "") -> Histogram:
        return self._get(Histogram, NULL_HISTOGRAM, name, help)

    def instruments(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._instruments)

    # -- spans (delegated to the Spanner) ------------------------------------

    @property
    def epoch(self) -> float:
        return self._spanner.epoch

    def span(self, name: str, parent: Optional[int] = None, **attrs):
        """Context manager timing a nested event; see ``spans.Spanner``."""
        return self._spanner.span(name, parent=parent, **attrs)

    def begin_span(self, name: str, parent: Optional[int] = None, **attrs):
        """Manual begin/finish pair for cross-thread span lifetimes."""
        return self._spanner.begin(name, parent=parent, **attrs)

    def current_context(self) -> Optional[int]:
        """This thread's innermost open span id (for explicit ``parent=``
        propagation across thread boundaries)."""
        return self._spanner.current_context()

    def spans(self):
        return self._spanner.finished()
