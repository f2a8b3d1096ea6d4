"""repro_torch.obs: the port's observability layer (metrics, spans,
exporters, fault injection), a copy of ``repro.obs``.

One dependency-free subsystem behind every telemetry touchpoint of the
port -- ``PlanCache``/``SPC5Server`` counters, ``make_plan`` per-pass
wall-times, ``open_loop`` latency percentiles -- so "what happened and how
long did it take" has one answer. It is stdlib only and imports nothing of
the JAX package: the port has its own global registry and its own global
fault set, so arming one package arms nothing in the other.

  * :class:`Registry` scopes a set of named :class:`Counter` /
    :class:`Gauge` / :class:`Histogram` instruments plus a bounded span
    buffer; ``Registry(enabled=False)`` hands out shared no-op
    instruments (the near-zero-cost disabled path).
  * :func:`get_registry` / :func:`set_registry` manage the process-global
    registry -- what ``repro_torch.launch.serve --metrics`` exports. Tiers
    that need isolation (every test-constructed ``PlanCache``) build
    private registries instead.
  * :func:`span` opens a span on the global registry;
    ``registry.span(...)`` on a specific one. Cross-thread propagation
    goes through ``registry.current_context()`` + ``parent=``.
  * :data:`monotonic` is the sanctioned wall-clock
    (``time.perf_counter`` under an auditable name): launch/ code takes
    deadlines and timestamps from here. It is host time: work queued on
    the card is inside a span only where the span's code synchronises.
  * :mod:`repro_torch.obs.export` renders a registry as a JSON snapshot,
    Prometheus text, or a Chrome ``trace_event`` timeline.
  * :mod:`repro_torch.obs.faults` is the deterministic fault-injection
    registry (``SPC5_FAULTS=point:rate:seed``) the resilience layer and
    the chaos suite arm; off by default via the same shared-no-op
    pattern as a disabled Registry.
"""
from __future__ import annotations

from repro_torch.obs import export, faults
from repro_torch.obs.metrics import (BUCKET_RATIO, HISTOGRAM_BOUNDS, Counter,
                               Gauge, Histogram, Registry)
from repro_torch.obs.spans import SpanEvent, SpanHandle, monotonic

__all__ = ["Counter", "Gauge", "Histogram", "Registry", "SpanEvent",
           "SpanHandle", "BUCKET_RATIO", "HISTOGRAM_BOUNDS", "export",
           "faults", "monotonic", "get_registry", "set_registry", "span",
           "snapshot"]

_global_registry = Registry()


def get_registry() -> Registry:
    """The process-global registry (what the serve CLI exports)."""
    return _global_registry


def set_registry(registry: Registry) -> Registry:
    """Swap the process-global registry; returns the previous one."""
    global _global_registry
    prev = _global_registry
    _global_registry = registry
    return prev


def span(name: str, parent=None, **attrs) -> SpanHandle:
    """Open a span on the global registry (the common case for code that
    is not handed an explicit registry, e.g. the plan pipeline)."""
    return _global_registry.span(name, parent=parent, **attrs)


def snapshot() -> dict:
    """JSON snapshot of the global registry."""
    return export.snapshot(_global_registry)
