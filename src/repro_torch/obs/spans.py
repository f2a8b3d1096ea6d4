"""Execution spans: nested timed events with trace-context propagation.

A span is one timed region -- ``with registry.span("serve.batch", n=4):``
-- that records its wall-clock start/duration, attributes, and its parent
span, producing the tree the Chrome ``trace_event`` exporter renders as a
timeline. Two propagation mechanisms:

  * **thread-local nesting** -- spans opened on the same thread nest
    automatically (a per-thread stack of open span ids);
  * **explicit ``parent=``** -- for lifetimes that cross threads (a
    request submitted on the caller's thread, executed on the server's
    exec thread), the producer captures ``registry.current_context()``
    and the consumer opens its span with ``parent=that_id``. This is how
    ``SPC5Server.submit`` -> coalesce window -> SpMM dispatch stays one
    connected trace.

Finished spans land in the owning registry's bounded deque (oldest
dropped); nothing here blocks the instrumented path beyond a deque append
under a lock.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Dict, List, Optional

__all__ = ["SpanEvent", "SpanHandle", "Spanner", "monotonic"]

#: The one sanctioned clock for launch code: an alias of
#: ``time.perf_counter`` so deadlines and span timestamps share a
#: timebase, under a name a lint rule can tell from a raw call.
monotonic = time.perf_counter


@dataclasses.dataclass(frozen=True)
class SpanEvent:
    """One finished span: times are seconds relative to the registry
    epoch (monotonic clock, so only differences are meaningful)."""

    name: str
    t_start: float
    duration_s: float
    span_id: int
    parent_id: Optional[int]
    thread_id: int
    attrs: Dict[str, object]


class SpanHandle:
    """An open span: ``finish()`` (or context-manager exit) stamps the
    duration and records the event. ``duration_s`` is readable after
    finish -- ``plan.make_plan`` copies it into ``plan.trace``."""

    __slots__ = ("_spanner", "name", "span_id", "parent_id", "attrs",
                 "_t0", "duration_s", "_done")

    def __init__(self, spanner: "Spanner", name: str, span_id: int,
                 parent_id: Optional[int], attrs: Dict[str, object]):
        self._spanner = spanner
        self.name = name
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs
        self._t0 = monotonic()
        self.duration_s = 0.0
        self._done = False

    def finish(self, **attrs) -> "SpanHandle":
        if self._done:
            return self
        self._done = True
        self.duration_s = monotonic() - self._t0
        if attrs:
            self.attrs.update(attrs)
        self._spanner._finish(self)
        return self

    def __enter__(self) -> "SpanHandle":
        self._spanner._push(self)
        return self

    def __exit__(self, *exc) -> None:
        self._spanner._pop(self)
        self.finish()


class Spanner:
    """Per-registry span state: id allocation, per-thread open-span
    stacks, and the bounded finished-event buffer."""

    def __init__(self, registry, max_spans: int = 4096):
        self._registry = registry
        self.epoch = monotonic()
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._finished: "collections.deque[SpanEvent]" = \
            collections.deque(maxlen=max_spans)

    # -- per-thread context stack --------------------------------------------

    def _stack(self) -> List[int]:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def current_context(self) -> Optional[int]:
        st = self._stack()
        return st[-1] if st else None

    def _push(self, h: SpanHandle) -> None:
        self._stack().append(h.span_id)

    def _pop(self, h: SpanHandle) -> None:
        st = self._stack()
        if st and st[-1] == h.span_id:
            st.pop()

    # -- span lifecycle ------------------------------------------------------

    def span(self, name: str, parent: Optional[int] = None,
             **attrs) -> SpanHandle:
        return self.begin(name, parent=parent, **attrs)

    def begin(self, name: str, parent: Optional[int] = None,
              **attrs) -> SpanHandle:
        if not self._registry.enabled:
            return _NULL_HANDLE
        if parent is None:
            parent = self.current_context()
        return SpanHandle(self, name, next(self._ids), parent, attrs)

    def _finish(self, h: SpanHandle) -> None:
        ev = SpanEvent(name=h.name, t_start=h._t0 - self.epoch,
                       duration_s=h.duration_s, span_id=h.span_id,
                       parent_id=h.parent_id,
                       thread_id=threading.get_ident(), attrs=dict(h.attrs))
        with self._lock:
            self._finished.append(ev)

    def finished(self) -> List[SpanEvent]:
        with self._lock:
            return list(self._finished)


class _NullSpanHandle(SpanHandle):
    """Shared handle a disabled registry's spans resolve to: enter/exit
    and finish are no-ops, ``duration_s`` stays 0."""

    __slots__ = ()

    def __init__(self):
        self.name = "null"
        self.span_id = 0
        self.parent_id = None
        self.attrs = {}
        self._t0 = 0.0
        self.duration_s = 0.0
        self._done = True

    def finish(self, **attrs) -> "SpanHandle":
        return self

    def __enter__(self) -> "SpanHandle":
        return self

    def __exit__(self, *exc) -> None:
        pass


_NULL_HANDLE = _NullSpanHandle()
