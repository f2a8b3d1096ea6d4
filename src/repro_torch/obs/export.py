"""Exporters: JSON snapshot, Prometheus text format, Chrome trace_event.

Three views over one :class:`repro_torch.obs.Registry`:

  * :func:`snapshot` / :func:`load_snapshot` -- lossless JSON round trip
    of every instrument (histograms travel as sparse bucket counts);
  * :func:`to_prometheus` / :func:`parse_prometheus` -- the text
    exposition format (counters as ``_total``, histograms as cumulative
    ``_bucket{le=...}`` + ``_sum``/``_count``), what
    ``repro_torch.launch.serve --metrics`` writes to ``--metrics-path``;
  * :func:`to_chrome_trace` -- the span buffer as ``trace_event``
    complete events (``ph: "X"``, microsecond ``ts``/``dur``), openable
    in chrome://tracing or Perfetto, written to ``--trace-path``.

Stdlib only, like the rest of ``repro_torch.obs`` (a copy of
``repro.obs.export``: the same text and the same events).
"""
from __future__ import annotations

import json
import re
from typing import Dict, List

from repro_torch.obs import metrics as M

__all__ = ["snapshot", "load_snapshot", "to_prometheus",
           "parse_prometheus", "to_chrome_trace", "dump_json",
           "dump_prometheus", "dump_chrome_trace"]


# ----------------------------------------------------------------------------
# JSON snapshot
# ----------------------------------------------------------------------------

def snapshot(registry: M.Registry) -> dict:
    """Every instrument + derived percentiles + the span buffer, as one
    JSON-serialisable dict (the registry itself is untouched)."""
    out: dict = {"counters": {}, "gauges": {}, "histograms": {},
                 "spans": []}
    for name, inst in sorted(registry.instruments().items()):
        st = inst.state()
        if inst.kind == "histogram":
            st = dict(st, p50=inst.percentile(50), p99=inst.percentile(99),
                      mean=inst.mean)
        out[inst.kind + "s"][name] = st
    for ev in registry.spans():
        out["spans"].append({
            "name": ev.name, "t_start": ev.t_start,
            "duration_s": ev.duration_s, "span_id": ev.span_id,
            "parent_id": ev.parent_id, "thread_id": ev.thread_id,
            "attrs": ev.attrs})
    return out


def load_snapshot(snap: dict) -> M.Registry:
    """Rebuild a registry's instruments from :func:`snapshot` output
    (spans are not replayed -- they are a log, not state)."""
    reg = M.Registry()
    for name, st in snap.get("counters", {}).items():
        reg.counter(name).load_state(st)
    for name, st in snap.get("gauges", {}).items():
        reg.gauge(name).load_state(st)
    for name, st in snap.get("histograms", {}).items():
        reg.histogram(name).load_state(
            {k: v for k, v in st.items()
             if k in ("count", "sum", "min", "max", "buckets")})
    return reg


# ----------------------------------------------------------------------------
# Prometheus text exposition format
# ----------------------------------------------------------------------------

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _NAME_RE.sub("_", name)


def to_prometheus(registry: M.Registry) -> str:
    lines: List[str] = []
    for name, inst in sorted(registry.instruments().items()):
        pname = _prom_name(name)
        if inst.help:
            lines.append(f"# HELP {pname} {inst.help}")
        lines.append(f"# TYPE {pname} {inst.kind}")
        if inst.kind == "counter":
            lines.append(f"{pname} {inst.value}")
        elif inst.kind == "gauge":
            lines.append(f"{pname} {inst.value}")
        else:
            cum = 0
            st = inst.state()
            buckets = {int(i): n for i, n in st["buckets"].items()}
            for i in sorted(buckets):
                cum += buckets[i]
                le = ("+Inf" if i >= len(M.HISTOGRAM_BOUNDS)
                      else f"{M.HISTOGRAM_BOUNDS[i]:.6g}")
                lines.append(f'{pname}_bucket{{le="{le}"}} {cum}')
            if not buckets or max(buckets) < len(M.HISTOGRAM_BOUNDS):
                lines.append(f'{pname}_bucket{{le="+Inf"}} {cum}')
            lines.append(f"{pname}_sum {inst.sum:.9g}")
            lines.append(f"{pname}_count {inst.count}")
    return "\n".join(lines) + "\n"


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})?\s+([0-9.eE+-]+|\+Inf)$")


def parse_prometheus(text: str) -> Dict[str, float]:
    """Sample lines back to ``{name[labels]: value}`` (round-trip tests;
    a real scraper is out of scope)."""
    out: Dict[str, float] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if m:
            key = m.group(1) + (m.group(2) or "")
            out[key] = float(m.group(3))
    return out


# ----------------------------------------------------------------------------
# Chrome trace_event timeline
# ----------------------------------------------------------------------------

def to_chrome_trace(registry: M.Registry) -> dict:
    """The span buffer as trace_event "complete" events (``ph: "X"``,
    ``ts``/``dur`` in microseconds since the registry epoch); the dict
    serialises to a file chrome://tracing / Perfetto opens directly."""
    events = []
    for ev in registry.spans():
        args = dict(ev.attrs)
        args["span_id"] = ev.span_id
        if ev.parent_id is not None:
            args["parent_id"] = ev.parent_id
        events.append({
            "name": ev.name, "ph": "X", "pid": 1, "tid": ev.thread_id,
            "ts": round(ev.t_start * 1e6, 3),
            "dur": round(ev.duration_s * 1e6, 3),
            "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# ----------------------------------------------------------------------------
# File helpers
# ----------------------------------------------------------------------------

def dump_json(registry: M.Registry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(snapshot(registry), f, indent=1)


def dump_prometheus(registry: M.Registry, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_prometheus(registry))


def dump_chrome_trace(registry: M.Registry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(to_chrome_trace(registry), f)
