"""Deterministic, seed-driven fault injection for the serving tier.

The SPC5 lattice gives the serving tier a graceful-degradation ladder
(tuned kernel -> mask lowering -> f32 values -> the plain PyTorch
oracle);
this module is how we PROVE the ladder, the admission control, and the
worker supervision actually hold: named fault points wired into plan
build, cache admission, kernel dispatch, and both server threads fire
deterministically at a configured rate, so the chaos tests and the
card's smoke replay the exact same failure sequences run over run. A copy
of ``repro.obs.faults``: the same points, spec grammar and draws; the
port's global fault set is its own.

  * :data:`CATALOGUE` -- the closed set of fault-point names. A
    ``faults.check(...)``/``maybe_fail(...)`` call site may only name a
    catalogued point, so the chaos tests cover every wired point.
  * :class:`Faults` -- parses ``point:rate[:seed]`` comma-separated
    specs (the ``SPC5_FAULTS`` environment variable / ``--faults`` serve
    knob). Each point draws from its own seeded PRNG, so one point's
    firing sequence never shifts another's and a pinned seed replays
    bit-identically. Per-point check/fire counts surface in
    :meth:`Faults.stats`.
  * **off by default at zero cost** -- the global default is the shared
    :data:`NULL_FAULTS` whose ``check`` body is ``return False``
    (mirroring ``Registry(enabled=False)``'s no-op instruments); an
    instrumented hot path pays one attribute lookup and a constant
    return when injection is off.
  * :meth:`Faults.suppress` -- a thread-local escape hatch for the
    ladder's last-resort rung: the reference-oracle retry runs with
    injection suppressed on the executing thread, so the rung the
    ladder can always land on is also the rung injection cannot touch.
"""
from __future__ import annotations

import difflib
import os
import random
import threading
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = ["CATALOGUE", "FaultError", "Faults", "NULL_FAULTS",
           "get_faults", "set_faults", "faults_from_env"]

#: Every fault point the repo wires, name -> where it fires. The names are
#: the contract: specs may only configure these, call sites may only check
#: these, and the chaos tests iterate this dict, so adding a point here is
#: what makes it testable.
CATALOGUE: Dict[str, str] = {
    "plan.build": "plan pipeline: the layout build pass fails before any "
                  "device array is produced (repro_torch.core.plan.make_plan)",
    "cache.admit": "plan cache: admission fails after a successful build "
                   "(as a verify failure would; PlanCache.get_or_build)",
    "exec.spmv": "kernel dispatch: execute_spmv raises before lowering",
    "exec.spmm": "kernel dispatch: execute_spmm raises before lowering",
    "serve.gather": "serving tier: the gather/coalescing thread crashes "
                    "at the top of its loop (no request is lost)",
    "serve.exec": "serving tier: the executor thread crashes before "
                  "taking a batch off the handoff queue",
}


class FaultError(RuntimeError):
    """An injected fault. Carries the point name so handlers and traces
    can say WHICH wired failure fired."""

    def __init__(self, point: str):
        super().__init__(f"injected fault at {point!r}")
        self.point = point


def _did_you_mean(name: str, candidates: Iterable[str]) -> str:
    close = difflib.get_close_matches(str(name), list(candidates), n=1,
                                      cutoff=0.6)
    return f" -- did you mean {close[0]!r}?" if close else ""


class _Point:
    """One configured fault point: seeded PRNG + check/fire counts.

    Draws are sequential under the point's lock, so a single-threaded
    check sequence replays exactly for a pinned seed; under threads the
    SET of draws is identical and only their assignment to call sites
    follows the interleaving.
    """

    __slots__ = ("name", "rate", "seed", "_rng", "_lock", "checks", "fired")

    def __init__(self, name: str, rate: float, seed: int):
        self.name = name
        self.rate = rate
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.checks = 0
        self.fired = 0

    def draw(self) -> bool:
        with self._lock:
            self.checks += 1
            hit = self._rng.random() < self.rate
            if hit:
                self.fired += 1
            return hit


class Faults:
    """A set of configured fault points (usually parsed from a spec).

    ``Faults("serve.exec:0.1:7,plan.build:0.05")`` arms ``serve.exec`` at
    a 10% rate with seed 7 and ``plan.build`` at 5% with the default seed
    0. ``check(point)`` draws (False for unarmed points); ``maybe_fail``
    raises :class:`FaultError` on a hit. Unknown point names raise at
    parse time -- a typo can never silently disarm a chaos run.
    """

    enabled = True

    def __init__(self, spec: str = ""):
        self._points: Dict[str, _Point] = {}
        self._suppressed = threading.local()
        for name, rate, seed in self.parse_spec(spec):
            self._points[name] = _Point(name, rate, seed)

    @staticmethod
    def parse_spec(spec: str) -> List[Tuple[str, float, int]]:
        """``point:rate[:seed]`` comma-separated -> [(name, rate, seed)]."""
        out: List[Tuple[str, float, int]] = []
        for part in filter(None, (p.strip() for p in spec.split(","))):
            bits = part.split(":")
            if len(bits) not in (2, 3):
                raise ValueError(
                    f"bad fault spec {part!r}; expected point:rate[:seed]")
            name = bits[0]
            if name not in CATALOGUE:
                raise ValueError(
                    f"unknown fault point {name!r}; expected one of "
                    f"{sorted(CATALOGUE)}{_did_you_mean(name, CATALOGUE)}")
            rate = float(bits[1])
            if not 0.0 <= rate <= 1.0:
                raise ValueError(f"fault rate must be in [0, 1], "
                                 f"got {rate} for {name!r}")
            seed = int(bits[2]) if len(bits) == 3 else 0
            out.append((name, rate, seed))
        return out

    # -- the hot path --------------------------------------------------------

    def check(self, point: str) -> bool:
        """True when the (armed) point fires this draw."""
        p = self._points.get(point)
        if p is None or getattr(self._suppressed, "on", False):
            return False
        return p.draw()

    def maybe_fail(self, point: str) -> None:
        """Raise :class:`FaultError` when the point fires."""
        if self.check(point):
            raise FaultError(point)

    # -- suppression (the ladder's last-resort rung) -------------------------

    def suppress(self):
        """Thread-local no-injection scope: ``with faults.suppress():``
        disables every point for the calling thread only, so the
        degradation ladder's reference-oracle rung cannot be re-failed
        by the very injection it is recovering from (other threads'
        chaos continues undisturbed)."""
        return _Suppress(self._suppressed)

    # -- introspection -------------------------------------------------------

    @property
    def points(self) -> Tuple[str, ...]:
        return tuple(sorted(self._points))

    def __bool__(self) -> bool:
        return bool(self._points)

    def stats(self) -> Dict[str, Dict[str, float]]:
        """Per-point draw accounting: configured rate/seed, checks, fires."""
        return {name: {"rate": p.rate, "seed": p.seed, "checks": p.checks,
                       "fired": p.fired}
                for name, p in sorted(self._points.items())}


class _Suppress:
    __slots__ = ("_local", "_prev")

    def __init__(self, local: threading.local):
        self._local = local

    def __enter__(self):
        self._prev = getattr(self._local, "on", False)
        self._local.on = True
        return self

    def __exit__(self, *exc):
        self._local.on = self._prev


class _NullFaults(Faults):
    """The zero-cost disabled path: ``check`` is a constant ``False``
    (no dict lookup, no thread-local read), shared process-wide like the
    obs layer's NULL instruments."""

    enabled = False

    def __init__(self):
        super().__init__("")

    def check(self, point: str) -> bool:
        return False

    def maybe_fail(self, point: str) -> None:
        pass


#: The shared disabled registry -- the process default unless
#: ``SPC5_FAULTS`` or :func:`set_faults` arms one.
NULL_FAULTS = _NullFaults()

_global_faults: Faults = NULL_FAULTS


def get_faults() -> Faults:
    """The process-global fault registry (NULL_FAULTS unless armed)."""
    return _global_faults


def set_faults(faults: Optional[Faults]) -> Faults:
    """Swap the process-global registry (None disarms); returns the
    previous one so tests can restore it."""
    global _global_faults
    prev = _global_faults
    _global_faults = faults if faults is not None else NULL_FAULTS
    return prev


def faults_from_env(env: Optional[Dict[str, str]] = None) -> Faults:
    """Build a registry from ``SPC5_FAULTS`` (NULL_FAULTS when unset) --
    how a chaos run arms the whole process under pinned seeds."""
    spec = (os.environ if env is None else env).get("SPC5_FAULTS", "")
    return Faults(spec) if spec else NULL_FAULTS


# Arm from the environment once at import: serve CLI / pytest / chaos runs set
# SPC5_FAULTS before the process starts, and an unset variable keeps the
# shared NULL_FAULTS (the zero-cost default).
_global_faults = faults_from_env()
