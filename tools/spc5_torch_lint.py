#!/usr/bin/env python
"""Port lint: enforce the architecture rules of the PyTorch/CUDA port.

The port's counterpart of ``tools/spc5_lint.py``: the same AST rule
engine (each rule is a function ``rule(root) -> list[Finding]``), run over
``src/repro_torch/`` and, where it exists, ``benchmarks_torch/``. The CLI
runs all rules (or ``--rule NAME``) over ``--root`` (default: the repo
this file lives in) and exits nonzero on any finding, printing
``path:line: [rule] message`` lines. It imports no JAX and nothing of the
JAX package ``repro``; the one runtime rule imports the port's fault
catalogue.

Rules
-----
layout-dispatch
    Layout branching lives in ``repro_torch.core.plan``: nothing else in
    ``src/repro_torch`` compares against a layout name literal, constructs
    a plan handle (``SPC5Plan``, ``ShardedPlan``) or isinstance-checks
    one. The selector's record schema is allowlisted: records name
    layouts, which is data, not dispatch (as in the reference's rule).
kernel-launch
    Kernels launch only under ``repro_torch/kernels/``: nothing outside it
    imports ``repro_torch.kernels._build`` (the nvcc build and the ctypes
    loader), loads a shared library through ``ctypes``, or calls one of
    the C entry points ``_build.SIGNATURES`` binds.
fault-points-registered
    Runtime rule: fault injection is a closed catalogue. Every
    ``maybe_fail(...)`` / fault-registry ``check(...)`` call site names
    its point as a STRING LITERAL found in
    ``repro_torch.obs.faults.CATALOGUE``, and every catalogued point is
    wired at least once.
no-adhoc-timing
    No raw ``time.perf_counter()`` / ``time.time()`` calls: timing routes
    through ``repro_torch.obs`` (spans / ``obs.monotonic``) or, in
    ``benchmarks_torch``, its timing helper. Allowlisted are the modules
    that own a clock: ``obs/spans.py`` (which defines ``monotonic``) and
    ``kernels/_build.py`` (which times the nvcc builds).

The rules are importable (``tests/test_torch_lint.py``); the CLI is the
check to run before a commit:

    python tools/spc5_torch_lint.py [--rule NAME] [--list-rules]
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import sys
from typing import Callable, Dict, List, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = os.path.join("src", "repro_torch")
BENCHES = "benchmarks_torch"

#: Layout name string literals whose comparison constitutes dispatch.
LAYOUT_LITERALS = {"panels", "whole_vector", "whole", "test"}

#: The port's plan handles: only the plan registry builds or branches on
#: them.
HANDLE_NAMES = {"SPC5Plan", "ShardedPlan"}

#: Files allowed to branch on layout: the registry itself, and the
#: selector's record schema (records name layouts; data, not dispatch).
DISPATCH_ALLOWLIST = {
    os.path.join("core", "plan.py"),
    os.path.join("core", "selector.py"),
}

#: The one module that builds and loads the kernels.
BUILD_MODULE = "repro_torch.kernels._build"

#: ctypes calls that load a shared library.
CTYPES_LOADERS = {"CDLL", "PyDLL", "LoadLibrary", "WinDLL", "OleDLL"}

#: (scan subtree, allowlisted rel-paths) for the ad-hoc-timing ban.
TIMING_SCANS = (
    (PORT, frozenset({os.path.join("obs", "spans.py"),
                      os.path.join("kernels", "_build.py")})),
    (BENCHES, frozenset({"timing.py"})),
)

#: The fault registry itself resolves point names from variables.
FAULTS_ALLOWLIST = {os.path.join(PORT, "obs", "faults.py")}


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str          # repo-root-relative
    line: int
    message: str

    def __str__(self):
        return f"{self.path}:{self.line}: [{self.rule}] {self.message}"


_RULES: Dict[str, Callable[[str], List[Finding]]] = {}


def _rule(name: str):
    def deco(fn):
        _RULES[name] = fn
        fn.rule_name = name
        return fn
    return deco


def rule_names():
    return tuple(sorted(_RULES))


# ----------------------------------------------------------------------------
# helpers
# ----------------------------------------------------------------------------

def _py_files(root: str, sub: str):
    """Yield (abspath, relpath-to-``sub``) for .py files under root/sub."""
    base = os.path.join(root, sub)
    for dirpath, dirnames, filenames in os.walk(base):
        dirnames[:] = sorted(d for d in dirnames if d != "__pycache__")
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                ap = os.path.join(dirpath, fn)
                yield ap, os.path.relpath(ap, base)


def _scanned(root: str):
    """(abspath, relpath-to-its-tree, tree) over the port and its benches."""
    for sub in (PORT, BENCHES):
        if os.path.isdir(os.path.join(root, sub)):
            for ap, rel in _py_files(root, sub):
                yield ap, rel, sub


def _parse(path: str) -> Optional[ast.AST]:
    with open(path, encoding="utf-8") as f:
        src = f.read()
    try:
        return ast.parse(src, filename=path)
    except SyntaxError:
        return None    # broken files are the test suite's problem


def _rel(root: str, path: str) -> str:
    return os.path.relpath(path, root)


def _call_name(node: ast.Call) -> str:
    """Trailing name of the called expression: f(), m.f() -> 'f'."""
    fn = node.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    if isinstance(fn, ast.Name):
        return fn.id
    return ""


def _package_of(rel_in_port: str) -> str:
    """Dotted package of a file under ``src/repro_torch`` (for relative
    imports): ``launch/serve.py`` -> ``repro_torch.launch``."""
    parts = ["repro_torch"] + rel_in_port.split(os.sep)[:-1]
    return ".".join(parts)


def _imported_modules(node: ast.AST, package: str):
    """Absolute names an import statement binds: ``import a.b`` ->
    ``a.b``; ``from a import b`` -> ``a.b`` (and ``a``); relative imports
    resolved against ``package``."""
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if not isinstance(node, ast.ImportFrom):
        return []
    base = node.module or ""
    if node.level:
        pkg = package.split(".")
        pkg = pkg[:len(pkg) - node.level + 1]
        base = ".".join(pkg + ([base] if base else []))
    return [base] + [f"{base}.{a.name}" for a in node.names]


# ----------------------------------------------------------------------------
# static rules
# ----------------------------------------------------------------------------

@_rule("layout-dispatch")
def check_layout_dispatch(root: str = REPO_ROOT) -> List[Finding]:
    out: List[Finding] = []
    for ap, rel, sub in _scanned(root):
        if sub == PORT and rel in DISPATCH_ALLOWLIST:
            continue
        tree = _parse(ap)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if isinstance(node, ast.Compare):
                consts = [n for n in [node.left] + list(node.comparators)
                          if isinstance(n, ast.Constant)
                          and n.value in LAYOUT_LITERALS]
                if consts:
                    out.append(Finding(
                        "layout-dispatch", _rel(root, ap), node.lineno,
                        f"comparison against layout literal "
                        f"{consts[0].value!r}; dispatch belongs in "
                        f"repro_torch.core.plan"))
            elif isinstance(node, ast.Call):
                name = _call_name(node)
                if name in HANDLE_NAMES:
                    out.append(Finding(
                        "layout-dispatch", _rel(root, ap), node.lineno,
                        f"direct {name}(...) construction; only the plan "
                        f"registry builds plans"))
                elif name == "isinstance" and len(node.args) == 2:
                    names = {n.id for n in ast.walk(node.args[1])
                             if isinstance(n, ast.Name)}
                    names |= {n.attr for n in ast.walk(node.args[1])
                              if isinstance(n, ast.Attribute)}
                    hit = names & HANDLE_NAMES
                    if hit:
                        out.append(Finding(
                            "layout-dispatch", _rel(root, ap), node.lineno,
                            f"isinstance check against {sorted(hit)[0]}; "
                            f"branch on plan.layout inside "
                            f"repro_torch.core.plan instead"))
    return out


def _entry_points() -> set:
    """The C entry point names ``_build.SIGNATURES`` binds."""
    _import_port(REPO_ROOT)
    from repro_torch.kernels import _build
    return {name for entries in _build.SIGNATURES.values()
            for name in entries}


@_rule("kernel-launch")
def check_kernel_launch(root: str = REPO_ROOT) -> List[Finding]:
    out: List[Finding] = []
    entries = _entry_points()
    kernels_prefix = "kernels" + os.sep
    for ap, rel, sub in _scanned(root):
        if sub == PORT and rel.startswith(kernels_prefix):
            continue
        tree = _parse(ap)
        if tree is None:
            continue
        package = _package_of(rel) if sub == PORT else ""
        for node in ast.walk(tree):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                if BUILD_MODULE in _imported_modules(node, package):
                    out.append(Finding(
                        "kernel-launch", _rel(root, ap), node.lineno,
                        f"imports {BUILD_MODULE} outside repro_torch/"
                        f"kernels/; kernels are built and launched only "
                        f"by their wrappers"))
            elif isinstance(node, ast.Call):
                name = _call_name(node)
                if name in CTYPES_LOADERS:
                    out.append(Finding(
                        "kernel-launch", _rel(root, ap), node.lineno,
                        f"ctypes {name}(...) outside repro_torch/kernels/; "
                        f"shared libraries load only through "
                        f"{BUILD_MODULE}"))
                elif name in entries and isinstance(node.func,
                                                    ast.Attribute):
                    out.append(Finding(
                        "kernel-launch", _rel(root, ap), node.lineno,
                        f"call into C entry point {name} outside "
                        f"repro_torch/kernels/; call its wrapper"))
    return out


@_rule("no-adhoc-timing")
def check_no_adhoc_timing(root: str = REPO_ROOT) -> List[Finding]:
    out: List[Finding] = []
    for sub, allow in TIMING_SCANS:
        if not os.path.isdir(os.path.join(root, sub)):
            continue
        for ap, rel in _py_files(root, sub):
            if rel in allow:
                continue
            tree = _parse(ap)
            if tree is None:
                continue
            for node in ast.walk(tree):
                if not isinstance(node, ast.Call):
                    continue
                name = _call_name(node)
                bad = None
                if name == "perf_counter":
                    bad = "perf_counter()"
                elif (name == "time"
                      and isinstance(node.func, ast.Attribute)
                      and isinstance(node.func.value, ast.Name)
                      and node.func.value.id == "time"):
                    bad = "time.time()"
                if bad:
                    out.append(Finding(
                        "no-adhoc-timing", _rel(root, ap), node.lineno,
                        f"raw {bad}; route timing through repro_torch.obs "
                        f"(span / obs.monotonic) or the benches' timing "
                        f"helper"))
    return out


# ----------------------------------------------------------------------------
# runtime rules (import the port)
# ----------------------------------------------------------------------------

def _import_port(root: str):
    src = os.path.join(root, "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def _is_fault_call(node: ast.Call) -> bool:
    name = _call_name(node)
    if name == "maybe_fail":
        return True
    if name != "check" or not isinstance(node.func, ast.Attribute):
        return False
    # .check() is everywhere; only a fault-registry receiver counts
    # (faults.check, get_faults().check, self._faults_now().check)
    return "fault" in ast.unparse(node.func.value).lower()


@_rule("fault-points-registered")
def check_fault_points_registered(root: str = REPO_ROOT) -> List[Finding]:
    _import_port(REPO_ROOT)
    from repro_torch.obs.faults import CATALOGUE
    out: List[Finding] = []
    wired: Dict[str, int] = {}
    for ap, _, _ in _scanned(root):
        rel = _rel(root, ap)
        if rel in FAULTS_ALLOWLIST:
            continue
        tree = _parse(ap)
        if tree is None:
            continue
        for node in ast.walk(tree):
            if not (isinstance(node, ast.Call) and _is_fault_call(node)):
                continue
            if not (node.args and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)):
                out.append(Finding(
                    "fault-points-registered", rel, node.lineno,
                    "fault point must be a string literal; a computed "
                    "name escapes the catalogue and the chaos runs"))
                continue
            point = node.args[0].value
            if point not in CATALOGUE:
                out.append(Finding(
                    "fault-points-registered", rel, node.lineno,
                    f"fault point {point!r} is not in "
                    f"repro_torch.obs.faults.CATALOGUE; register it there "
                    f"(name, where-it-fires) so the chaos runs cover it"))
                continue
            wired[point] = wired.get(point, 0) + 1
    for point in sorted(set(CATALOGUE) - set(wired)):
        out.append(Finding(
            "fault-points-registered", os.path.join(PORT, "obs",
                                                    "faults.py"), 1,
            f"catalogued fault point {point!r} has no call site under "
            f"{PORT} or {BENCHES}; the chaos runs believe it is covered "
            f"but it never fires"))
    return out


# ----------------------------------------------------------------------------
# running the rules
# ----------------------------------------------------------------------------

def run(root: str = REPO_ROOT, rules=None) -> List[Finding]:
    findings: List[Finding] = []
    for name in (rules or rule_names()):
        findings.extend(_RULES[name](root))
    return findings


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=REPO_ROOT,
                    help="repo root to lint (default: this checkout)")
    ap.add_argument("--rule", action="append", choices=rule_names(),
                    help="run only this rule (repeatable)")
    ap.add_argument("--list-rules", action="store_true")
    args = ap.parse_args(argv)
    if args.list_rules:
        for name in rule_names():
            print(name)
        return 0
    findings = run(os.path.abspath(args.root), args.rule)
    for f in findings:
        print(f)
    if findings:
        print(f"spc5_torch_lint: {len(findings)} finding(s)")
        return 1
    print(f"spc5_torch_lint: clean ({len(args.rule or rule_names())} "
          f"rule(s))")
    return 0


if __name__ == "__main__":
    sys.exit(main())
