"""tools/spc5_torch_lint.py: the port's architecture rules.

The real tree must lint clean; synthesized trees planted with violations
must fire exactly the matching rule (mutation coverage for the linter,
as ``tests/test_lint.py`` does for the reference's)."""
import importlib.util
import os
import subprocess
import sys
import textwrap

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOL = os.path.join(REPO, "tools", "spc5_torch_lint.py")


def _load_lint():
    spec = importlib.util.spec_from_file_location("spc5_torch_lint", TOOL)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod    # dataclasses resolve through sys.modules
    spec.loader.exec_module(mod)
    return mod


L = _load_lint()
_SEQ = iter(range(10**6))


def plant(tmp_path, rel, source, tree="src/repro_torch"):
    """Write one file into a FRESH synthetic tree; returns its root."""
    root = tmp_path / f"tree{next(_SEQ)}"
    p = root / tree / rel
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(textwrap.dedent(source))
    return str(root)


def _rules(findings):
    return sorted({f.rule for f in findings})


# ----------------------------------------------------------------------------
# the real tree, the CLI, the registry
# ----------------------------------------------------------------------------

def test_real_tree_is_clean():
    findings = L.run(REPO)
    assert findings == [], "\n".join(str(f) for f in findings)


def test_cli_is_clean_lists_its_rules_and_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, TOOL], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "clean (4 rule(s))" in out.stdout
    listed = subprocess.run([sys.executable, TOOL, "--list-rules"],
                            capture_output=True, text=True, env=env,
                            timeout=120)
    assert listed.stdout.split() == list(L.rule_names())
    code = (f"import runpy, sys\nsys.argv = [{TOOL!r}]\n"
            f"try:\n    runpy.run_path({TOOL!r}, run_name='__main__')\n"
            f"except SystemExit as e:\n    assert e.code == 0\n"
            f"assert not any(m.split('.')[0] in ('jax', 'repro') "
            f"for m in sys.modules)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_rule_registry_is_the_four_rules():
    assert L.rule_names() == ("fault-points-registered", "kernel-launch",
                              "layout-dispatch", "no-adhoc-timing")


def test_planted_tree_cli_exits_nonzero(tmp_path):
    root = plant(tmp_path, "launch/x.py", """
        import time
        t = time.perf_counter()
    """)
    out = subprocess.run([sys.executable, TOOL, "--root", root, "--rule",
                          "no-adhoc-timing"], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 1
    assert "launch/x.py:3: [no-adhoc-timing]" in out.stdout


# ----------------------------------------------------------------------------
# layout-dispatch
# ----------------------------------------------------------------------------

def test_layout_dispatch_fires_on_a_literal_comparison(tmp_path):
    root = plant(tmp_path, "kernels/x.py", """
        def f(plan):
            if plan.layout == "panels":
                return 1
            return "whole_vector" != plan.layout
    """)
    found = L.check_layout_dispatch(root)
    assert [(f.rule, f.line) for f in found] == [("layout-dispatch", 3),
                                                 ("layout-dispatch", 5)]


def test_layout_dispatch_fires_on_plan_handles(tmp_path):
    root = plant(tmp_path, "launch/x.py", """
        from repro_torch.core import plan as P
        def f(p):
            if isinstance(p, P.SPC5Plan):
                return P.ShardedPlan()
    """)
    found = L.check_layout_dispatch(root)
    assert [f.line for f in found] == [4, 5]
    assert "isinstance" in found[0].message


def test_layout_dispatch_allows_the_registry_and_the_record_schema(tmp_path):
    for rel in ("core/plan.py", "core/selector.py"):
        root = plant(tmp_path, rel, """
            def f(layout):
                return layout == "test"
        """)
        assert L.check_layout_dispatch(root) == []
    root = plant(tmp_path, "x.py", "ok = layout == 'test'\n",
                 tree="benchmarks_torch")
    assert _rules(L.check_layout_dispatch(root)) == ["layout-dispatch"]


# ----------------------------------------------------------------------------
# kernel-launch
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("source", [
    "from repro_torch.kernels import _build\n",
    "import repro_torch.kernels._build as B\n",
    "from repro_torch.kernels._build import load\n",
    "from ..kernels import _build\n",
])
def test_kernel_launch_fires_on_the_build_module_outside_kernels(
        tmp_path, source):
    root = plant(tmp_path, "launch/x.py", source)
    found = L.check_kernel_launch(root)
    assert [(f.rule, f.line) for f in found] == [("kernel-launch", 1)]


def test_kernel_launch_fires_on_ctypes_and_entry_points(tmp_path):
    root = plant(tmp_path, "core/x.py", """
        import ctypes
        lib = ctypes.CDLL("libx.so")
        lib.spc5_spmv_whole_s2(0)
        lib.not_an_entry_point(0)
    """)
    found = L.check_kernel_launch(root)
    assert [f.line for f in found] == [3, 4]
    assert "spc5_spmv_whole_s2" in found[1].message


def test_kernel_launch_allows_the_kernels_package(tmp_path):
    root = plant(tmp_path, "kernels/x.py", """
        from . import _build
        from repro_torch.kernels import _build as B
        B.load("spc5_spmv").spc5_spmv_whole_s2(0)
    """)
    assert L.check_kernel_launch(root) == []


# ----------------------------------------------------------------------------
# no-adhoc-timing
# ----------------------------------------------------------------------------

def test_no_adhoc_timing_fires_anywhere_in_the_port(tmp_path):
    root = plant(tmp_path, "models/x.py", """
        import time
        from time import perf_counter
        a = time.time()
        b = perf_counter()
        c = time.monotonic()
    """)
    found = L.check_no_adhoc_timing(root)
    assert [(f.rule, f.line) for f in found] == [("no-adhoc-timing", 4),
                                                 ("no-adhoc-timing", 5)]


def test_no_adhoc_timing_allows_the_clock_owners(tmp_path):
    for rel in ("obs/spans.py", "kernels/_build.py"):
        root = plant(tmp_path, rel, "import time\nt = time.perf_counter()\n")
        assert L.check_no_adhoc_timing(root) == []
    root = plant(tmp_path, "timing.py", "import time\nt = time.time()\n",
                 tree="benchmarks_torch")
    assert L.check_no_adhoc_timing(root) == []
    root = plant(tmp_path, "bench_x.py", "import time\nt = time.time()\n",
                 tree="benchmarks_torch")
    assert _rules(L.check_no_adhoc_timing(root)) == ["no-adhoc-timing"]


# ----------------------------------------------------------------------------
# fault-points-registered
# ----------------------------------------------------------------------------

def _wired_all():
    from repro_torch.obs.faults import CATALOGUE
    return "".join(f"faults.maybe_fail({p!r})\n" for p in CATALOGUE)


def test_fault_points_registered_fires(tmp_path):
    root = plant(tmp_path, "launch/x.py", _wired_all() + textwrap.dedent("""
        def f(name):
            obs.faults.get_faults().maybe_fail("serve.bogus")
            obs.faults.get_faults().maybe_fail(name)
            if obs.faults.get_faults().check("exec.spmv"):
                pass
    """))
    found = L.check_fault_points_registered(root)
    msgs = [f.message for f in found]
    assert len(found) == 2
    assert "'serve.bogus' is not in" in msgs[0]
    assert "string literal" in msgs[1]


def test_fault_points_registered_fires_on_an_unwired_point(tmp_path):
    root = plant(tmp_path, "launch/x.py", "faults.maybe_fail('exec.spmv')\n")
    found = L.check_fault_points_registered(root)
    from repro_torch.obs.faults import CATALOGUE
    assert {f.message.split("'")[1] for f in found} == \
        set(CATALOGUE) - {"exec.spmv"}


def test_fault_points_registered_ignores_unrelated_check(tmp_path):
    root = plant(tmp_path, "launch/x.py", _wired_all()
                 + "report.check(computed_name)\n")
    assert L.check_fault_points_registered(root) == []
