"""``python -m repro_torch.launch.chaos_smoke`` on the CPU: armed from
``SPC5_FAULTS`` in a fresh process, every request lands on the oracle's y
or fails with a catalogued error, at least one lands, and the module exits
0; without an armed fault set it exits 1."""
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = {
    # every catalogued point at 10 %, the reference's CI spec
    "all six": "plan.build:0.1:1,cache.admit:0.1:2,exec.spmv:0.1:3,"
               "exec.spmm:0.1:4,serve.gather:0.1:5,serve.exec:0.1:6",
    # the four points chip_smoke.py's serving phase arms at 10 %
    "the smoke's four": "exec.spmv:0.1:11,exec.spmm:0.1:12,"
                        "serve.gather:0.1:13,serve.exec:0.1:14",
}


def _run(spec, *argv):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    env.pop("SPC5_FAULTS", None)
    if spec:
        env["SPC5_FAULTS"] = spec
    return subprocess.run([sys.executable, "-m",
                           "repro_torch.launch.chaos_smoke", *argv],
                          capture_output=True, text=True, env=env,
                          timeout=300, cwd=REPO)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_the_module_holds_the_contract_under_faults_on_the_cpu(name):
    res = _run(SPECS[name], "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert "plan panels + mask on cpu" in out
    assert "contract held" in out
    ok = int(out.split(" ok=")[1].split()[0])
    failed = int(out.split(" failed=")[1].split()[0])
    assert ok >= 1 and ok + failed == 32
    for point in SPECS[name].split(","):
        assert f"{point.split(':')[0]}: checks=" in out


def test_the_module_refuses_to_run_unarmed():
    res = _run("", "--device", "cpu")
    assert res.returncode == 1
    assert "SPC5_FAULTS is not set" in res.stderr
