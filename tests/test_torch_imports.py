"""The port stands alone: no module of ``src/repro_torch``, no example of
``examples_torch``, not ``chip_smoke.py`` and not the port's lint
(``tools/spc5_torch_lint.py``) imports JAX, ``ml_dtypes`` or the JAX
package ``repro`` (the card's machine has none of them), and importing the
port builds nothing."""
import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "src", "repro_torch")
FORBIDDEN = {"jax", "jaxlib", "ml_dtypes", "repro"}

EXAMPLES = os.path.join(REPO, "examples_torch")
FILES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for top in (PORT, EXAMPLES)
    for d, _, fs in os.walk(top) for f in fs if f.endswith(".py")
) + ["chip_smoke.py", "time_spmm_desc.py", "time_panels_desc.py",
   os.path.join("tools", "spc5_torch_lint.py")]


def _imported_roots(path):
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0], node.lineno


@pytest.mark.parametrize("path", FILES)
def test_no_jax_or_reference_imports(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_port_modules_cover_the_slice():
    names = {os.path.relpath(p, os.path.join("src", "repro_torch"))
             for p in FILES if p.startswith("src")}
    assert {"core/formats.py", "core/matgen.py", "core/ref_spmv.py",
            "core/plan.py", "core/sparse_linear.py", "kernels/_build.py",
            "kernels/spc5_spmv.py", "kernels/spc5_spmm.py",
            "kernels/spc5_spmv_desc.py", "kernels/spc5_spmm_desc.py",
            "kernels/spc5_spmv_tail.py", "kernels/ops.py",
            "core/reorder.py", "core/structure.py", "core/selector.py",
            "core/partition.py", "kernels/ref.py", "analysis/__init__.py",
            "analysis/verify.py", "obs/__init__.py", "obs/metrics.py",
            "obs/spans.py", "obs/export.py", "obs/faults.py",
            "launch/__init__.py", "launch/resilience.py",
            "launch/server.py", "launch/serve.py",
            "core/distributed.py", "launch/chaos_smoke.py",
            "models/__init__.py", "models/config.py", "models/layers.py",
            "models/transformer.py", "models/model.py",
            "models/convert.py", "models/moe.py", "models/ssm.py",
            "models/rglru.py", "models/encdec.py", "configs/__init__.py",
            "train/__init__.py", "train/step.py", "train/loop.py",
            "optim/__init__.py", "optim/schedule.py", "optim/adamw.py",
            "optim/compress.py", "data/__init__.py", "data/synthetic.py",
            "checkpoint/__init__.py", "checkpoint/ckpt.py",
            "launch/train.py", "sharding/__init__.py", "sharding/rules.py",
            "launch/mesh.py", "launch/dryrun.py",
            "analysis/cost.py"} <= names
    configs = {os.path.basename(p) for p in os.listdir(
        os.path.join(REPO, "src", "repro", "configs")) if p.endswith(".py")}
    assert {f"configs/{c}" for c in configs} <= names
    assert {"examples_torch/quickstart.py",
            "examples_torch/cg_solver.py",
            "examples_torch/serve_lm.py",
            "examples_torch/train_lm.py",
            "examples_torch/sharded_collectives.py"} <= set(FILES)
    for src in ("spc5_spmv.cu", "spc5_spmm.cu", "spc5_spmv_desc.cu",
                "spc5_spmm_desc.cu", "spc5_spmm_desc_cmap.cu",
                "spc5_spmv_tail.cu", "spc5_stage.cuh",
                "spc5_spmm_desc_panels.cuh"):
        assert os.path.isfile(os.path.join(PORT, "kernels", "csrc", src))


def test_analysis_package_holds_the_verifier_only():
    """The port's ``analysis`` package imports its verifier and nothing of
    the reference's XLA-HLO analysis (``hlo``)."""
    path = os.path.join("src", "repro_torch", "analysis", "__init__.py")
    roots = {m for m, _ in _imported_roots(path)}
    assert not roots & FORBIDDEN
    with open(os.path.join(REPO, path), encoding="utf-8") as f:
        tree = ast.parse(f.read())
    imported = {(node.module, node.level) for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom)}
    assert imported == {("verify", 1)}
    assert not os.path.exists(os.path.join(PORT, "analysis", "hlo.py"))


def test_importing_the_port_loads_no_jax_and_builds_nothing():
    code = (
        "import sys\n"
        "import repro_torch.kernels.ops, repro_torch.core.matgen\n"
        "import repro_torch.core.sparse_linear\n"
        "import repro_torch.kernels.spc5_spmv_desc\n"
        "import repro_torch.kernels.spc5_spmm_desc\n"
        "import repro_torch.kernels.spc5_spmv_tail\n"
        "import repro_torch.analysis, repro_torch.core.selector\n"
        "import repro_torch.core.partition, repro_torch.kernels.ref\n"
        "import repro_torch.obs, repro_torch.launch.serve\n"
        "import repro_torch.core.distributed\n"
        "import repro_torch.models.model, repro_torch.models.convert\n"
        "import repro_torch.models.moe, repro_torch.models.ssm\n"
        "import repro_torch.models.rglru, repro_torch.models.encdec\n"
        "import repro_torch.configs, repro_torch.train.step\n"
        "import repro_torch.launch.chaos_smoke\n"
        "import repro_torch.launch.train, repro_torch.train.loop\n"
        "import repro_torch.optim.compress, repro_torch.checkpoint\n"
        "import repro_torch.data.synthetic\n"
        "import repro_torch.sharding.rules, repro_torch.launch.mesh\n"
        "import repro_torch.launch.dryrun, repro_torch.analysis.cost\n"
        "from repro_torch.kernels import _build\n"
        "assert not any(m.split('.')[0] in {'jax', 'ml_dtypes', 'repro'} "
        "for m in sys.modules), sorted(m for m in sys.modules if 'jax' in m)\n"
        "assert not _build._libs and not _build.BUILD_LOG\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=env)
    assert res.returncode == 0, res.stderr


def _c_params(source, name):
    """The parameter list of C entry point ``name`` in ``csrc/<source>.cu``:
    "p" for a pointer, "i" for an int."""
    import re
    path = os.path.join(PORT, "kernels", "csrc", f"{source}.cu")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    m = re.search(r"\bint\s+" + name + r"\s*\(([^)]*)\)\s*\{", text)
    assert m, f"{name} not defined in {source}.cu"
    params = [p.strip() for p in m.group(1).split(",")]
    return ["p" if "*" in p else "i" for p in params]


@pytest.mark.parametrize("source", ["spc5_spmv", "spc5_spmv_desc",
                                    "spc5_spmm", "spc5_spmm_cmap",
                                    "spc5_spmm_desc",
                                    "spc5_spmm_desc_cmap",
                                    "spc5_spmv_tail"])
def test_ctypes_signatures_match_the_sources(source):
    """Each entry point's argtypes in ``_build.SIGNATURES`` have the count
    and kinds (pointer or int) of its C parameters, so a launch never passes
    one argument too few or too many."""
    import ctypes

    from repro_torch.kernels import _build
    for name, argtypes in _build.SIGNATURES[source].items():
        kinds = ["p" if t is ctypes.c_void_p else "i" for t in argtypes]
        assert kinds == _c_params(source, name), name


@pytest.mark.parametrize("source", ["spc5_spmv", "spc5_spmv_desc",
                                    "spc5_spmm", "spc5_spmm_cmap",
                                    "spc5_spmm_desc",
                                    "spc5_spmm_desc_cmap",
                                    "spc5_spmv_tail"])
def test_every_c_entry_point_has_a_signature(source):
    """Every function of a source's ``extern "C"`` block is bound in
    ``_build.SIGNATURES`` (so the test above checks its argtypes), and
    nothing bound is missing from the source."""
    import re

    from repro_torch.kernels import _build
    path = os.path.join(PORT, "kernels", "csrc", f"{source}.cu")
    with open(path, encoding="utf-8") as f:
        text = f.read()
    block = text[text.index('extern "C" {'):]
    entries = set(re.findall(r"^int\s+(\w+)\s*\(", block, re.M))
    assert entries == set(_build.SIGNATURES[source])
