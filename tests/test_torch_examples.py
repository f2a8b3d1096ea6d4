"""The port's examples (``examples_torch/``) on the CPU: the quickstart,
the CG solver, with and without ``--distributed`` (a group of one gloo
rank in this process), and the LM serving loop, each run through its
``main`` with ``--device cpu``. The solver must converge (relative residual under 1e-4,
the reference's ``rs < 1e-10`` stop), and the line before each last line
gives the launches of the SpMV kernels: none on the CPU. Without a card
and without ``--device cpu`` both raise."""
import importlib.util
import json
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}",
        os.path.join(REPO, "examples_torch", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _launches(line):
    assert line.startswith("launches: ")
    return json.loads(line[len("launches: "):])


def test_quickstart_on_the_cpu(capsys):
    _example("quickstart").main(["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == "matrix: (3000, 3000), nnz=66352"
    assert sum("vs CSR" in line for line in lines) == 4
    assert "max err = 0.00e+00" in lines[-3]
    assert _launches(lines[-2]) == {}
    assert lines[-1].startswith("selector picks beta(")


@pytest.mark.parametrize("distributed", [False, True])
def test_cg_solver_converges_on_the_cpu(capsys, distributed):
    argv = ["--device", "cpu", "--n", "600"]
    _example("cg_solver").main(argv + ["--distributed"] * distributed)
    lines = capsys.readouterr().out.strip().splitlines()
    assert ("distributed SpMV over 1 ranks" in lines[0]) == distributed
    assert _launches(lines[-2]) == {}
    last = lines[-1].split()
    assert last[:3] == ["converged:", "relative", "residual"]
    assert float(last[3]) < 1e-4
    assert not torch.distributed.is_initialized()


def test_serve_lm_decodes_on_the_cpu(capsys):
    """The greedy loop from a seeded first token: the same tokens run after
    run, inside the vocab, and the reference's two lines."""
    argv = ["--device", "cpu", "--arch", "gemma-2b", "--batch", "2",
            "--tokens", "9", "--kv-dtype", "int8"]
    seqs = _example("serve_lm").main(argv)
    again = _example("serve_lm").main(argv)
    assert seqs.shape == (2, 9) and (seqs == again).all()
    assert 0 <= seqs.min() and seqs.max() < 256
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("gemma-2b: generated 2x9 tokens in ")
    assert lines[0].endswith("tok/s, kv=int8)")
    assert lines[1].startswith("first sequence: [")


def test_serve_lm_names_the_part_of_item_13_an_arch_needs():
    """Every decoder-only arch decodes (recurrentgemma's RG-LRU state and
    lattn ring, granite's MoE routing); the encoder-decoder exits with
    the reference example's message."""
    for arch in ("recurrentgemma-9b", "granite-moe-3b-a800m"):
        seqs = _example("serve_lm").main(["--device", "cpu", "--arch", arch,
                                          "--batch", "2", "--tokens", "20"])
        assert seqs.shape == (2, 20) and seqs.max() < 256
    with pytest.raises(SystemExit, match="^use the encdec example path: "
                       "seamless decode is exercised in tests/test_models.py"):
        _example("serve_lm").main(["--device", "cpu", "--arch",
                                   "seamless-m4t-medium"])


@pytest.mark.parametrize("name,argv", [("quickstart", []),
                                       ("cg_solver", []),
                                       ("cg_solver", ["--distributed"]),
                                       ("serve_lm", [])])
def test_examples_need_a_card_or_device_cpu(monkeypatch, name, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example(name).main(argv)
