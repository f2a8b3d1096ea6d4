"""Training on the card (ROADMAP queue 1 item 13d): one train step of
each smoke config on the card against the CPU, and the launcher
checkpointing and resuming on the card.

Every test here needs an NVIDIA GPU: it is marked ``gpu`` and skips from
the ``cuda`` fixture where ``torch.cuda.is_available()`` is False. Run on
the card with

    python -m pytest -m gpu tests/test_torch_train_card.py

The checks and limits are ``chip_smoke.py``'s phase 5c (``lm_train_case``:
loss and every gradient leaf within 1e-5 of its max, AdamW on the same
gradients within 1e-6, the three remat policies alike, with TF32 off).
This file imports no JAX (the card's machine has none).
"""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.launch import train as LT

pytestmark = pytest.mark.gpu

ARCHS = ("yi-6b", "gemma-2b", "glm4-9b", "deepseek-67b", "internvl2-26b",
         "phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m", "mamba2-370m",
         "recurrentgemma-9b", "seamless-m4t-medium")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (run: python -m pytest -m gpu "
                    "tests/test_torch_train_card.py on the card)")
    return torch.device("cuda")


@pytest.fixture
def no_tf32():
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = saved


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_on_the_card_match_the_cpu(cuda, no_tf32, arch):
    out = _chip_smoke().lm_train_case(arch, cuda)
    assert len(out["steps"]) == 2
    assert all(s["grad_err"] <= 1e-5 for s in out["steps"])


def test_launcher_checkpoints_and_resumes_on_the_card(cuda, tmp_path,
                                                      capsys):
    argv = ["--arch", "granite-moe-3b-a800m", "--steps", "4", "--seq", "64",
            "--batch", "4", "--ckpt-dir", str(tmp_path)]
    out = LT.main(argv)
    assert next(iter(out["params"].values())).device.type == "cuda"
    assert latest_step(str(tmp_path)) == 4
    argv[3] = "6"
    out = LT.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    assert any(line.startswith("[resume] restored step 4") for line in lines)
    assert out["history"][-1]["step"] == 5
    assert int(out["opt_state"]["step"]) == 6
    assert out["opt_state"]["step"].device.type == "cuda"
