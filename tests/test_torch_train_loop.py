"""The port's training loop, launcher and example on the CPU: the loop
cases of ``tests/test_train.py`` (the loss falls, exact resume, the
straggler watchdog), a SIGTERM preemption checkpoint, a reference
checkpoint resuming in the port's ``train_loop`` and the port's in the
reference's, ``launch.train.main(..., device="cpu")`` (a ``--mesh`` of
more ranks than the process has exits naming what it needs), and
``examples_torch/train_lm.py``.
Without ``device="cpu"`` and without a card, the entry points raise.
"""
import dataclasses
import importlib.util
import os
import signal

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import latest_step as j_latest_step
from repro.checkpoint import restore_checkpoint as j_restore
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as JMD
from repro.models.config import ShapeConfig as JShapeConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train import TrainLoopConfig as JTrainLoopConfig
from repro.train import train_loop as j_train_loop
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint import latest_step, restore_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as LT
from repro_torch.models import convert as CV
from repro_torch.models import model as MD
from repro_torch.models.config import ShapeConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import TrainLoopConfig, train_loop
from repro_torch.train.step import make_train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _tiny_setup(steps=12, ckpt_dir="", seed=0):
    cfg = get_smoke_config("gemma-2b")
    shape = ShapeConfig("t", 32, 4, "train")
    params = MD.init_params(cfg, torch.Generator().manual_seed(seed))
    opt = adamw_init(params)
    step = make_train_step(cfg, AdamWConfig(lr=3e-3))
    loop_cfg = TrainLoopConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=5,
                               log_every=100)
    return cfg, shape, params, opt, step, loop_cfg


def test_train_loop_loss_decreases():
    cfg, shape, params, opt, step, loop_cfg = _tiny_setup(steps=25)
    out = train_loop(step, params, opt, cfg, shape, loop_cfg,
                     log_fn=lambda *a: None)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0]
    assert np.isfinite(losses[-1])
    assert len(out["step_times"]) == 25


def test_train_loop_resume_exact(tmp_path):
    """10 steps, a restart asking for 14 resumes at 10; its params are the
    uninterrupted 14-step run's bit for bit (stateless data, exact
    state)."""
    d = str(tmp_path / "ck")
    cfg, shape, params, opt, step, loop_cfg = _tiny_setup(steps=10,
                                                          ckpt_dir=d)
    out1 = train_loop(step, params, opt, cfg, shape, loop_cfg,
                      log_fn=lambda *a: None)
    assert latest_step(d) == 10
    cfg, shape, params2, opt2, step, loop_cfg = _tiny_setup(steps=14,
                                                            ckpt_dir=d)
    logs = []
    out2 = train_loop(step, params2, opt2, cfg, shape, loop_cfg,
                      log_fn=logs.append)
    assert any("resume" in str(line) for line in logs)
    assert latest_step(d) == 14 and int(out2["opt_state"]["step"]) == 14
    assert not torch.allclose(out1["params"]["embed"],
                              out2["params"]["embed"])
    cfg, shape, params3, opt3, step, loop_cfg = _tiny_setup(steps=14)
    out3 = train_loop(step, params3, opt3, cfg, shape, loop_cfg,
                      log_fn=lambda *a: None)
    for a, b in zip(CV.tree_leaves(out2["params"]),
                    CV.tree_leaves(out3["params"])):
        assert torch.equal(a, b)


def test_watchdog_counts_stragglers():
    """A step made to take at least 1 s and ten times the median step
    before it: flagged. The straggler scales with the steps around it, so
    it stays far above tolerance x median however loaded the host is."""
    import time as _time
    cfg = get_smoke_config("gemma-2b")
    shape = ShapeConfig("t", 16, 2, "train")
    params = MD.init_params(cfg, torch.Generator().manual_seed(0))
    base = make_train_step(cfg, AdamWConfig(lr=1e-3))
    calls = {"n": 0}
    took = []

    def slow_step(p, o, b):
        calls["n"] += 1
        t0 = _time.perf_counter()
        out = base(p, o, b)
        took.append(_time.perf_counter() - t0)
        if calls["n"] == 9:       # inject a straggler step
            _time.sleep(max(1.0, 10 * float(np.median(took))))
        return out

    logs = []
    out = train_loop(slow_step, params, adamw_init(params), cfg, shape,
                     TrainLoopConfig(steps=10, log_every=100,
                                     straggler_tolerance=3.0),
                     log_fn=logs.append)
    assert out["stragglers"] >= 1
    assert any("[watchdog] step 8" in line for line in logs)


def test_sigterm_checkpoints_and_stops(tmp_path):
    """A SIGTERM during step 3 ends the loop after it with a checkpoint at
    step 4; the handler is put back afterwards."""
    d = str(tmp_path)
    cfg, shape, params, opt, step, _ = _tiny_setup()
    calls = {"n": 0}

    def term_step(p, o, b):
        calls["n"] += 1
        if calls["n"] == 4:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(p, o, b)

    before = signal.getsignal(signal.SIGTERM)
    logs = []
    out = train_loop(term_step, params, opt, cfg, shape,
                     TrainLoopConfig(steps=20, ckpt_dir=d, ckpt_every=50,
                                     log_every=100), log_fn=logs.append)
    assert signal.getsignal(signal.SIGTERM) == before
    assert calls["n"] == 4 and latest_step(d) == 4
    assert any(line.startswith("[preempt] checkpointed at step 4")
               for line in logs)
    assert int(out["opt_state"]["step"]) == 4


# ----------------------------------------------------------------------------
# checkpoints across the packages, through both loops
# ----------------------------------------------------------------------------

def _ref_run(d, steps):
    """The reference's gemma-2b smoke loop for ``steps`` steps into ``d``:
    (its params at the start, its history, one row a step)."""
    cfg = ref_smoke_config("gemma-2b")
    params = JMD.init_params(cfg, jax.random.PRNGKey(0))
    step = jax.jit(j_make_train_step(cfg, JAdamWConfig(lr=3e-3)))
    out = j_train_loop(step, params, j_adamw_init(params), cfg,
                       JShapeConfig("t", 32, 4, "train"),
                       JTrainLoopConfig(steps=steps, ckpt_dir=d,
                                        ckpt_every=5, log_every=1),
                       log_fn=lambda *a: None)
    return params, out


def test_a_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The reference trains 12 steps (a checkpoint at 10); the port,
    started from another init, resumes at 10 from the reference's
    checkpoint and takes steps 10 and 11 on the same data: its losses
    are the reference's within ``TOL`` (the state it resumed is the
    reference's exactly; one AdamW step apart it stays within float
    noise)."""
    d = str(tmp_path)
    _, ref = _ref_run(d, 12)
    os.rename(os.path.join(d, "step_00000012"),
              os.path.join(str(tmp_path), "later"))
    assert latest_step(d) == 10
    cfg, shape, params, opt, step, loop_cfg = _tiny_setup(
        steps=12, ckpt_dir=d, seed=5)
    logs = []
    out = train_loop(step, params, opt, cfg, shape,
                     dataclasses.replace(loop_cfg, log_every=1),
                     log_fn=logs.append)
    assert "[resume] restored step 10" in logs[0]
    ref_loss = {h["step"]: h["loss"] for h in ref["history"]}
    got = {h["step"]: h["loss"] for h in out["history"]}
    assert sorted(got) == [10, 11]
    for s in got:
        assert got[s] == pytest.approx(ref_loss[s], rel=TOL)


def test_a_port_checkpoint_resumes_in_the_reference(tmp_path):
    """The port's loop writes step 6 from the reference's initial params;
    the reference's loop resumes it, and its restored state is the
    port's leaf for leaf."""
    d = str(tmp_path)
    jcfg = ref_smoke_config("gemma-2b")
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    cfg, shape, _, _, step, loop_cfg = _tiny_setup(steps=6, ckpt_dir=d)
    tp = CV.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    out = train_loop(step, tp, adamw_init(tp), cfg, shape, loop_cfg,
                     log_fn=lambda *a: None)
    assert j_latest_step(d) == 6
    template = {"params": jp, "opt": j_adamw_init(jp)}
    got = j_restore(d, 6, template)
    assert int(got["opt"]["step"]) == 6
    mine = CV.tree_to_numpy({"params": out["params"],
                             "opt": out["opt_state"]})
    for path, a in jax.tree_util.tree_flatten_with_path(got)[0]:
        b = mine
        for k in path:
            b = b[k.key]
        assert np.array_equal(np.asarray(a), b)
    logs = []
    j_train_loop(jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=3e-3))),
                 jp, j_adamw_init(jp), jcfg, JShapeConfig("t", 32, 4, "t"),
                 JTrainLoopConfig(steps=7, ckpt_dir=d, ckpt_every=5,
                                  log_every=100), log_fn=logs.append)
    assert "[resume] restored step 6" in logs[0]


# ----------------------------------------------------------------------------
# the launcher and the example
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch,extra", [
    ("yi-6b", []), ("granite-moe-3b-a800m", ["--remat", "dots"]),
    ("mamba2-370m", ["--accum", "2"]),
    ("seamless-m4t-medium", ["--mesh", "1x1"])])
def test_launcher_trains_checkpoints_and_resumes_on_the_cpu(
        tmp_path, capsys, arch, extra):
    argv = ["--arch", arch, "--steps", "3", "--seq", "32", "--batch", "2",
            "--ckpt-dir", str(tmp_path), *extra]
    out = LT.main(argv, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith(f"mesh: data=1 model=1; arch={arch} "
                               f"(smoke config)")
    assert lines[-1].startswith("final: loss") and "at step 3" in lines[-1]
    assert latest_step(str(tmp_path)) == 3
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    argv[3] = "5"
    out = LT.main(argv, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[1].startswith("[resume] restored step 3")
    assert out["history"][-1]["step"] == 4
    state = restore_checkpoint(str(tmp_path), 5,
                               {"params": out["params"],
                                "opt": out["opt_state"]})
    assert int(state["opt"]["step"]) == 5


@pytest.mark.parametrize("mesh", ["2x4", "1x2", "8x1"])
def test_launcher_refuses_a_mesh_naming_13e(mesh):
    """One process without ``torchrun`` is one rank: a mesh of more exits
    naming the ranks it needs and how to start them."""
    d, m = (int(x) for x in mesh.split("x"))
    with pytest.raises(SystemExit) as e:
        LT.main(["--mesh", mesh, "--steps", "1"], device="cpu")
    msg = str(e.value.code)
    assert f"needs {d * m} ranks" in msg and "has 1" in msg
    assert f"torchrun --nproc-per-node {d * m}" in msg


def test_entry_points_without_a_card_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LT.main(["--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _example().main(["--steps", "1"])


def _example():
    spec = importlib.util.spec_from_file_location(
        "examples_torch_train_lm",
        os.path.join(REPO, "examples_torch", "train_lm.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_example_trains_on_the_cpu(capsys):
    out = _example().main(["--arch", "gemma-2b", "--steps", "12", "--seq",
                           "32", "--batch", "4", "--lr", "3e-3",
                           "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("training gemma-2b: ")
    first, last = (float(x) for x in lines[-1].split("loss ")[1]
                   .split(",")[0].split(" -> "))
    assert last < first and out["history"][-1]["step"] == 11


def test_example_preset_is_the_references():
    """``PRESET_100M`` has the reference example's fields (about 125 M
    parameters)."""
    spec = importlib.util.spec_from_file_location(
        "examples_train_lm", os.path.join(REPO, "examples", "train_lm.py"))
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    mine = _example().PRESET_100M
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref.PRESET_100M)
    assert mine.n_params() == ref.PRESET_100M.n_params()
    assert 100e6 < mine.n_params() < 130e6
