"""The launchers on a mesh of gloo ranks: ``launch.train --mesh 2x4`` on 8
ranks, its checkpoint resumed on one rank and in the reference, a
one-rank checkpoint resumed on 2x4, ``launch.serve --mesh 1x4`` on 4 of
the ranks, and a mesh larger than the world.

The 8 ranks are spawned once for the file (``torch.multiprocessing``, a
``FileStore``; the serve run joins ranks 0-3 in a second group after the
first is destroyed). Each rank calls ``main(argv, device="cpu")`` as
``torchrun`` would start it; rank 0 saves its output lines and histories.
Losses one resumed step apart agree within ``TOL`` of themselves: the
state resumed is the same, and the sharded and one-rank steps sum the
same products in other orders.
"""
import contextlib
import io
import json
import os
import re
import shutil

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.checkpoint import restore_checkpoint as j_restore
from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import model as JMD
from repro.models.config import ShapeConfig as JShapeConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train import TrainLoopConfig as JTrainLoopConfig
from repro.train import train_loop as j_train_loop
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.checkpoint import latest_step
from repro_torch.launch import train as LT

TOL = 1e-5
ARGV = ["--arch", "yi-6b", "--seq", "32", "--batch", "8"]


def _lines(fn, *a, **k):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*a, **k)
    return out, buf.getvalue().strip().splitlines()


def _rank(rank, world, d):
    import logging
    torch.set_num_threads(1)
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dist.init_process_group("gloo", store=dist.FileStore(
        os.path.join(d, "store"), world), rank=rank, world_size=world)
    from repro_torch.launch import serve
    res = {}
    mesh = ["--mesh", "2x4"]
    a = os.path.join(d, "a")
    out, res["a3"] = _lines(LT.main, ARGV + mesh + ["--steps", "3",
                                                    "--ckpt-dir", a],
                            device="cpu")
    # every rank gathers (a collective); rank 0 keeps the values
    res["a3_params"] = {k: v.full_tensor().tolist() for k, v in
                        out["params"]["units"]["0"]["attn"].items()}
    if rank == 0:
        for copy in ("a_1x1", "a_ref"):
            shutil.copytree(a, os.path.join(d, copy))
    dist.barrier()
    out, res["a5"] = _lines(LT.main, ARGV + mesh + ["--steps", "5",
                                                    "--ckpt-dir", a],
                            device="cpu")
    res["a5_loss"] = out["history"][-1]["loss"]
    out, res["rev5"] = _lines(LT.main, ARGV + mesh + [
        "--steps", "5", "--ckpt-dir", os.path.join(d, "rev")], device="cpu")
    res["rev5_loss"] = out["history"][-1]["loss"]
    try:
        LT.main(ARGV + ["--mesh", "4x4", "--steps", "1"], device="cpu")
    except SystemExit as e:
        res["too_big"] = str(e.code)
    dist.destroy_process_group()
    if rank < 4:
        dist.init_process_group("gloo", store=dist.FileStore(
            os.path.join(d, "store4"), 4), rank=rank, world_size=4)
        _, res["serve"] = _lines(serve.main, [
            "--arch", "yi-6b", "--mesh", "1x4", "--batch", "4",
            "--tokens", "8"], device="cpu")
        dist.destroy_process_group()
    if rank == 0:
        with open(os.path.join(d, "rank0.json"), "w") as f:
            json.dump(res, f)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the directory, rank 0's results): a one-rank run writes step 3
    under ``rev`` first, then the 8 ranks run."""
    d = str(tmp_path_factory.mktemp("sharding_launch"))
    rev = os.path.join(d, "rev")
    _lines(LT.main, ARGV + ["--steps", "3", "--ckpt-dir", rev], device="cpu")
    shutil.copytree(rev, os.path.join(d, "rev_1x1"))
    mp.spawn(_rank, args=(8, d), nprocs=8)
    with open(os.path.join(d, "rank0.json")) as f:
        return d, json.load(f)


def test_train_on_2x4_logs_the_mesh_and_checkpoints(runs):
    d, res = runs
    assert res["a3"][0] == ("mesh: data=2 model=4; arch=yi-6b (smoke "
                            "config) on cpu")
    assert res["a3"][-1].startswith("final: loss") and \
        "at step 3" in res["a3"][-1]
    assert res["a5"][1].startswith("[resume] restored step 3")
    assert latest_step(os.path.join(d, "a")) == 5
    assert np.isfinite(res["a5_loss"])


def test_a_2x4_checkpoint_resumes_on_one_rank(runs):
    """The 2x4 checkpoint of step 3 resumes on one rank: its step 4 loss is
    the 2x4 run's within TOL."""
    d, res = runs
    out, lines = _lines(LT.main, ARGV + [
        "--steps", "5", "--ckpt-dir", os.path.join(d, "a_1x1")],
        device="cpu")
    assert lines[1].startswith("[resume] restored step 3")
    assert out["history"][-1]["loss"] == pytest.approx(res["a5_loss"],
                                                       rel=TOL)


def test_a_2x4_checkpoint_resumes_in_the_reference(runs):
    """The reference restores the 2x4 checkpoint leaf for leaf as the
    sharded run held it, and its loop resumes from it."""
    d, res = runs
    jcfg = ref_smoke_config("yi-6b")
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(0))
    template = {"params": jp, "opt": j_adamw_init(jp)}
    got = j_restore(os.path.join(d, "a_ref"), 3, template)
    assert int(got["opt"]["step"]) == 3
    for k, v in res["a3_params"].items():
        assert np.array_equal(np.asarray(got["params"]["units"]["0"]["attn"]
                                         [k]), np.asarray(v, np.float32)), k
    logs = []
    j_train_loop(jax.jit(j_make_train_step(jcfg, JAdamWConfig(lr=3e-4))),
                 jp, j_adamw_init(jp), jcfg, JShapeConfig("t", 32, 8, "t"),
                 JTrainLoopConfig(steps=4, ckpt_dir=os.path.join(d, "a_ref"),
                                  ckpt_every=25, log_every=100),
                 log_fn=logs.append)
    assert "[resume] restored step 3" in logs[0]


def test_a_one_rank_checkpoint_resumes_on_2x4(runs):
    """The reverse: step 3 written on one rank resumes on 2x4, and its step
    4 loss is the one-rank run's within TOL."""
    d, res = runs
    assert res["rev5"][1].startswith("[resume] restored step 3")
    out, _ = _lines(LT.main, ARGV + [
        "--steps", "5", "--ckpt-dir", os.path.join(d, "rev_1x1")],
        device="cpu")
    assert res["rev5_loss"] == pytest.approx(out["history"][-1]["loss"],
                                             rel=TOL)


def test_serve_on_1x4_prints_the_references_line(runs):
    _, res = runs
    assert len(res["serve"]) == 1
    assert re.fullmatch(r"yi-6b: 4x8 tokens, [0-9.]+ tok/s "
                        r"\(kv=bfloat16, mesh=1x4\)", res["serve"][0])


def test_a_mesh_larger_than_the_world_exits_naming_what_it_needs(runs):
    _, res = runs
    msg = res["too_big"]
    assert msg.startswith("--mesh 4x4: mesh (4, 4) needs 16 ranks, the "
                          "process group has 8")
    assert "torchrun --nproc-per-node 16" in msg


def test_serve_on_a_1x1_mesh_in_one_process_leaves_no_group(capsys):
    """``--mesh 1x1`` without torchrun: the launcher makes a one-rank group
    for its mesh, decodes, runs the vocab bench, and destroys the group."""
    from repro_torch.launch import serve
    serve.main(["--arch", "yi-6b", "--mesh", "1x1", "--tokens", "8",
                "--vocab-spmv", "0.1"], device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert re.fullmatch(r"yi-6b: 4x8 tokens, [0-9.]+ tok/s "
                        r"\(kv=bfloat16, mesh=1x1\)", lines[0])
    assert lines[1].startswith("vocab_spmv[256x64@0.1]: ")
    assert not dist.is_initialized()
