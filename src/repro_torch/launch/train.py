"""Training launcher: AdamW steps on the card, with checkpoint/resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --steps 50 [--smoke | --full-config] [--accum 2] [--ckpt-dir DIR]
    PYTHONPATH=src torchrun --nproc-per-node 8 \
        -m repro_torch.launch.train --mesh 2x4 ...

The port of ``repro.launch.train``, with its flags. It trains ``--arch``'s
smoke configuration (``--full-config``: the full one, which needs the
card's memory) in float32 from random weights (``torch.Generator`` seed
0): ``--batch`` x ``--seq`` tokens of ``SyntheticLM`` a step, the cosine
schedule to ``--lr`` (10 warmup steps), a checkpoint every 25 steps and at
the end under ``--ckpt-dir``, from which a second run resumes (on any
mesh: each leaf is laid out by the run that reads it).

``--mesh DxM`` (default: every rank x 1) trains on a data x model mesh
of the ranks ``torchrun`` starts, one process a device: more than one
rank gets the reference's ``make_rules(mesh)`` (FSDP x TP), params and
optimizer state laid out by ``param_shardings``, and each step's batch
(the same global batch on every rank) by ``input_sharding``; one rank
trains without rules, as in the reference. A mesh of another size than
the process group exits naming the ranks it needs. Logs and checkpoint
writes come from rank 0. ``main(argv, device=...)`` runs elsewhere than
the card only when asked (the tests call it inside gloo ranks).
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch

from repro_torch.train.loop import device_batch


def main(argv=None, *, device: Optional[str] = None) -> dict:
    """Parse ``argv`` and train; returns ``train_loop``'s result. ``device``
    (not a flag): None is the card, as for every entry point of the
    port."""
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--mesh", default="",
                    help="DxM data x model mesh of the ranks (default: "
                         "every rank x 1)")
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full-config", dest="smoke", action="store_false",
                    help="use the full assigned config (needs the card's "
                         "memory)")
    ap.add_argument("--remat", default="nothing",
                    choices=["nothing", "dots", "everything"])
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.launch import mesh as LM
    from repro_torch.models import model as MD
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.sharding import rules as SR
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    from repro_torch.train.step import make_train_step

    dev = resolve_device(device)
    d, m = LM.join_mesh_ranks(args.mesh, dev)
    rules = (SR.make_rules(LM.make_test_mesh((d, m), device_type=dev.type))
             if d * m > 1 else None)
    log = print if LM.rank() == 0 else (lambda *a, **k: None)
    log(f"mesh: data={d} model={m}; arch={args.arch} "
        f"({'smoke' if args.smoke else 'full'} config) on {dev}")
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params)
    put_batch = None
    if rules is not None:
        pshard = rules.param_shardings(params)
        params = rules.place_params(params, pshard)
        opt_state = dict(opt_state, m=rules.place_params(opt_state["m"],
                                                         pshard),
                         v=rules.place_params(opt_state["v"], pshard))

        def put_batch(b):
            return rules.place_batch(device_batch(b, dev))
    opt_cfg = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps))
    step = make_train_step(cfg, opt_cfg, rules, args.remat,
                           accum_steps=args.accum)
    out = train_loop(step, params, opt_state, cfg, shape,
                     TrainLoopConfig(steps=args.steps,
                                     ckpt_dir=args.ckpt_dir,
                                     ckpt_every=25, log_every=10),
                     put_batch=put_batch, log_fn=log)
    h = out["history"]
    if h:
        log(f"final: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} "
            f"at step {h[-1]['step'] + 1}")
    return out


if __name__ == "__main__":
    main()
