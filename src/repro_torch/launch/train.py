"""Training launcher: AdamW steps on the card, with checkpoint/resume.

    PYTHONPATH=src python -m repro_torch.launch.train --arch yi-6b \
        --steps 50 [--smoke | --full-config] [--accum 2] [--ckpt-dir DIR]

The port of ``repro.launch.train``, with its flags. It trains ``--arch``'s
smoke configuration (``--full-config``: the full one, which needs the
card's memory) in float32 from random weights (``torch.Generator`` seed
0): ``--batch`` x ``--seq`` tokens of ``SyntheticLM`` a step, the cosine
schedule to ``--lr`` (10 warmup steps), a checkpoint every 25 steps and at
the end under ``--ckpt-dir``, from which a second run resumes. ``--mesh``
other than ``1x1`` (sharded training) exits naming ROADMAP queue 1 item
13e. ``main(argv, device=...)`` runs elsewhere than the card only when
asked.
"""
from __future__ import annotations

import argparse
import dataclasses
from typing import Optional

import torch


def refuse_mesh(mesh: str) -> None:
    """Raise ``SystemExit`` naming item 13e for a mesh of more than one
    device: the port trains on one device until its sharding rules."""
    if mesh and mesh != "1x1":
        raise SystemExit(
            f"repro_torch.launch.train: --mesh {mesh} shards training, which "
            f"the port does not do yet (ROADMAP queue 1 item 13, part 13e: "
            f"sharding/rules.py and launch/mesh.py); leave it empty or 1x1 "
            f"to train on one device")


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
                    help="DxM data x model; the port takes 1x1 only "
                         "(sharding is ROADMAP queue 1 item 13e)")
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
    refuse_mesh(args.mesh)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.kernels.ops import resolve_device
    from repro_torch.models import model as MD
    from repro_torch.models.config import ShapeConfig
    from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
    from repro_torch.train.loop import TrainLoopConfig, train_loop
    from repro_torch.train.step import make_train_step

    dev = resolve_device(device)
    print(f"mesh: data=1 model=1; arch={args.arch} "
          f"({'smoke' if args.smoke else 'full'} config) on {dev}")
    cfg = (get_smoke_config if args.smoke else get_config)(args.arch)
    cfg = dataclasses.replace(cfg, dtype="float32")
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params)
    opt_cfg = AdamWConfig(lr=cosine_schedule(args.lr, 10, args.steps))
    step = make_train_step(cfg, opt_cfg, None, args.remat,
                           accum_steps=args.accum)
    out = train_loop(step, params, opt_state, cfg, shape,
                     TrainLoopConfig(steps=args.steps,
                                     ckpt_dir=args.ckpt_dir,
                                     ckpt_every=25, log_every=10))
    h = out["history"]
    if h:
        print(f"final: loss {h[0]['loss']:.4f} -> {h[-1]['loss']:.4f} "
              f"at step {h[-1]['step'] + 1}")
    return out


if __name__ == "__main__":
    main()
