"""End-to-end LM training driver with checkpoint/restart, on the card.

    PYTHONPATH=src python examples_torch/train_lm.py --arch yi-6b --steps 300
    PYTHONPATH=src python examples_torch/train_lm.py --preset 100m --steps 300

The port of ``examples/train_lm.py``. ``--preset 100m`` trains a ~100M
parameter llama-style model; ``--arch`` an arch's smoke config in float32.
With ``--ckpt-dir``, interrupt with SIGTERM and re-run: training resumes
from the latest checkpoint (the default keeps none). ``--device cpu``
runs the plain PyTorch path on the host.
"""
import argparse
import dataclasses

import torch

from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.kernels.ops import resolve_device
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig, ShapeConfig
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.train.loop import TrainLoopConfig, train_loop
from repro_torch.train.step import make_train_step

PRESET_100M = ModelConfig(
    name="llama-100m", family="dense", n_layers=12, d_model=768,
    n_heads=12, kv_heads=4, d_ff=2048, vocab=32000, act="silu", glu=True,
    dtype="float32")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="", help=f"one of {ARCHS} (reduced "
                    "smoke config) -- or use --preset")
    ap.add_argument("--preset", default="", choices=["", "100m"])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint and resume here (default: none)")
    ap.add_argument("--device", default=None,
                    help="cpu for the host (default: the card)")
    args = ap.parse_args(argv)

    if args.preset == "100m":
        cfg = PRESET_100M
    else:
        cfg = dataclasses.replace(get_smoke_config(args.arch or "yi-6b"),
                                  dtype="float32")
    dev = resolve_device(args.device)
    shape = ShapeConfig("train", args.seq, args.batch, "train")
    n = cfg.n_params()
    print(f"training {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.batch}x{args.seq} tokens/step, {args.steps} steps on {dev}")

    params = MD.init_params(cfg, torch.Generator(device=dev).manual_seed(0))
    opt_state = adamw_init(params)
    opt_cfg = AdamWConfig(
        lr=cosine_schedule(args.lr, warmup=20, total=args.steps))
    step = make_train_step(cfg, opt_cfg, None, accum_steps=args.accum)
    out = train_loop(
        step, params, opt_state, cfg, shape,
        TrainLoopConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                        ckpt_every=50, log_every=10))
    hist = out["history"]
    print(f"done: loss {hist[0]['loss']:.4f} -> {hist[-1]['loss']:.4f}, "
          f"{out['stragglers']} straggler steps flagged")
    return out


if __name__ == "__main__":
    main()
