"""Batched greedy serving with a KV cache (optionally int8-quantised).

    PYTHONPATH=src python examples_torch/serve_lm.py --arch yi-6b \
        --batch 4 --tokens 64 [--kv-dtype int8] [--device cpu]

The port of ``examples/serve_lm.py``: the reduced per-arch config with
random weights (``torch.Generator`` seed 0), a random first token, then a
``decode_step`` token loop over the KV cache (ring buffers for local
attention). It runs on the card unless ``--device cpu`` is given. The
dense decoder is ported; a MoE, SSM, hybrid or encoder-decoder arch exits
naming the part of ROADMAP queue 1 item 13 that ports it.
"""
import argparse

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs import ARCHS, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.models import model as MD


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", help=f"one of {ARCHS}")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--kv-dtype", default="bfloat16",
                    choices=["bfloat16", "int8"])
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args(argv)
    device = ops.resolve_device(args.device)

    cfg = get_smoke_config(args.arch)
    B, T = args.batch, args.tokens
    try:
        params = MD.init_params(
            cfg, torch.Generator(device=device).manual_seed(0))
    except NotImplementedError as e:
        raise SystemExit(str(e)) from None
    cache = MD.init_cache(cfg, B, T, kv_dtype=args.kv_dtype, device=device)

    rng = np.random.default_rng(0)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 1))).to(device)
    outs = [tok]
    with obs.span("serve_lm.decode", arch=args.arch) as sp:
        for t in range(T - 1):
            logits, cache = MD.decode_step(params, cache, tok, t, cfg)
            tok = torch.argmax(logits, dim=-1)[:, None]
            outs.append(tok)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = sp.duration_s
    seqs = torch.cat(outs, dim=1).cpu().numpy()
    print(f"{args.arch}: generated {B}x{T} tokens in {dt:.2f}s "
          f"({B * (T - 1) / dt:.1f} tok/s, kv={args.kv_dtype})")
    print("first sequence:", seqs[0][:16], "...")
    return seqs


if __name__ == "__main__":
    main()
