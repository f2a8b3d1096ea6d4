"""LR schedules (cosine with linear warmup), the port of
``repro.optim.schedule``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(peak_lr: float, warmup: int, total: int,
                    floor_frac: float = 0.1):
    """``lr(step)``: linear warmup to ``peak_lr`` over ``warmup`` steps,
    then a cosine down to ``floor_frac * peak_lr`` at ``total``. ``step``
    is an int or a 0-d tensor; the result is a 0-d float32 tensor on the
    step's device (the CPU for an int)."""
    def lr(step):
        s = torch.as_tensor(step).to(torch.float32)
        warm = peak_lr * s / max(warmup, 1)
        prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor_frac + (1 - floor_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(s < warmup, warm, cos)
    return lr
