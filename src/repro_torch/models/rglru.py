"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427), the
port of ``repro.models.rglru``.

h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t),
a_t = exp(-c * softplus(Lambda) * r_t),  r / i input-dependent sigmoids.

The reference runs the prefill's linear recurrence with
``jax.lax.associative_scan``; here it is a doubling scan (:func:`scan`),
log2(S) elementwise steps over the whole sequence. Neither divides by a
running product of ``a``: log a reaches about -17 a step, so that product
underflows float32 within a few steps. Decode is a single-step update.
Block layout: two input branches (conv + RG-LRU, and a GELU gate),
merged elementwise, then the output projection.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.sharding.rules import constrain

from . import layers as L
from .config import ModelConfig

Tensor = torch.Tensor

_C = 8.0  # Griffin's fixed gate sharpness


def init_rec(gen: torch.Generator, cfg: ModelConfig,
             lead: Sequence[int] = ()) -> Dict[str, Tensor]:
    d, w = cfg.d_model, cfg.resolved_lru_width
    return {
        "w_x": L.ninit(gen, (d, w), lead=lead),
        "w_gate": L.ninit(gen, (d, w), lead=lead),
        "conv_w": L.ninit(gen, (cfg.conv_width, w), scale=0.5, lead=lead),
        "conv_b": L.zinit(gen, (w,), lead),
        "w_rg": L.ninit(gen, (w, w), lead=lead),       # recurrence gate
        "w_ig": L.ninit(gen, (w, w), lead=lead),       # input gate
        "lam": torch.full((*lead, w), 2.0, dtype=torch.float32,
                          device=gen.device),          # Lambda
        "w_out": L.ninit(gen, (w, d), scale=w ** -0.5, lead=lead),
    }


def _conv(x: Tensor, w: Tensor, b: Tensor,
          state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d with no activation (the SSM's has SiLU).
    x: (B, S, C); w: (W, C). Returns (y, the next call's state)."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i].to(x.dtype) for i in range(W))
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return y + b.to(x.dtype), new_state


def _gates(params: Dict[str, Tensor], xb: Tensor) -> Tuple[Tensor, Tensor]:
    """(a, gated input), both float32 (B, S, W)."""
    r = torch.sigmoid((xb @ params["w_rg"].to(xb.dtype)).float())
    i = torch.sigmoid((xb @ params["w_ig"].to(xb.dtype)).float())
    a = torch.exp(-_C * Fn.softplus(params["lam"]) * r)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i * xb.float())
    return a, b


def scan(a: Tensor, b: Tensor) -> Tensor:
    """h_t = a_t * h_{t-1} + b_t along dim 1 from h_{-1} = 0: the reference's
    associative scan of ``(a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2)``,
    as doubling steps (each combines every position with the one ``d``
    before it, d = 1, 2, 4, ...)."""
    S = a.shape[1]
    d = 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rec_fwd(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig) -> Tensor:
    """Prefill forward. x: (B, S, D)."""
    dt = x.dtype
    xb = constrain(x @ params["w_x"].to(dt), "rec_inner")
    gate = Fn.gelu(constrain(x @ params["w_gate"].to(dt), "rec_inner"),
                   approximate="tanh")
    xb, _ = _conv(xb, params["conv_w"], params["conv_b"])
    h = scan(*_gates(params, xb))
    return (h.to(dt) * gate) @ params["w_out"].to(dt)


def rec_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device,
                   lead: Sequence[int] = ()) -> Dict[str, Tensor]:
    w = cfg.resolved_lru_width
    return {"conv": torch.zeros((*lead, batch, cfg.conv_width - 1, w),
                                dtype=dtype, device=device),
            "state": torch.zeros((*lead, batch, w), dtype=torch.float32,
                                 device=device)}


def rec_decode(params: Dict[str, Tensor], x: Tensor, cache: Dict[str, Tensor],
               cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: (B, 1, D). The cache is updated in place and
    returned."""
    dt = x.dtype
    xb = x @ params["w_x"].to(dt)                           # (B, 1, W)
    gate = Fn.gelu(x @ params["w_gate"].to(dt), approximate="tanh")
    xb, conv_state = _conv(xb, params["conv_w"], params["conv_b"],
                           cache["conv"])
    a, b = _gates(params, xb)
    h = a[:, 0] * cache["state"] + b[:, 0]                  # (B, W)
    cache["conv"].copy_(conv_state)
    cache["state"].copy_(h)
    return (h[:, None, :].to(dt) * gate) @ params["w_out"].to(dt), cache
