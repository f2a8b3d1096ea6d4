"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060] (the port
of ``repro.models.ssm``).

Prefill: chunked SSD, a loop over chunks of the intra-chunk quadratic term
(a masked-decay "attention" of size Q x Q) and the inter-chunk state
recurrence. Decode: an O(1) update of the state a token.

Layout: d_inner = expand * d_model, heads of size ssm_head_dim, one B/C
group shared by all heads, state size N = cfg.ssm_state. The decode
state is float32; the conv states are in the model dtype.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as Fn

from repro_torch.sharding.rules import constrain, reshape

from . import layers as L
from .config import ModelConfig

Tensor = torch.Tensor


def init_ssm(gen: torch.Generator, cfg: ModelConfig,
             lead: Sequence[int] = ()) -> Dict[str, Tensor]:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    W = cfg.conv_width
    dev = gen.device
    # dt's softplus inverse of a log-uniform draw in [1e-3, 1e-1]
    u = torch.rand((*lead, h), generator=gen, dtype=torch.float32,
                   device=dev)
    dt0 = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
    return {
        "w_z": L.ninit(gen, (d, di), lead=lead),
        "w_x": L.ninit(gen, (d, di), lead=lead),
        "w_B": L.ninit(gen, (d, n), lead=lead),
        "w_C": L.ninit(gen, (d, n), lead=lead),
        "w_dt": L.ninit(gen, (d, h), lead=lead),
        "w_out": L.ninit(gen, (di, d), scale=di ** -0.5, lead=lead),
        "conv_xw": L.ninit(gen, (W, di), scale=0.5, lead=lead),
        "conv_xb": L.zinit(gen, (di,), lead),
        "conv_Bw": L.ninit(gen, (W, n), scale=0.5, lead=lead),
        "conv_Bb": L.zinit(gen, (n,), lead),
        "conv_Cw": L.ninit(gen, (W, n), scale=0.5, lead=lead),
        "conv_Cb": L.zinit(gen, (n,), lead),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)).expand(
            (*lead, h)).clone(),
        "D": torch.ones((*lead, h), dtype=torch.float32, device=dev),
        "dt_bias": torch.log(torch.expm1(dt0)),
        "norm_scale": L.zinit(gen, (di,), lead),
    }


def _causal_conv(x: Tensor, w: Tensor, b: Tensor,
                 state: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv1d, then SiLU. x: (B, S, C); w: (W, C).
    Returns (y, the last W - 1 inputs: the next call's state)."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i].to(x.dtype) for i in range(W))
    y = Fn.silu(y + b.to(x.dtype))
    new_state = xp[:, -(W - 1):, :] if W > 1 else state
    return y, new_state


def _project(params: Dict[str, Tensor], x: Tensor):
    """The separate (z, x, B, C, dt) projections; dt through softplus in
    float32. Each is shard-clean: z and x over heads, B and C replicated
    over the model axis."""
    dt_ = x.dtype
    z = constrain(x @ params["w_z"].to(dt_), "rec_inner")
    xs = constrain(x @ params["w_x"].to(dt_), "rec_inner")
    B_ = constrain(x @ params["w_B"].to(dt_), "ssm_bc")
    C_ = constrain(x @ params["w_C"].to(dt_), "ssm_bc")
    dt = Fn.softplus((x @ params["w_dt"].to(dt_)).float() + params["dt_bias"])
    return z, xs, B_, C_, constrain(dt, "ssm_dt")


def ssd_chunked(xh: Tensor, dt: Tensor, B_: Tensor, C_: Tensor, A: Tensor,
                D: Tensor, chunk: int,
                intra_dtype: torch.dtype = torch.float32) -> Tensor:
    """Chunked SSD scan: a loop over chunks computes the intra-chunk
    quadratic term and the inter-chunk state recurrence, so one chunk's
    (B, Q, Q, H) decay tensor is live at a time.

    xh: (B, S, H, P); dt: (B, S, H); B_, C_: (B, S, N); A: (H,) positive
    decay rates. ``intra_dtype`` is the intra-chunk products' dtype (their
    sums over the chunk in float32). Returns (B, S, H, P) float32.
    """
    Bsz, S, H, P = xh.shape
    N = B_.shape[-1]
    Q = min(chunk, S)
    assert S % Q == 0, (S, Q)
    nc = S // Q
    f32 = torch.float32
    dev = xh.device
    xh_c = reshape(xh.float(), Bsz, nc, Q, H, P)
    dt_c = reshape(dt.float(), Bsz, nc, Q, H)
    Bm_c = reshape(B_.float(), Bsz, nc, Q, N)
    Cm_c = reshape(C_.float(), Bsz, nc, Q, N)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=dev))
    h = torch.zeros((Bsz, H, N, P), dtype=f32, device=dev)
    ys = []
    for c in range(nc):
        xh_, dt_, Bm, Cm = xh_c[:, c], dt_c[:, c], Bm_c[:, c], Cm_c[:, c]
        l = torch.cumsum(dt_ * (-A), dim=1)                 # (B, Q, H)
        ltot = l[:, -1, :]                                  # (B, H)
        cb = torch.einsum("bqn,bsn->bqs", Cm.to(intra_dtype),
                          Bm.to(intra_dtype))
        ldiff = l[:, :, None, :] - l[:, None, :, :]         # (B, Q, Q, H)
        # masked before the exp, not after: exp(ldiff) can be inf above
        # the diagonal, and a select after it would take 0 * inf = NaN
        # into the backward pass (the forward's values are the same)
        decay = torch.exp(ldiff.masked_fill(~mask[None, :, :, None],
                                            -torch.inf)).to(intra_dtype)
        M = cb[..., None] * decay * dt_[:, None, :, :].to(intra_dtype)
        y = torch.einsum("bqsh,bshp->bqhp", M.float(),
                         xh_.to(intra_dtype).float())
        # inter-chunk contribution from the incoming state
        y = y + torch.einsum("bqn,bqh,bhnp->bqhp", Cm, torch.exp(l), h)
        sdecay = torch.exp(ltot[:, None, :] - l) * dt_      # (B, Q, H)
        h = (torch.exp(ltot)[..., None, None] * h
             + torch.einsum("bqh,bqn,bqhp->bhnp", sdecay, Bm, xh_))
        ys.append(y)
    y = reshape(torch.stack(ys, dim=1), Bsz, S, H, P)
    return y + xh.float() * D[:, None]


def ssm_fwd(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig) -> Tensor:
    """Prefill forward. x: (B, S, D); S a multiple of min(ssm_chunk, S).
    Under sharding rules the internals are head-sharded with the whole
    sequence on each rank (the recurrence runs along S): ``x`` is gathered
    once at the block's entry."""
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    x = constrain(x, "act_full")
    z, xs, B_, C_, dt = _project(params, x)
    xs, _ = _causal_conv(xs, params["conv_xw"], params["conv_xb"])
    B_, _ = _causal_conv(B_, params["conv_Bw"], params["conv_Bb"])
    C_, _ = _causal_conv(C_, params["conv_Cw"], params["conv_Cb"])
    A = torch.exp(params["A_log"])
    xh = constrain(reshape(xs, *xs.shape[:2], h, p), "ssm_inner")
    y = ssd_chunked(xh, dt, B_, C_, A, params["D"], cfg.ssm_chunk,
                    intra_dtype=getattr(torch, cfg.ssd_dtype))
    y = reshape(y, *x.shape[:2], di).to(x.dtype)
    y = L.rmsnorm(y * Fn.silu(z), params["norm_scale"], cfg.norm_eps)
    return y @ params["w_out"].to(x.dtype)


def ssm_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device,
                   lead: Sequence[int] = ()) -> Dict[str, Tensor]:
    di, n = cfg.d_inner, cfg.ssm_state
    w = cfg.conv_width - 1

    def zeros(*shape, dt=dtype):
        return torch.zeros((*lead, batch, *shape), dtype=dt, device=device)
    return {"conv_x": zeros(w, di), "conv_B": zeros(w, n),
            "conv_C": zeros(w, n),
            "state": zeros(cfg.ssm_heads, n, cfg.ssm_head_dim,
                           dt=torch.float32)}


def ssm_decode(params: Dict[str, Tensor], x: Tensor, cache: Dict[str, Tensor],
               cfg: ModelConfig) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: (B, 1, D). The cache is updated in place and
    returned."""
    di, h, p = cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim
    z, xs, B_, C_, dt = _project(params, x)
    xs, conv_x = _causal_conv(xs, params["conv_xw"], params["conv_xb"],
                              cache["conv_x"])
    B_, conv_B = _causal_conv(B_, params["conv_Bw"], params["conv_Bb"],
                              cache["conv_B"])
    C_, conv_C = _causal_conv(C_, params["conv_Cw"], params["conv_Cb"],
                              cache["conv_C"])
    B0, C0 = B_[:, 0], C_[:, 0]
    dt0 = dt[:, 0]                                          # (B, H)
    a = torch.exp(-dt0 * torch.exp(params["A_log"]))        # (B, H)
    xhh = reshape(xs[:, 0], -1, h, p).float()
    upd = (dt0[..., None, None] * B0[:, None, :, None].float()
           * xhh[:, :, None, :])                            # (B, H, N, P)
    state = a[..., None, None] * cache["state"] + upd
    y = torch.einsum("bn,bhnp->bhp", C0.float(), state)
    y = y + xhh * params["D"][:, None]
    y = reshape(y, -1, 1, di).to(x.dtype)
    y = L.rmsnorm(y * Fn.silu(z), params["norm_scale"], cfg.norm_eps)
    for key, new in (("conv_x", conv_x), ("conv_B", conv_B),
                     ("conv_C", conv_C), ("state", state)):
        cache[key].copy_(new)
    return y @ params["w_out"].to(x.dtype), cache
