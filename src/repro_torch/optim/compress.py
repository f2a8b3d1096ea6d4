"""Gradient compression for a data-parallel all-reduce, the port of
``repro.optim.compress``.

int8 symmetric quantisation per leaf (a scale a row for matrices), summed
across ranks: quantize -> all-reduce (int32 sum) -> dequantize. The
reference runs inside ``shard_map`` over an ``axis_name``; here the
collectives are ``torch.distributed``'s on ``group`` (None: the default
group): its ``pmax`` is an all-reduce ``MAX`` and its ``psum`` an
all-reduce ``SUM`` of int32 payloads. Error feedback (the residual each
rank carries) is as in the reference.
"""
from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.convert import tree_leaves, tree_map


def _axes(g: torch.Tensor) -> Tuple[int, ...]:
    return tuple(range(1, g.dim())) if g.dim() > 1 else (0,)


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    """``x / d`` as a true quotient (a CUDA tensor divided by a Python
    number is multiplied by its reciprocal instead, a bit off the quotient
    the CPU and the reference take)."""
    return x / torch.full((), d, dtype=x.dtype, device=x.device)


def quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(int8 payload, float32 scale): ``scale = max|g| / 127 + 1e-12`` over
    every dim but the first (over the only dim of a vector)."""
    amax = torch.amax(torch.abs(g), dim=_axes(g), keepdim=True)
    scale = _div(amax, 127.0) + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale.float()


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compressed_psum(grads: Any, group=None,
                    residual: Optional[Any] = None) -> Tuple[Any, Any]:
    """Mean-reduce a gradient tree across the ranks of ``group`` in int8.

    Returns (reduced gradients, float32; the new residual tree). Every
    rank calls it with trees of one structure. ``residual`` (the previous
    call's, or None) is added to the gradients before quantising."""
    n = dist.get_world_size(group)

    def one(g, r):
        gf = g.float() + (r if r is not None else 0.0)
        # a shared scale (an f32 MAX all-reduce) so the int32 sum of the
        # payloads dequantizes exactly: sum_i q_i * s == sum_i ~g_i
        s = _div(torch.amax(torch.abs(gf), dim=_axes(gf), keepdim=True),
                 127.0)
        dist.all_reduce(s, op=dist.ReduceOp.MAX, group=group)
        s = s + 1e-12
        q = torch.clamp(torch.round(gf / s), -127, 127).to(torch.int8)
        acc = q.to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        deq = _div(acc.float() * s, float(n))
        return deq, gf - q.float() * s    # local error feedback

    flat_r = list(tree_leaves(residual)) if residual is not None else []
    if len(flat_r) != len(list(tree_leaves(grads))):
        flat_r = None
    it = iter(flat_r or [])
    outs = tree_map(lambda g: one(g, next(it) if flat_r else None), grads)
    return (tree_map(lambda t: t[0], outs), tree_map(lambda t: t[1], outs))
