"""AdamW with global-norm clipping on tensor trees, the port of
``repro.optim.adamw``.

The state is the reference's tree, ``{"m": ..., "v": ..., "step": ...}``:
``m`` and ``v`` mirror the parameters in float32 and ``step`` is a 0-d
int32 tensor, so a reference checkpoint restores into it. The arithmetic
is the reference's: the clip scale ``min(1, clip_norm / (norm + 1e-9))``,
bias correction, ``eps`` outside the square root, and decoupled weight
decay on leaves of two or more dims only. ``torch.optim.AdamW`` is not
used: it decays every parameter and keeps another state layout.

:func:`adamw_update` is pure: it returns new trees and leaves its inputs
alone.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.models.convert import tree_leaves, tree_map

Tree = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def adamw_init(params: Tree) -> Tree:
    """Zero ``m`` and ``v`` (float32, on each leaf's device) and step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = next(tree_leaves(params)).device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32."""
    sums = [torch.sum(torch.square(x.float())) for x in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(sums)))


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: Tree, cfg: AdamWConfig
                 ) -> Tuple[Tree, Tree, Dict[str, torch.Tensor]]:
    """One step: (new params, new state, {"grad_norm", "lr"}), the norm
    taken before clipping."""
    step = state["step"] + 1
    lr = cfg.lr(step) if callable(cfg.lr) else cfg.lr

    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)

    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * (g * g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = _zip_map(upd, params, grads, state["m"], state["v"])
    new = [tree_map(lambda t, i=i: t[i], out) for i in range(3)]
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gnorm.device)}
    return new[0], {"m": new[1], "v": new[2], "step": step}, metrics


def _zip_map(fn, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and the same leaves of ``rest``
    (trees of one structure), as a tree of ``tree``'s structure."""
    return {k: _zip_map(fn, v, *(r[k] for r in rest)) if isinstance(v, dict)
            else fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
