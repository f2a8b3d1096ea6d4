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

On DTensor leaves (a sharded run) ``m`` and ``v`` keep their own layout
(ZeRO-1 may split them further than the params): each leaf's update runs
in its moments' layout and the new param goes back to its own. The clip
norm sums each rank's own squares into one partial sum, reduced once;
``step`` and the metrics are plain tensors, the same on every rank.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple, Union

import torch

from repro_torch.models.convert import tree_leaves, tree_map, zip_map

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
        return torch.zeros_like(p, dtype=torch.float32)
    leaf = next(tree_leaves(params))
    dev = leaf.to_local().device if _is_dt(leaf) else leaf.device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _is_dt(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _own_squares(x) -> torch.Tensor:
    """This rank's share of a DTensor's sum of squares: its block's, on
    the rank of coordinate 0 of each mesh dim the DTensor is whole on (so
    the shares of all ranks sum to the global value once)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    own = all(c == 0 for c, p in zip(coord, x.placements)
              if not p.is_shard())
    loc = x.to_local().float()
    total = torch.sum(torch.square(loc))
    return total if own else torch.zeros_like(total)


def global_norm(tree: Tree) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in float32. On DTensor
    leaves each rank sums its own squares, and the partial sum is reduced
    once; the result is a plain tensor, the same on every rank."""
    leaves = list(tree_leaves(tree))
    dts = [x for x in leaves if _is_dt(x)]
    sums = [torch.sum(torch.square(x.float())) for x in leaves
            if not _is_dt(x)]
    if dts:
        from torch.distributed.tensor import DTensor, Partial
        mesh = dts[0].device_mesh
        part = torch.sum(torch.stack([_own_squares(x) for x in dts]))
        sums.append(DTensor.from_local(
            part, mesh, [Partial()] * mesh.ndim).full_tensor())
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
        pm = p
        if _is_dt(p):   # the update in the moments' layout
            g = g.redistribute(m.device_mesh, m.placements)
            pm = p.redistribute(m.device_mesh, m.placements)
        g = g.float() * scale
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * (g * g)
        mh = m / b1c
        vh = v / b2c
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            delta = delta + cfg.weight_decay * pm.float()
        new = (pm.float() - lr * delta).to(p.dtype)
        if _is_dt(p):
            new = new.redistribute(p.device_mesh, p.placements)
        return new, m, v

    out = zip_map(upd, params, grads, state["m"], state["v"])
    new = [tree_map(lambda t, i=i: t[i], out) for i in range(3)]
    metrics = {"grad_norm": gnorm,
               "lr": torch.as_tensor(lr, dtype=torch.float32,
                                     device=gnorm.device)}
    return new[0], {"m": new[1], "v": new[2], "step": step}, metrics
