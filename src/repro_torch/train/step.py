"""train_step / serve_step / prefill_step builders, the port of
``repro.train.step``.

The train step is a plain function on tensor trees: float32 masters in,
gradients by ``torch.autograd.grad`` over the leaves, the AdamW update of
:mod:`repro_torch.optim.adamw`, new trees out. It is pure: its inputs are
left as they were (the reference's launcher donates them to ``jit``; the
port does not imitate that with in-place updates). Sharding rules wait
for ROADMAP queue 1 item 13e.
"""
from __future__ import annotations

from typing import Any, Callable, Dict

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_leaves, tree_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update

Tree = Dict[str, Any]


def _refuse_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "repro_torch.train.step: sharding rules are not ported yet "
            "(ROADMAP queue 1 item 13e, sharding/rules.py -> DTensor); "
            "pass rules=None")


def value_and_grad(cfg: ModelConfig, remat_policy: str = "nothing"
                   ) -> Callable:
    """Returns fn(params, batch) -> ((loss, metrics), grads): the
    ``forward_loss`` of ``cfg`` and its gradient with respect to every
    leaf of ``params`` (float32, a zero tree where a leaf is unused). The
    loss and metrics come back detached; ``params`` is left alone."""
    def fn(params: Tree, batch: Dict[str, torch.Tensor]):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, metrics = MD.forward_loss(p, batch, cfg, remat_policy)
            leaves = list(tree_leaves(p))
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(torch.zeros_like(x, dtype=torch.float32) if g is None
                  else g.float() for x, g in zip(leaves, gs))
        grads = tree_map(lambda _: next(it), params)
        return ((loss.detach(), {k: v.detach() for k, v in metrics.items()}),
                grads)
    return fn


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, rules=None,
                    remat_policy: str = "nothing", accum_steps: int = 1,
                    cast_once: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt,
    metrics).

    Params are float32 masters; the forward casts to cfg.dtype inside.
    ``accum_steps`` > 1 splits the batch's leading dim into that many
    microbatches, one after another, their gradients summed into a float32
    accumulator and averaged (activation memory scales with batch /
    accum_steps). ``cast_once`` only acts under sharding rules, as in the
    reference; ``rules`` is refused (item 13e). The metrics are the
    model's (averaged over the microbatches), ``loss``, ``grad_norm`` and
    ``lr``, each a 0-d tensor on the params' device."""
    _refuse_rules(rules)
    del cast_once   # a no-op without rules, as in the reference
    vg = value_and_grad(cfg, remat_policy)

    def train_step(params: Tree, opt_state: Tree, batch: Tree):
        if accum_steps == 1:
            (loss, metrics), grads = vg(params, batch)
        else:
            micro = {k: x.reshape(accum_steps, x.shape[0] // accum_steps,
                                  *x.shape[1:]) for k, x in batch.items()}
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, ms = [], []
            for i in range(accum_steps):
                (l, m), g = vg(params, {k: x[i] for k, x in micro.items()})
                it = iter(tree_leaves(g))
                grads = tree_map(lambda a: a + next(it), grads)
                losses.append(l)
                ms.append(m)
            grads = tree_map(lambda g: g / accum_steps, grads)
            loss = torch.stack(losses).mean()
            metrics = {k: torch.stack([m[k] for m in ms]).mean()
                       for k in ms[0]}
        new_params, new_opt, opt_metrics = adamw_update(
            params, grads, opt_state, opt_cfg)
        return new_params, new_opt, dict(metrics, loss=loss, **opt_metrics)

    return train_step


def make_serve_step(cfg: ModelConfig, rules=None, sample: str = "greedy"):
    """Returns serve_step(params, cache, token, pos) -> (next_token, cache):
    one new token against the KV cache, greedy (``argmax``, ties to the
    first index as in the reference). ``next_token`` is (B, 1) int64, the
    index dtype of torch."""
    _refuse_rules(rules)
    if sample != "greedy":
        raise ValueError(sample)

    def serve_step(params, cache, token, pos):
        logits, cache = MD.decode_step(params, cache, token, pos, cfg)
        return torch.argmax(logits, dim=-1)[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, rules=None):
    """Returns prefill_step(params, batch) -> the greedy next token (B,)."""
    _refuse_rules(rules)

    def prefill_step(params, batch):
        logits, _ = MD.prefill(params, batch, cfg)
        return torch.argmax(logits, dim=-1)

    return prefill_step


def cast_params(params: Dict[str, Any], dtype) -> Dict[str, Any]:
    """Every leaf cast to ``dtype`` (a torch dtype or its name), once: the
    values the reference's per-matmul ``.astype(dt)`` gives."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return tree_map(lambda t: t.to(dt), params)
