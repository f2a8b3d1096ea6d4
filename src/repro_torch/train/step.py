"""train_step / serve_step / prefill_step builders, the port of
``repro.train.step``.

The train step is a plain function on tensor trees: float32 masters in,
gradients by ``torch.autograd.grad`` over the leaves, the AdamW update of
:mod:`repro_torch.optim.adamw`, new trees out. It is pure: its inputs are
left as they were (the reference's launcher donates them to ``jit``; the
port does not imitate that with in-place updates).

Under sharding rules every builder runs its step inside
:func:`repro_torch.sharding.rules.sharding_scope`: the params, optimizer
state, batch and cache are DTensors laid out by the rules, and the
model's ``constrain`` sites redistribute its activations. Gradients come
back laid out as their leaves are.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_leaves, tree_map, zip_map
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.sharding import rules as SR

Tree = Dict[str, Any]


def _grad_like(x: torch.Tensor, g) -> torch.Tensor:
    """``g``, the gradient of leaf ``x``, in float32 and laid out as ``x``
    (zeros where ``x`` was unused)."""
    if g is None:
        return torch.zeros_like(x, dtype=torch.float32)
    if SR.is_dtensor(x):
        g = g.redistribute(x.device_mesh, x.placements)
    return g.float()


def value_and_grad(cfg: ModelConfig, remat_policy: str = "nothing"
                   ) -> Callable:
    """Returns fn(params, batch) -> ((loss, metrics), grads): the
    ``forward_loss`` of ``cfg`` and its gradient with respect to every
    leaf of ``params`` (float32, each laid out as its leaf, a zero tree
    where a leaf is unused). The loss and metrics come back detached,
    plain tensors of their global values; ``params`` is left alone."""
    def fn(params: Tree, batch: Dict[str, torch.Tensor]):
        with torch.enable_grad():
            p = tree_map(lambda t: t.detach().requires_grad_(True), params)
            loss, metrics = MD.forward_loss(p, batch, cfg, remat_policy)
            leaves = list(tree_leaves(p))
            gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        it = iter(_grad_like(x, g) for x, g in zip(leaves, gs))
        grads = tree_map(lambda _: next(it), params)
        return ((SR.full(loss.detach()),
                 {k: SR.full(v.detach()) for k, v in metrics.items()}),
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
    accumulator laid out as the masters (or, under ``cast_once``, as the
    optimizer state) and averaged (activation memory scales with batch /
    accum_steps). ``rules`` runs the step inside their sharding scope.
    ``cast_once`` (ZeRO-1) only acts under rules, as in the reference: the
    masters are cast to cfg.dtype and laid out by the rules without FSDP
    once a step, shared by every microbatch, and the gradients go back to
    the optimizer state's layout (``opt_shardings``). The metrics are the
    model's (averaged over the microbatches), ``loss``, ``grad_norm`` and
    ``lr``, each a 0-d plain tensor on the params' device."""
    vg = value_and_grad(cfg, remat_policy)
    compute_rules = (dataclasses.replace(rules, fsdp=False)
                     if rules is not None and cast_once else None)
    dt = getattr(torch, cfg.dtype)

    def train_step(params: Tree, opt_state: Tree, batch: Tree):
        with SR.sharding_scope(rules):
            if compute_rules is not None:
                cspecs = compute_rules.param_shardings(params)
                mspecs = rules.opt_shardings(params)
                cparams = SR.place(tree_map(
                    lambda p: p.to(dt) if p.is_floating_point() else p,
                    params),
                    rules.mesh, cspecs)

                def tomaster(g, spec):
                    return SR.distribute(g.float(), rules.mesh, spec)

                def zero(p, spec):
                    return SR.distribute(torch.zeros_like(
                        p, dtype=torch.float32), rules.mesh, spec)
            else:
                cparams, mspecs = params, tree_map(lambda _: None, params)

                def tomaster(g, spec):
                    return g

                def zero(p, spec):
                    return torch.zeros_like(p, dtype=torch.float32)
            if accum_steps == 1:
                (loss, metrics), g = vg(cparams, batch)
                grads = zip_map(tomaster, g, mspecs)
            else:
                grads = zip_map(zero, params, mspecs)
                losses, ms = [], []
                for i in range(accum_steps):
                    (l, m), g = vg(cparams, _micro(batch, accum_steps, i,
                                                   rules))
                    grads = zip_map(
                        lambda a, gi, spec: a + tomaster(gi, spec),
                        grads, g, mspecs)
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


def _micro(batch: Tree, n: int, i: int, rules) -> Tree:
    """Microbatch ``i`` of ``n``: rows ``i * B/n`` to ``(i+1) * B/n`` of
    each input (of its global value: a batch is small beside the step),
    laid out by the rules' ``input_sharding``."""
    out = {}
    for k, x in batch.items():
        b = x.shape[0] // n
        m = SR.full(x)[i * b:(i + 1) * b]
        if rules is not None:
            m = SR.distribute(m, rules.mesh,
                              rules.input_sharding(tuple(m.shape), k))
        out[k] = m
    return out


def make_serve_step(cfg: ModelConfig, rules=None, sample: str = "greedy"):
    """Returns serve_step(params, cache, token, pos) -> (next_token, cache):
    one new token against the KV cache, greedy (``argmax``, ties to the
    first index as in the reference). ``next_token`` is (B, 1) int64, the
    index dtype of torch (a DTensor under ``rules``)."""
    if sample != "greedy":
        raise ValueError(sample)

    def serve_step(params, cache, token, pos):
        with SR.sharding_scope(rules):
            logits, cache = MD.decode_step(params, cache, token, pos, cfg)
            return torch.argmax(logits, dim=-1)[:, None], cache

    return serve_step


def make_prefill_step(cfg: ModelConfig, rules=None):
    """Returns prefill_step(params, batch) -> the greedy next token (B,)."""
    def prefill_step(params, batch):
        with SR.sharding_scope(rules):
            logits, _ = MD.prefill(params, batch, cfg)
            return torch.argmax(logits, dim=-1)

    return prefill_step


def cast_params(params: Dict[str, Any], dtype) -> Dict[str, Any]:
    """Every leaf cast to ``dtype`` (a torch dtype or its name), once: the
    values the reference's per-matmul ``.astype(dt)`` gives."""
    dt = getattr(torch, dtype) if isinstance(dtype, str) else dtype
    return tree_map(lambda t: t.to(dt), params)
