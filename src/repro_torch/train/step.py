"""serve_step / prefill_step builders (the serving half of
``repro.train.step``).

``make_train_step`` waits for the training part of ROADMAP queue 1 item 13
(13d); sharding rules wait for its sharding part (13e).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import tree_map


def _refuse_rules(rules) -> None:
    if rules is not None:
        raise NotImplementedError(
            "repro_torch.train.step: sharding rules are not ported yet "
            "(ROADMAP queue 1 item 13e, sharding/rules.py -> DTensor); "
            "pass rules=None")


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
