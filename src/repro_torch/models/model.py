"""Unified model facade: dispatch by family (the port of
``repro.models.model``).

The decoder-only families run through :mod:`.transformer`, which raises
``NotImplementedError`` for an encoder-decoder (ROADMAP queue 1 item 13c)
and for the blocks not ported yet; ``input_specs`` / ``cache_specs``
belong to the dry run (item 13f).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import transformer
from .config import ModelConfig

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    return transformer.init_params(cfg, gen)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kv_dtype: str = "bfloat16",
               device: Optional[torch.device] = None) -> Params:
    return transformer.init_cache(cfg, batch, max_seq, kv_dtype,
                                  device=device)


def decode_step(params: Params, cache: Params, token: torch.Tensor, pos: int,
                cfg: ModelConfig):
    return transformer.decode_step(params, cache, token, pos, cfg)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """``batch``: "tokens" (B, S) and, for the vlm family, "prefix"
    (B, P, D). Returns (last-position logits (B, vocab), hidden)."""
    return transformer.prefill(params, batch["tokens"], cfg,
                               prefix=batch.get("prefix"))
