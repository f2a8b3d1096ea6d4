"""Unified model facade: dispatch by family (the port of
``repro.models.model``).

Encoder-decoders run through :mod:`.encdec`, every other family through
:mod:`.transformer`. ``input_specs`` / ``cache_specs`` /
``decode_input_specs`` give the dry run its inputs: ``device="meta"``
tensors of the reference's shapes and dtypes (no allocation).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import encdec, transformer
from . import layers as L
from .config import ModelConfig, ShapeConfig

Params = Dict[str, Any]


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    if cfg.is_encdec:
        return encdec.init_params(cfg, gen)
    return transformer.init_params(cfg, gen)


def forward_loss(params: Params, batch: Dict[str, torch.Tensor],
                 cfg: ModelConfig, remat_policy: str = "nothing"):
    """The training loss and its metrics: (loss, {"ce_loss", ...})."""
    if cfg.is_encdec:
        return encdec.forward_loss(params, batch, cfg, remat_policy)
    return transformer.forward_loss(params, batch, cfg, remat_policy)


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kv_dtype: str = "bfloat16",
               device: Optional[torch.device] = None) -> Params:
    """The decode cache on ``device`` (None: the card). An encoder-decoder's
    cross-attention cache is ``max_seq`` frames long, as in the
    reference."""
    if cfg.is_encdec:
        return encdec.init_cache(cfg, batch, max_seq, enc_len=max_seq,
                                 kv_dtype=kv_dtype, device=device)
    return transformer.init_cache(cfg, batch, max_seq, kv_dtype,
                                  device=device)


def decode_step(params: Params, cache: Params, token: torch.Tensor, pos: int,
                cfg: ModelConfig):
    if cfg.is_encdec:
        return encdec.decode_step(params, cache, token, pos, cfg)
    return transformer.decode_step(params, cache, token, pos, cfg)


def prefill(params: Params, batch: Dict[str, torch.Tensor], cfg: ModelConfig):
    """``batch``: "tokens" (B, S) and, for the vlm family, "prefix"
    (B, P, D), for an encoder-decoder "frames" (B, S_enc, D). Returns
    (last-position logits (B, vocab), hidden)."""
    if cfg.is_encdec:
        enc_out = encdec.encode(params, batch["frames"], cfg)
        x = encdec.decode_train(params, enc_out, batch["tokens"], cfg)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        head = transformer._lm_head(params, cfg)
        logits = (x[:, -1] @ head.to(x.dtype)).float()
        return logits[:, :cfg.vocab], x
    return transformer.prefill(params, batch["tokens"], cfg,
                               prefix=batch.get("prefix"))


# ----------------------------------------------------------------------------
# input specs (meta tensors -- no allocation; the dry run's inputs)
# ----------------------------------------------------------------------------

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                dtype: str = "bfloat16") -> Dict[str, torch.Tensor]:
    """Stand-ins for every model input of a train / prefill step."""
    B, Sq = shape.global_batch, shape.seq_len
    i32, dt = torch.int32, getattr(torch, dtype)
    if cfg.is_encdec:
        Sd = max(256, Sq // cfg.dec_ratio)
        return {"frames": _meta((B, Sq, cfg.d_model), dt),
                "tokens": _meta((B, Sd), i32),
                "labels": _meta((B, Sd), i32)}
    if cfg.frontend == "patches":
        St = Sq - cfg.n_prefix
        return {"prefix": _meta((B, cfg.n_prefix, cfg.d_model), dt),
                "tokens": _meta((B, St), i32),
                "labels": _meta((B, St), i32)}
    return {"tokens": _meta((B, Sq), i32), "labels": _meta((B, Sq), i32)}


def cache_specs(cfg: ModelConfig, shape: ShapeConfig,
                kv_dtype: str = "bfloat16") -> Params:
    """``init_cache`` on the meta device (no allocation)."""
    return init_cache(cfg, shape.global_batch, shape.seq_len,
                      kv_dtype=kv_dtype, device=META)


def decode_input_specs(cfg: ModelConfig, shape: ShapeConfig
                       ) -> Dict[str, torch.Tensor]:
    return {"token": _meta((shape.global_batch, 1), torch.int32),
            "pos": _meta((), torch.int32)}
