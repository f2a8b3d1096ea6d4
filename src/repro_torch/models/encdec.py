"""Encoder-decoder backbone (seamless-m4t family), the port of
``repro.models.encdec``.

The encoder takes precomputed frame embeddings (the modality frontend is a
stub, as in the reference); the decoder is a causal LM with
cross-attention into the encoder output. Both stacks are stacked over
their layers (``enc`` / ``dec``, the reference's trees) and run as a loop.
The decode cache holds the self-attention K/V and the cross-attention K/V
built once from the encoder output, all in the model dtype. Under
autograd each layer of both stacks runs under a checkpoint, as the
reference's ``jax.checkpoint(layer)`` (whatever ``remat_policy``, which
the reference takes and ignores here too).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.sharding.rules import constrain, one_split_a_dim

from . import layers as L
from .config import ModelConfig
from .transformer import (_dtype, _index, _lm_head, _logits, _unstack,
                          chunked_ce_loss)

Params = Dict[str, Any]
Tensor = torch.Tensor


def _init_enc_layer(cfg: ModelConfig, gen: torch.Generator, lead) -> Params:
    d = cfg.d_model
    return {"norm": L.zinit(gen, (d,), lead),
            "attn": L.init_attn(gen, cfg, lead),
            "norm2": L.zinit(gen, (d,), lead),
            "mlp": L.init_mlp(gen, cfg, lead=lead)}


def _init_dec_layer(cfg: ModelConfig, gen: torch.Generator, lead) -> Params:
    d = cfg.d_model
    return {"norm": L.zinit(gen, (d,), lead),
            "attn": L.init_attn(gen, cfg, lead),
            "norm_x": L.zinit(gen, (d,), lead),
            "xattn": L.init_attn(gen, cfg, lead),
            "norm2": L.zinit(gen, (d,), lead),
            "mlp": L.init_mlp(gen, cfg, lead=lead)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Float32 masters on ``gen``'s device (the reference's tree and
    scales)."""
    d = cfg.d_model
    params: Params = {
        "embed": L.ninit(gen, (cfg.vocab_padded, d), scale=1.0),
        "enc": _init_enc_layer(cfg, gen, (cfg.enc_layers,)),
        "dec": _init_dec_layer(cfg, gen, (cfg.n_layers,)),
        "enc_norm": L.zinit(gen, (d,)),
        "final_norm": L.zinit(gen, (d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.ninit(gen, (d, cfg.vocab_padded))
    return params


def _cross_kv(p: Params, enc_out: Tensor, cfg: ModelConfig
              ) -> Tuple[Tensor, Tensor]:
    """One decoder layer's cross-attention K/V of ``enc_out``."""
    hd, dt = cfg.resolved_head_dim, enc_out.dtype
    return (L._split_heads(enc_out @ p["xattn"]["wk"].to(dt), cfg.kv_heads,
                           hd),
            L._split_heads(enc_out @ p["xattn"]["wv"].to(dt), cfg.kv_heads,
                           hd))


def encode(params: Params, frames: Tensor, cfg: ModelConfig) -> Tensor:
    """frames: (B, S_enc, D) precomputed embeddings -> encoder output."""
    x = constrain(frames.to(_dtype(cfg)), "act")

    @L.remat
    def layer(x, p):
        h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
        x = x + L.attention_fwd(p["attn"], h, cfg, causal=False)
        h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        return constrain(x + L.mlp_fwd(p["mlp"], h2, cfg), "act")

    for p in _unstack(params["enc"], cfg.enc_layers):
        x = layer(x, p)
    return L.rmsnorm(x, params["enc_norm"], cfg.norm_eps)


def decode_train(params: Params, enc_out: Tensor, tokens: Tensor,
                 cfg: ModelConfig) -> Tensor:
    """Teacher-forced decoder forward -> hidden states (B, S_dec, D)."""
    x = constrain(params["embed"][one_split_a_dim(tokens)].to(_dtype(cfg)),
                  "act")

    @L.remat
    def layer(x, p, enc_out):
        h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
        x = x + L.attention_fwd(p["attn"], h, cfg, causal=True)
        hx = L.rmsnorm(x, p["norm_x"], cfg.norm_eps)
        x = x + L.attention_fwd(p["xattn"], hx, cfg, causal=False,
                                kv_override=_cross_kv(p, enc_out.to(x.dtype),
                                                      cfg),
                                rope=False)
        h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        return constrain(x + L.mlp_fwd(p["mlp"], h2, cfg), "act")

    for p in _unstack(params["dec"], cfg.n_layers):
        x = layer(x, p, enc_out)
    return x


def forward_loss(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
                 remat_policy: str = "nothing"
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Training loss: ``encode`` the batch's frames, ``decode_train`` its
    tokens, the head and :func:`chunked_ce_loss` on its labels. Returns
    (loss, {"ce_loss"})."""
    enc_out = encode(params, batch["frames"], cfg)
    x = decode_train(params, enc_out, batch["tokens"], cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    loss = chunked_ce_loss(x, _lm_head(params, cfg), batch["labels"], cfg)
    return loss, {"ce_loss": loss}


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_len: int,
               kv_dtype: str = "bfloat16",
               device: Optional[torch.device] = None) -> Params:
    """Zero self- and cross-attention K/V on ``device`` (None: the card),
    always in cfg.dtype: ``kv_dtype`` is taken and ignored, as in the
    reference."""
    from repro_torch.kernels.ops import resolve_device
    device = resolve_device(device)
    hd, dt, Ld = cfg.resolved_head_dim, _dtype(cfg), cfg.n_layers

    def zeros(S):
        return torch.zeros((Ld, batch, S, cfg.kv_heads, hd), dtype=dt,
                           device=device)
    return {"self_k": zeros(max_seq), "self_v": zeros(max_seq),
            "cross_k": zeros(enc_len), "cross_v": zeros(enc_len)}


def build_cross_cache(params: Params, enc_out: Tensor, cfg: ModelConfig,
                      cache: Params) -> Params:
    """``cache`` with its cross-attention K/V computed from ``enc_out``
    (B, S_enc, D), every decoder layer's, stacked (a new dict; the self
    K/V are the same tensors)."""
    kv = [_cross_kv(_index(params["dec"], i), enc_out, cfg)
          for i in range(cfg.n_layers)]
    return dict(cache, cross_k=torch.stack([k for k, _ in kv]),
                cross_v=torch.stack([v for _, v in kv]))


def decode_step(params: Params, cache: Params, token: Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[Tensor, Params]:
    """One decode step. token: (B, 1); pos: the current position (a Python
    int). Returns (logits (B, vocab) float32, cache); the self K/V are
    updated in place."""
    pos = int(pos)
    dt = _dtype(cfg)
    x = constrain(params["embed"][one_split_a_dim(token)].to(dt),
                  "act_decode")
    for i in range(cfg.n_layers):
        p = _index(params["dec"], i)
        h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
        o, _ = L.attention_decode(p["attn"], h, {"k": cache["self_k"][i],
                                                 "v": cache["self_v"][i]},
                                  pos, cfg)
        x = x + o
        hx = L.rmsnorm(x, p["norm_x"], cfg.norm_eps)
        x = x + L.attention_fwd(p["xattn"], hx, cfg, causal=False,
                                kv_override=(cache["cross_k"][i].to(dt),
                                             cache["cross_v"][i].to(dt)),
                                rope=False)
        h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        x = constrain(x + L.mlp_fwd(p["mlp"], h2, cfg), "act_decode")
    return _logits(params, x[:, 0], cfg), cache
