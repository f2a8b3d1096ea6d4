"""Decoder-only LM assembly, dense blocks: init, prefill and decode.

The port of ``repro.models.transformer`` for the ``attn`` and ``lattn``
blocks. The parameter and cache trees are the reference's: complete
``cfg.layer_pattern`` repetitions are stacked over ``U = pattern_units``
under ``units[str(p_idx)]``, remainder layers sit under ``rem[str(r_idx)]``,
so a reference tree carries over leaf for leaf
(:mod:`repro_torch.models.convert`). The reference scans the stacked units;
here they are a Python loop over the leading axis. Its sharding
constraints are no-ops outside a sharding scope and are left out.

MoE, SSM and RG-LRU blocks are not ported yet: a config that needs one
raises ``NotImplementedError`` naming the part of ROADMAP queue 1 item 13
that ports it (:func:`check_dense`).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import layers as L
from .config import ModelConfig

Params = Dict[str, Any]
Tensor = torch.Tensor

#: The blocks this module runs.
DENSE_BLOCKS = ("attn", "lattn")


def check_dense(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a config the port cannot run yet:
    an encoder-decoder (item 13c), MoE MLPs (item 13a), or SSM / RG-LRU
    blocks (item 13b)."""
    if cfg.is_encdec:
        part, what = "13c", f"an encoder-decoder (enc_layers={cfg.enc_layers})"
    elif cfg.n_experts:
        part, what = "13a", f"MoE blocks (n_experts={cfg.n_experts})"
    else:
        other = sorted(set(cfg.layer_pattern) - set(DENSE_BLOCKS))
        if not other:
            return
        part, what = "13b", f"{'/'.join(other)} blocks"
    raise NotImplementedError(
        f"repro_torch.models: {cfg.name} uses {what}, which the port does "
        f"not have yet (ROADMAP queue 1 item {part}); the dense 'attn' / "
        f"'lattn' decoder is ported")


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def _init_block(kind: str, cfg: ModelConfig, gen: torch.Generator,
                lead=()) -> Params:
    d = cfg.d_model
    return {"norm": L.zinit(gen, (d,), lead),
            "attn": L.init_attn(gen, cfg, lead),
            "norm2": L.zinit(gen, (d,), lead),
            "mlp": L.init_mlp(gen, cfg, lead=lead)}


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Float32 masters on ``gen``'s device, drawn from ``gen`` (the
    reference's tree and scales; not the JAX PRNG's values)."""
    check_dense(cfg)
    d = cfg.d_model
    params: Params = {
        "embed": L.ninit(gen, (cfg.vocab_padded, d), scale=1.0),
        "final_norm": L.zinit(gen, (d,)),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L.ninit(gen, (d, cfg.vocab_padded))
    U = cfg.pattern_units
    params["units"] = {str(p_idx): _init_block(kind, cfg, gen, (U,))
                       for p_idx, kind in enumerate(cfg.layer_pattern)}
    rem = {str(r_idx): _init_block(kind, cfg, gen)
           for r_idx, kind in enumerate(cfg.remainder_layers)}
    if rem:
        params["rem"] = rem
    return params


def _index(tree: Params, u: int) -> Params:
    """Unit ``u`` of a tree stacked over the units (views, no copies)."""
    return {k: _index(v, u) if isinstance(v, dict) else v[u]
            for k, v in tree.items()}


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------

def _apply_block(kind: str, p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Full-sequence forward for one dense block."""
    window = cfg.window if kind == "lattn" else 0
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    x = x + L.attention_fwd(p["attn"], h, cfg, causal=True, window=window)
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_fwd(p["mlp"], h2, cfg)


def backbone(params: Params, x: Tensor, cfg: ModelConfig
             ) -> Tuple[Tensor, Tensor]:
    """Run all layers on hidden states x (B, S, D). Returns (x, aux_loss);
    the aux loss is MoE's, 0 for the dense blocks."""
    check_dense(cfg)
    for u in range(cfg.pattern_units):
        for p_idx, kind in enumerate(cfg.layer_pattern):
            x = _apply_block(kind, _index(params["units"][str(p_idx)], u),
                             x, cfg)
    for r_idx, kind in enumerate(cfg.remainder_layers):
        x = _apply_block(kind, params["rem"][str(r_idx)], x, cfg)
    return x, torch.zeros((), dtype=torch.float32, device=x.device)


# ----------------------------------------------------------------------------
# heads / embeddings
# ----------------------------------------------------------------------------

def _lm_head(params: Params, cfg: ModelConfig) -> Tensor:
    if cfg.tie_embeddings:
        return params["embed"].T
    return params["lm_head"]


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def embed_tokens(params: Params, tokens: Tensor, cfg: ModelConfig) -> Tensor:
    """The tokens' embedding rows in cfg.dtype (the gathered rows are cast,
    not the whole table: the same values)."""
    return params["embed"][tokens].to(_dtype(cfg))


def _logits(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Float32 logits over the real vocab of hidden states ``x`` (B, D)."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ _lm_head(params, cfg).to(x.dtype)).float()
    return logits[:, :cfg.vocab]


# ----------------------------------------------------------------------------
# KV cache / decode
# ----------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               kv_dtype: str = "bfloat16",
               device: Optional[torch.device] = None) -> Params:
    """Nested cache tree matching the layer pattern (stacked over units) on
    ``device`` (None: the card). ``kv_dtype="int8"`` keeps int8 k / v with
    float32 scales; any other value keeps k / v in cfg.dtype, as in the
    reference."""
    from repro_torch.kernels.ops import resolve_device
    check_dense(cfg)
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    dt = _dtype(cfg)

    def one(kind: str, lead=()) -> Params:
        Sc = max_seq if kind == "attn" else min(max_seq, cfg.window)
        shape = (*lead, batch, Sc, cfg.kv_heads, hd)
        if kv_dtype == "int8":
            sshape = (*lead, batch, Sc, cfg.kv_heads, 1)
            return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                    "v": torch.zeros(shape, dtype=torch.int8, device=device),
                    "k_scale": torch.zeros(sshape, dtype=torch.float32,
                                           device=device),
                    "v_scale": torch.zeros(sshape, dtype=torch.float32,
                                           device=device)}
        return {"k": torch.zeros(shape, dtype=dt, device=device),
                "v": torch.zeros(shape, dtype=dt, device=device)}

    U = cfg.pattern_units
    cache: Params = {"units": {str(p_idx): one(kind, (U,))
                               for p_idx, kind in
                               enumerate(cfg.layer_pattern)}}
    if cfg.remainder_layers:
        cache["rem"] = {str(i): one(kind)
                        for i, kind in enumerate(cfg.remainder_layers)}
    return cache


def _decode_block(kind: str, p: Params, x: Tensor, cache: Params, pos: int,
                  cfg: ModelConfig) -> Tensor:
    window = cfg.window if kind == "lattn" else 0
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    o, _ = L.attention_decode(p["attn"], h, cache, pos, cfg, window=window)
    x = x + o
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    return x + L.mlp_fwd(p["mlp"], h2, cfg)


def decode_step(params: Params, cache: Params, token: Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[Tensor, Params]:
    """One decode step. token: (B, 1) integer; pos: the current position
    (a Python int, the same for the whole batch). Returns (logits
    (B, vocab) float32, cache); the cache is updated in place and keeps the
    reference's structure."""
    check_dense(cfg)
    pos = int(pos)
    x = embed_tokens(params, token, cfg)
    for u in range(cfg.pattern_units):
        for p_idx, kind in enumerate(cfg.layer_pattern):
            key = str(p_idx)
            x = _decode_block(kind, _index(params["units"][key], u), x,
                              _index(cache["units"][key], u), pos, cfg)
    for r_idx, kind in enumerate(cfg.remainder_layers):
        key = str(r_idx)
        x = _decode_block(kind, params["rem"][key], x, cache["rem"][key],
                          pos, cfg)
    return _logits(params, x[:, 0], cfg), cache


def prefill(params: Params, tokens: Tensor, cfg: ModelConfig,
            prefix: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Prompt processing: returns (last-position logits (B, vocab),
    hidden). ``prefix`` (B, P, D) is prepended to the embedded tokens (the
    vlm family's patch embeddings)."""
    x = embed_tokens(params, tokens, cfg)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    x, _ = backbone(params, x, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ _lm_head(params, cfg).to(x.dtype)).float()
    return logits[:, :cfg.vocab], x
