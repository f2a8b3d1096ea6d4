"""Decoder-only LM assembly: init, the training loss, prefill and decode
(the port of ``repro.models.transformer``).

The parameter and cache trees are the reference's: complete
``cfg.layer_pattern`` repetitions are stacked over ``U = pattern_units``
under ``units[str(p_idx)]``, remainder layers sit under ``rem[str(r_idx)]``,
so a reference tree carries over leaf for leaf
(:mod:`repro_torch.models.convert`). The reference scans the stacked units;
here they are a Python loop over the leading axis. Its sharding
constraints sit where the reference's do (:func:`repro_torch.sharding.
rules.constrain`, the identity outside a sharding scope): each
half-block's output is constrained to the boundary spec before the
residual add.

Blocks: ``attn`` and ``lattn`` (global and windowed attention, each with
an MLP or, under ``cfg.n_experts``, a MoE), ``ssm`` (Mamba-2 SSD) and
``rec`` (RG-LRU, with an MLP or MoE). An unknown kind raises
``ValueError``, as in the reference.

Training (:func:`forward_loss`) runs each unit under
``torch.utils.checkpoint`` by ``remat_policy``, the reference's three
policies. The reference nests a checkpoint a half-block inside each unit
and groups the units two levels deep (sqrt(L) carries); here there is one
checkpoint a unit (and a remainder layer): the same numbers, more
activation memory (ROADMAP §3). :func:`chunked_ce_loss` never holds the
(B, S, V) logits: each sequence chunk's logits are recomputed in the
backward pass.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.sharding import rules as SR

from . import layers as L
from . import moe as M
from . import rglru as R
from . import ssm as S
from .config import ModelConfig

Params = Dict[str, Any]
Tensor = torch.Tensor


# ----------------------------------------------------------------------------
# init
# ----------------------------------------------------------------------------

def _init_ffn(p: Params, cfg: ModelConfig, gen: torch.Generator,
              lead) -> Params:
    """``p`` with its second half: a MoE under ``cfg.n_experts``, else an
    MLP."""
    if cfg.n_experts:
        p["moe"] = M.init_moe(gen, cfg, lead)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, lead=lead)
    return p


def _init_block(kind: str, cfg: ModelConfig, gen: torch.Generator,
                lead=()) -> Params:
    d = cfg.d_model
    if kind in ("attn", "lattn"):
        return _init_ffn({"norm": L.zinit(gen, (d,), lead),
                          "attn": L.init_attn(gen, cfg, lead),
                          "norm2": L.zinit(gen, (d,), lead)}, cfg, gen, lead)
    if kind == "ssm":
        return {"norm": L.zinit(gen, (d,), lead),
                "ssm": S.init_ssm(gen, cfg, lead)}
    if kind == "rec":
        return _init_ffn({"norm": L.zinit(gen, (d,), lead),
                          "rec": R.init_rec(gen, cfg, lead),
                          "norm2": L.zinit(gen, (d,), lead)}, cfg, gen, lead)
    raise ValueError(kind)


def init_params(cfg: ModelConfig, gen: torch.Generator) -> Params:
    """Float32 masters on ``gen``'s device, drawn from ``gen`` (the
    reference's tree and scales; not the JAX PRNG's values)."""
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


def _unstack(tree: Params, n: int) -> List[Params]:
    """The ``n`` units of a tree stacked over the units, each leaf taken
    apart by one ``unbind(0)`` (views). Under autograd its backward stacks
    the units' gradients once, where ``n`` selects would each allocate a
    zero gradient the size of the whole stack."""
    if not n:
        return []
    parts = {k: _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
             for k, v in tree.items()}
    return [{k: v[u] for k, v in parts.items()} for u in range(n)]


# ----------------------------------------------------------------------------
# blocks
# ----------------------------------------------------------------------------

def _ffn(p: Params, x: Tensor, cfg: ModelConfig, dropless: bool
         ) -> Tuple[Tensor, Optional[Tensor]]:
    """The block's second half on ``x``: (x + out, the MoE's aux loss or
    None for an MLP)."""
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    if cfg.n_experts:
        o2, aux = M.moe_fwd(p["moe"], h2, cfg, dropless=dropless)
        return x + SR.constrain(o2, "act"), aux
    return x + SR.constrain(L.mlp_fwd(p["mlp"], h2, cfg), "act"), None


def _apply_block(kind: str, p: Params, x: Tensor, cfg: ModelConfig,
                 train: bool = False) -> Tuple[Tensor, Optional[Tensor]]:
    """Full-sequence forward for one block: (x, the MoE's aux loss or
    None). ``train`` only affects MoE blocks: training drops tokens over
    capacity, prefill runs dropless so its logits match step decode."""
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    if kind in ("attn", "lattn"):
        window = cfg.window if kind == "lattn" else 0
        o = L.attention_fwd(p["attn"], h, cfg, causal=True, window=window)
    elif kind == "ssm":
        o = SR.constrain(S.ssm_fwd(p["ssm"], h, cfg), "act")
        return SR.constrain(x + o, "act"), None
    elif kind == "rec":
        o = R.rec_fwd(p["rec"], h, cfg)
    else:
        raise ValueError(kind)
    x, aux = _ffn(p, x + SR.constrain(o, "act"), cfg, dropless=not train)
    return SR.constrain(x, "act"), aux


def backbone(params: Params, x: Tensor, cfg: ModelConfig,
             remat_policy: str = "nothing", train: bool = False
             ) -> Tuple[Tensor, Tensor]:
    """Run all layers on hidden states x (B, S, D). Returns (x, aux_loss),
    the sum of the MoE blocks' aux losses (0 without one). ``train=False``
    runs MoE blocks dropless. Under autograd each unit (and each remainder
    layer) runs under :func:`layers.remat` by ``remat_policy``."""
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(kinds):
        def fn(x, p):
            aux = zero
            for key, kind in kinds:
                x, a = _apply_block(kind, p[key], x, cfg, train)
                if a is not None:
                    aux = aux + a
            return x, aux
        return L.remat(fn, remat_policy)

    unit = run([(str(i), kind) for i, kind in enumerate(cfg.layer_pattern)])
    aux = zero
    U = cfg.pattern_units
    units = {k: _unstack(v, U) for k, v in params["units"].items()}
    for u in range(U):
        x, a = unit(x, {k: v[u] for k, v in units.items()})
        aux = aux + a
    for r_idx, kind in enumerate(cfg.remainder_layers):
        x, a = run([(str(r_idx), kind)])(x, params["rem"])
        aux = aux + a
    return x, aux


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
    return params["embed"][SR.one_split_a_dim(tokens)].to(_dtype(cfg))


def chunked_ce_loss(h: Tensor, head: Tensor, labels: Tensor,
                    cfg: ModelConfig, chunk: int = 512) -> Tensor:
    """Cross-entropy over sequence chunks; the full (B, S, V) logits are
    never held (each chunk runs under a checkpoint, its logits recomputed
    in the backward pass). ``labels == -1`` are masked out; padded vocab
    columns (>= cfg.vocab) are masked to -inf. Returns the mean over the
    valid labels (``loss_sum / max(n, 1)``), float32."""
    B, Sq, D = h.shape
    chunk = min(chunk, Sq)
    assert Sq % chunk == 0
    vpad = cfg.vocab_padded - cfg.vocab

    def step(hc, head, lc):
        logits = (hc @ head.to(hc.dtype)).float()
        if vpad:
            dead = torch.arange(logits.shape[-1],
                                device=logits.device) >= cfg.vocab
            logits = logits.masked_fill(dead, -torch.inf)
        # the gold logit is gathered from the whole vocab row
        logits = SR.unshard(logits, -1)
        lse = torch.logsumexp(logits, dim=-1)
        lcc = torch.clamp(lc, 0, cfg.vocab - 1).long()
        gold = torch.gather(logits, -1, lcc[..., None])[..., 0]
        valid = (lc >= 0).float()
        return ((lse - gold) * valid).sum(), valid.sum()

    step = L.remat(step)
    loss_sum = n = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(Sq // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        ls, nc = step(h[:, sl], head, labels[:, sl])
        loss_sum, n = loss_sum + ls, n + nc
    return loss_sum / torch.clamp_min(n, 1.0)


def _logits(params: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    """Float32 logits over the real vocab of hidden states ``x`` (B, D)."""
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ _lm_head(params, cfg).to(x.dtype)).float()
    return logits[:, :cfg.vocab]


def forward_loss(params: Params, batch: Dict[str, Tensor], cfg: ModelConfig,
                 remat_policy: str = "nothing"
                 ) -> Tuple[Tensor, Dict[str, Tensor]]:
    """Training loss. batch: tokens (B, S) and labels (B, S), int32 or
    int64; the vlm family adds prefix (B, P, D), whose positions get
    labels of -1. MoE blocks keep capacity dropping and add 0.01 x their
    aux loss. Returns (loss, {"ce_loss", "aux_loss"})."""
    x = embed_tokens(params, batch["tokens"], cfg)
    labels = batch["labels"]
    if cfg.frontend == "patches":
        prefix = batch["prefix"].to(x.dtype)
        x = torch.cat([prefix, x], dim=1)
        labels = torch.cat([torch.full(prefix.shape[:2], -1,
                                       dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    x = SR.constrain(x, "act")
    x, aux = backbone(params, x, cfg, remat_policy, train=True)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    loss = chunked_ce_loss(x, _lm_head(params, cfg), labels, cfg)
    metrics = {"ce_loss": loss, "aux_loss": aux}
    if cfg.n_experts:
        loss = loss + 0.01 * aux
    return loss, metrics


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
    device = resolve_device(device)
    hd = cfg.resolved_head_dim
    dt = _dtype(cfg)

    def one(kind: str, lead=()) -> Params:
        if kind == "ssm":
            return S.ssm_init_cache(cfg, batch, dt, device, lead)
        if kind == "rec":
            return R.rec_init_cache(cfg, batch, dt, device, lead)
        if kind not in ("attn", "lattn"):
            raise ValueError(kind)
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
    """One block of a decode step; its cache is updated in place. MoE
    blocks run dropless."""
    h = L.rmsnorm(x, p["norm"], cfg.norm_eps)
    if kind in ("attn", "lattn"):
        window = cfg.window if kind == "lattn" else 0
        o, _ = L.attention_decode(p["attn"], h, cache, pos, cfg,
                                  window=window)
    elif kind == "ssm":
        o, _ = S.ssm_decode(p["ssm"], h, cache, cfg)
        return x + o
    elif kind == "rec":
        o, _ = R.rec_decode(p["rec"], h, cache, cfg)
    else:
        raise ValueError(kind)
    return _ffn(p, x + o, cfg, dropless=True)[0]


def _decode_block_c(kind: str, p: Params, x: Tensor, cache: Params,
                    pos: int, cfg: ModelConfig) -> Tensor:
    return SR.constrain(_decode_block(kind, p, x, cache, pos, cfg),
                        "act_decode")


def decode_step(params: Params, cache: Params, token: Tensor, pos: int,
                cfg: ModelConfig) -> Tuple[Tensor, Params]:
    """One decode step. token: (B, 1) integer; pos: the current position
    (a Python int, the same for the whole batch). Returns (logits
    (B, vocab) float32, cache); the cache is updated in place and keeps the
    reference's structure."""
    pos = int(pos)
    x = SR.constrain(embed_tokens(params, token, cfg), "act_decode")
    for u in range(cfg.pattern_units):
        for p_idx, kind in enumerate(cfg.layer_pattern):
            key = str(p_idx)
            x = _decode_block_c(kind, _index(params["units"][key], u), x,
                                _index(cache["units"][key], u), pos, cfg)
    for r_idx, kind in enumerate(cfg.remainder_layers):
        key = str(r_idx)
        x = _decode_block_c(kind, params["rem"][key], x,
                            cache["rem"][key], pos, cfg)
    return _logits(params, x[:, 0], cfg), cache


def prefill(params: Params, tokens: Tensor, cfg: ModelConfig,
            prefix: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Prompt processing: returns (last-position logits (B, vocab),
    hidden). ``prefix`` (B, P, D) is prepended to the embedded tokens (the
    vlm family's patch embeddings)."""
    x = embed_tokens(params, tokens, cfg)
    if prefix is not None:
        x = torch.cat([prefix.to(x.dtype), x], dim=1)
    x = SR.constrain(x, "act")
    x, _ = backbone(params, x, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = (x[:, -1] @ _lm_head(params, cfg).to(x.dtype)).float()
    return logits[:, :cfg.vocab], x
