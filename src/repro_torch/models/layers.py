"""Shared neural layers: norms, RoPE, attention (prefill/decode), MLP.

The port of ``repro.models.layers``, as plain functions on tensors.
Conventions, as in the reference:
  * params are stored float32 (master); compute casts to cfg.dtype;
  * softmax/norm statistics and the attention scores accumulate in float32
    (bf16 operands are upcast before the score products, the reference's
    ``preferred_element_type=float32``);
  * a query head h reads KV head ``h // G`` (G = n_heads // kv_heads);
  * sequence length <= PLAIN_ATTN_MAX uses plain masked attention; longer
    sequences use a blocked flash attention (online softmax over kv
    blocks, a checkpoint a q block under autograd);
  * decode uses a dedicated one-token path over the KV cache, with optional
    int8 cache quantisation and ring-buffer windows for local attention.

Attention is computed with einsums, as the reference computes it, never
with a library attention call, so the two packages agree tightly. The
decode cache is updated in place (the reference's caller donates it).
"""
from __future__ import annotations

import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as Fn
from torch.utils import checkpoint as ckpt

from repro_torch.sharding import rules as SR

from .config import ModelConfig

PLAIN_ATTN_MAX = 1_024   # use plain attention at/below this seq len
FLASH_QB = 1_024
FLASH_KVB = 1_024

Tensor = torch.Tensor


# ----------------------------------------------------------------------------
# init helpers
# ----------------------------------------------------------------------------

def ninit(gen: torch.Generator, shape: Sequence[int],
          scale: Optional[float] = None, lead: Sequence[int] = ()) -> Tensor:
    """Normal float32 weights of ``(*lead, *shape)`` on ``gen``'s device,
    scaled by ``scale`` or ``fan_in ** -0.5`` of ``shape`` (``lead`` stacks
    layers, as the reference's vmap over the units does)."""
    fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
    scale = scale if scale is not None else fan_in ** -0.5
    return torch.randn((*lead, *shape), generator=gen, dtype=torch.float32,
                       device=gen.device) * scale


def zinit(gen: torch.Generator, shape: Sequence[int],
          lead: Sequence[int] = ()) -> Tensor:
    """Float32 zeros of ``(*lead, *shape)`` on ``gen``'s device."""
    return torch.zeros((*lead, *shape), dtype=torch.float32,
                       device=gen.device)


# ----------------------------------------------------------------------------
# rematerialisation
# ----------------------------------------------------------------------------

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the matmuls without batch dims (a weight product on flattened
    tokens lowers to ``mm``), recompute the rest: the reference's
    ``dots_with_no_batch_dims_saveable``."""
    if op in _SAVED_DOTS:
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


REMAT_POLICIES = ("nothing", "dots", "everything")


def remat(fn: Callable, policy: str = "nothing") -> Callable:
    """``fn`` under ``torch.utils.checkpoint`` by ``policy``: "nothing"
    saves only its inputs, "dots" also the matmuls without batch dims,
    "everything" is ``fn`` itself. Outside autograd (no grad mode) it is
    ``fn``."""
    if policy not in REMAT_POLICIES:
        raise KeyError(policy)
    if policy == "everything":
        return fn
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)
    return wrapped


# ----------------------------------------------------------------------------
# norms / rope
# ----------------------------------------------------------------------------

def rmsnorm(x: Tensor, scale: Tensor, eps: float = 1e-5) -> Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * (1.0 + scale.float())).to(x.dtype)


def rope_freqs(hd: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, hd, 2, dtype=np.float32) / hd))


@functools.lru_cache(maxsize=None)
def _freqs_on(hd: int, theta: float, device: torch.device) -> Tensor:
    """:func:`rope_freqs` on ``device``, copied there once (a host copy in
    every decode step would wait for the card's queue)."""
    return torch.from_numpy(rope_freqs(hd, theta)).to(device)


def apply_rope(x: Tensor, pos: Tensor, theta: float) -> Tensor:
    """x: (..., S, H, D) or (..., S, D); pos broadcastable to (..., S).
    Rotates the two halves of the head dim (not interleaved pairs)."""
    hd = x.shape[-1]
    freqs = _freqs_on(hd, float(theta), x.device)
    ang = pos[..., None].float() * freqs                    # (..., S, hd/2)
    if x.dim() == ang.dim() + 1:                             # head dim present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ----------------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------------

def init_attn(gen: torch.Generator, cfg: ModelConfig,
              lead: Sequence[int] = ()) -> Dict[str, Tensor]:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    return {
        "wq": ninit(gen, (d, cfg.n_heads * hd), lead=lead),
        "wk": ninit(gen, (d, cfg.kv_heads * hd), lead=lead),
        "wv": ninit(gen, (d, cfg.kv_heads * hd), lead=lead),
        "wo": ninit(gen, (cfg.n_heads * hd, d),
                    scale=(cfg.n_heads * hd) ** -0.5, lead=lead),
    }


def _split_heads(x: Tensor, n: int, hd: int) -> Tensor:
    return SR.reshape(x, *x.shape[:-1], n, hd)


def _mask_ok(qpos: Tensor, kpos: Tensor, causal: bool, window: int) -> Tensor:
    """(Sq, Sk) boolean: key j is visible to query i."""
    ok = torch.ones((qpos.shape[-1], kpos.shape[-1]), dtype=torch.bool,
                    device=qpos.device)
    if causal:
        ok &= kpos[None, :] <= qpos[:, None]
    if window:
        ok &= kpos[None, :] > qpos[:, None] - window
    return ok


def plain_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                    window: int = 0, q0: int = 0) -> Tensor:
    """q, k, v: (B, S, H, D) (KV already expanded to H heads). Returns
    (B, Sq, H, D)."""
    hd = q.shape[-1]
    s = torch.einsum("bqhd,bshd->bhqs", q.float(), k.float()) * (hd ** -0.5)
    qpos = torch.arange(q.shape[1], device=q.device) + q0
    kpos = torch.arange(k.shape[1], device=q.device)
    s = s.masked_fill(~_mask_ok(qpos, kpos, causal, window), -torch.inf)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p, v)


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *, causal: bool,
                    window: int = 0, qb: int = FLASH_QB,
                    kvb: int = FLASH_KVB) -> Tensor:
    """Blocked attention with an online-softmax carry; same shapes as
    :func:`plain_attention`. A loop over q blocks, and within each over kv
    blocks, so the scores held at once are (qb, kvb) a head. Under
    autograd each q block runs under a checkpoint (the reference's
    ``jax.checkpoint(q_block)``): its backward recomputes the block's
    scores instead of keeping them."""
    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    qb = min(qb, Sq)
    kvb = min(kvb, Sk)
    assert Sq % qb == 0 and Sk % kvb == 0, (Sq, qb, Sk, kvb)
    dev = q.device

    def q_block(qblk, k, v, qi):
        qblk = qblk.float()
        qpos = qi * qb + torch.arange(qb, device=dev)
        m = torch.full((B, H, qb), -torch.inf, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((B, H, qb), dtype=torch.float32, device=dev)
        acc = torch.zeros((B, H, qb, D), dtype=torch.float32, device=dev)
        for kj in range(Sk // kvb):
            kblk = k[:, kj * kvb:(kj + 1) * kvb]
            vblk = v[:, kj * kvb:(kj + 1) * kvb]
            s = torch.einsum("bqhd,bshd->bhqs", qblk, kblk.float()) \
                * (D ** -0.5)
            kpos = kj * kvb + torch.arange(kvb, device=dev)
            ok = _mask_ok(qpos, kpos, causal, window)
            s = s.masked_fill(~ok, -torch.inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None]).masked_fill(~ok, 0.0)
            alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                                0.0)
            l = l * alpha + p.sum(dim=-1)
            pv = torch.einsum("bhqs,bshd->bhqd", p.to(vblk.dtype).float(),
                              vblk.float())
            acc = acc * alpha[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        return out.transpose(1, 2).to(q.dtype)                # (B,qb,H,D)

    block = remat(q_block)
    return torch.cat([block(q[:, qi * qb:(qi + 1) * qb], k, v, qi)
                      for qi in range(Sq // qb)], dim=1)


def attention_fwd(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig, *,
                  causal: bool = True, window: int = 0,
                  kv_override: Optional[Tuple[Tensor, Tensor]] = None,
                  rope: bool = True) -> Tensor:
    """Full-sequence attention (prefill). x: (B, S, D). KV heads are
    repeated to the full H before the score einsums, as in the
    reference."""
    hd = cfg.resolved_head_dim
    K, H = cfg.kv_heads, cfg.n_heads
    G = H // K
    dt = x.dtype
    q = _split_heads(x @ params["wq"].to(dt), H, hd)
    if kv_override is None:
        k = _split_heads(x @ params["wk"].to(dt), K, hd)
        v = _split_heads(x @ params["wv"].to(dt), K, hd)
    else:
        k, v = kv_override
    if rope:
        pos = torch.arange(x.shape[1], device=x.device)[None, :]
        q = apply_rope(q, pos, cfg.rope_theta)
        if kv_override is None:
            k = apply_rope(k, pos, cfg.rope_theta)
    if G > 1:
        # replicate the small kv tensors over tp BEFORE the head broadcast
        # so the expand is a local slice
        k = SR.constrain(k, "kv_small")
        v = SR.constrain(v, "kv_small")
        k = torch.repeat_interleave(k, G, dim=2)
        v = torch.repeat_interleave(v, G, dim=2)
    q = SR.constrain(q, "qkv")
    k = SR.constrain(k, "qkv")
    v = SR.constrain(v, "qkv")
    fn = plain_attention if x.shape[1] <= PLAIN_ATTN_MAX else flash_attention
    # batch and heads split, sequence and head dim whole: each rank's
    # attention is its own
    o, = SR.local(functools.partial(fn, causal=causal, window=window),
                  [q, k, v], [("qkv", tuple(q.shape))])
    o = SR.reshape(o, *o.shape[:2], H * hd)
    return o @ params["wo"].to(dt)


def attention_prefill_kv(params: Dict[str, Tensor], x: Tensor,
                         cfg: ModelConfig) -> Tuple[Tensor, Tensor]:
    """Compute the (roped) K/V cache for a prompt. Returns (k, v)."""
    hd = cfg.resolved_head_dim
    dt = x.dtype
    k = _split_heads(x @ params["wk"].to(dt), cfg.kv_heads, hd)
    v = _split_heads(x @ params["wv"].to(dt), cfg.kv_heads, hd)
    pos = torch.arange(x.shape[1], device=x.device)[None, :]
    k = apply_rope(k, pos, cfg.rope_theta)
    return k, v


def quantize_kv(k: Tensor) -> Tuple[Tensor, Tensor]:
    """Per-(token, head) symmetric int8 quantisation of a cache tensor
    (round half to even, as ``jnp.round``). In bf16 ``k / scale`` can reach
    127.5, which rounds to 128: the cast saturates it to 127, as the
    reference's XLA convert does (torch's cast would wrap it to -128).
    The divisor 127 is a tensor on ``k``'s device: divided by a Python
    number, a CUDA tensor is multiplied by its reciprocal instead, a bit
    off the true quotient the CPU and the reference take."""
    amax = torch.amax(torch.abs(k), dim=-1, keepdim=True)
    scale = amax / torch.full((), 127.0, dtype=amax.dtype,
                              device=amax.device) + 1e-8
    q = torch.clamp(torch.round(k / scale), -128, 127)
    return q.to(torch.int8), scale.float()


def dequantize_kv(kq: Tensor, scale: Tensor, dtype: torch.dtype) -> Tensor:
    return (kq.float() * scale).to(dtype)


def decode_slot(pos: int, window: int, S: int) -> int:
    """The cache slot a decode step at ``pos`` writes: ``pos % window`` in
    a ring (``window > 0``), else ``pos``, clamped to the cache's last."""
    slot = pos % max(window, 1) if window > 0 else pos
    return min(slot, S - 1)


def attention_decode(params: Dict[str, Tensor], x: Tensor,
                     cache: Dict[str, Tensor], pos: int, cfg: ModelConfig, *,
                     window: int = 0) -> Tuple[Tensor, Dict[str, Tensor]]:
    """One-token decode. x: (B, 1, D); cache: {k, v[, k_scale, v_scale]}
    with k/v of shape (B, Scache, K, hd), updated in place and returned.
    ``pos`` is the current position (a Python int; a 0-d tensor is read
    with ``int()``).

    For windowed layers the cache is a ring buffer of length
    W = min(S, window) indexed by pos % W; absolute positions are
    reconstructed for masking.
    """
    pos = int(pos)
    hd = cfg.resolved_head_dim
    K, H = cfg.kv_heads, cfg.n_heads
    G = H // K
    dt = x.dtype
    B = x.shape[0]
    q = _split_heads(x @ params["wq"].to(dt), H, hd)
    k_new = _split_heads(x @ params["wk"].to(dt), K, hd)
    v_new = _split_heads(x @ params["wv"].to(dt), K, hd)
    posb = torch.full((B, 1), pos, device=x.device)
    q = apply_rope(q, posb, cfg.rope_theta)
    k_new = apply_rope(k_new, posb, cfg.rope_theta)

    S = cache["k"].shape[1]
    slot = decode_slot(pos, window, S)

    if "k_scale" in cache:
        kq, ksc = quantize_kv(k_new)
        vq, vsc = quantize_kv(v_new)
        for key, new in (("k", kq), ("v", vq), ("k_scale", ksc),
                         ("v_scale", vsc)):
            SR.write_slot(cache[key], slot, new)
        k = dequantize_kv(cache["k"], cache["k_scale"], dt)
        v = dequantize_kv(cache["v"], cache["v_scale"], dt)
    else:
        SR.write_slot(cache["k"], slot, k_new)
        SR.write_slot(cache["v"], slot, v_new)
        k, v = cache["k"].to(dt), cache["v"].to(dt)

    qh = SR.reshape(q, B, 1, K, G, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qh.float(), k.float()) \
        * (hd ** -0.5)
    idx = torch.arange(S, device=x.device)
    if window > 0:
        # absolute position stored in ring slot i (a floor modulo)
        apos = pos - torch.remainder(pos - idx, max(window, 1))
        ok = (apos >= 0) & (apos <= pos) & (apos > pos - window)
    else:
        ok = idx <= pos
    s = s.masked_fill(~ok, -torch.inf)
    p = torch.softmax(s, dim=-1).to(dt)
    o = SR.reshape(torch.einsum("bkgqs,bskd->bqkgd", p, v), B, 1, H * hd)
    return o @ params["wo"].to(dt), cache


# ----------------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, cfg: ModelConfig,
             d_ff: Optional[int] = None,
             lead: Sequence[int] = ()) -> Dict[str, Tensor]:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    p = {"w_in": ninit(gen, (d, f), lead=lead),
         "w_out": ninit(gen, (f, d), scale=f ** -0.5, lead=lead)}
    if cfg.glu:
        p["w_gate"] = ninit(gen, (d, f), lead=lead)
    return p


def _act(cfg: ModelConfig, h: Tensor) -> Tensor:
    if cfg.act == "silu":
        return Fn.silu(h)
    return Fn.gelu(h, approximate="tanh")


def mlp_fwd(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig) -> Tensor:
    dt = x.dtype
    h = x @ params["w_in"].to(dt)
    if cfg.glu:
        h = _act(cfg, x @ params["w_gate"].to(dt)) * h
    else:
        h = _act(cfg, h)
    return h @ params["w_out"].to(dt)
