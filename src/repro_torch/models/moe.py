"""Mixture-of-Experts layer: top-k routing, sort dispatch (the port of
``repro.models.moe``).

The reference reshapes the token stream to (G, n_loc, D), G the data-shard
count of its sharding scope, and vmaps the dispatch over G. The port has
no sharding scope yet (ROADMAP queue 1 item 13e), where the reference's
``dp_world()`` is 1: here G = 1 and the dispatch runs over all B * S
tokens. The expert GEMMs are batched matmuls over the experts.

Routing (:func:`route`) breaks a tie between two router probabilities
toward the lower expert, as ``jax.lax.top_k`` does (``torch.topk`` makes
no promise on the card). Tokens over an expert's capacity are dropped to
the residual stream; the dropped slots go to one spare row of the
dispatch buffer, which is cut off, so no write lands past its end. The
combine sums each token's K expert outputs with ``index_add_``, which is
atomic on the card: it matches the CPU to a tolerance, not bit for bit.
Nothing here reads a tensor back to the host: the capacity is a Python
int from the token count.
"""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch

from . import layers as L
from .config import ModelConfig

Tensor = torch.Tensor


def init_moe(gen: torch.Generator, cfg: ModelConfig,
             lead: Sequence[int] = ()) -> Dict[str, Tensor]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
    p = {"router": L.ninit(gen, (d, e), lead=lead),
         "w_in": L.ninit(gen, (e, d, f), lead=lead),
         "w_out": L.ninit(gen, (e, f, d), scale=f ** -0.5, lead=lead)}
    if cfg.glu:
        p["w_gate"] = L.ninit(gen, (e, d, f), lead=lead)
    return p


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(n_tokens * cfg.topk / cfg.n_experts * cfg.capacity_factor)
    # multiple of 8, as the reference's (its shards tile cleanly)
    return max(8, -(-c // 8) * 8)


def route(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """The ``k`` most probable experts of each token, ties to the lower
    index: (their probabilities renormalised to sum 1, float32; their
    indices, int64), each (..., k)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate, idx = vals[..., :k], idx[..., :k]
    return gate / (gate.sum(-1, keepdim=True) + 1e-9), idx


def _local_dispatch(xl: Tensor, gate_l: Tensor, eid_l: Tensor, E: int,
                    C: int, K: int):
    """xl: (n, D); gate / eid: (n, K). Returns (h_in (E, C, D), the
    combine's metadata)."""
    n, D = xl.shape
    eids = eid_l.reshape(-1)                              # (n*K,)
    order = torch.argsort(eids, stable=True)
    sorted_eids = eids[order]
    tok_of = order // K
    gate_of = gate_l.reshape(-1)[order]
    first = torch.searchsorted(sorted_eids, sorted_eids, side="left")
    slot = torch.arange(n * K, device=xl.device) - first
    keep = slot < C
    dst = torch.where(keep, sorted_eids * C + slot, E * C)  # E*C: dropped
    buf = torch.zeros((E * C + 1, D), dtype=xl.dtype, device=xl.device)
    buf[dst] = xl[tok_of]
    return buf[:E * C].reshape(E, C, D), (tok_of, gate_of, keep, dst)


def _local_combine(h_out: Tensor, meta, n: int) -> Tensor:
    """h_out: (E, C, D) -> y (n, D)."""
    tok_of, gate_of, keep, dst = meta
    E, C, D = h_out.shape
    flat = h_out.reshape(E * C, D)
    src = torch.where(keep, dst, 0)
    contrib = flat[src] * (gate_of * keep).to(h_out.dtype)[:, None]
    y = torch.zeros((n, D), dtype=h_out.dtype, device=h_out.device)
    return y.index_add_(0, tok_of, contrib)


def moe_fwd(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig, *,
            dropless: bool = False) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux_loss), the load-balance loss of Switch.

    ``dropless=False`` (training) drops tokens over expert capacity.
    Inference passes ``dropless=True``: the capacity is the token count
    rounded up to 8 (a token routes to K distinct experts, so an expert
    takes at most one assignment a token), and a token's output does not
    depend on how the other positions route.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    N = B * S
    dt = x.dtype
    C = max(8, -(-N // 8) * 8) if dropless else capacity(N, cfg)

    xg = x.reshape(N, D)
    logits = (xg @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                 # (N, E)
    gate_vals, expert_idx = route(probs, K)               # (N, K)
    gate_vals = gate_vals.to(dt)

    # load-balance auxiliary loss (Switch eq. 4): E * sum_e f_e * p_e
    me = probs.mean(dim=0)
    ce = torch.zeros((E,), dtype=torch.float32, device=x.device).index_add_(
        0, expert_idx.reshape(-1),
        torch.ones((N * K,), dtype=torch.float32, device=x.device)) / (N * K)
    aux = E * torch.sum(me * ce)

    h_in, meta = _local_dispatch(xg, gate_vals, expert_idx, E, C, K)
    h = torch.bmm(h_in, params["w_in"].to(dt))            # (E, C, F)
    if cfg.glu:
        h = L._act(cfg, torch.bmm(h_in, params["w_gate"].to(dt))) * h
    else:
        h = L._act(cfg, h)
    h_out = torch.bmm(h, params["w_out"].to(dt))          # (E, C, D)
    y = _local_combine(h_out, meta, N)
    return y.reshape(B, S, D), aux
