"""Mixture-of-Experts layer: top-k routing, sort dispatch (the port of
``repro.models.moe``).

The token stream is reshaped to (G, n_loc, D), G the data-shard count of
the sharding scope (``dp_world()``, 1 outside one), as in the reference:
each data shard dispatches its own n_loc tokens at its own capacity, so
the same tokens drop as in the reference's vmapped groups. Under sharding
rules the sort dispatch and the combine run on each rank's own groups
(:func:`repro_torch.sharding.rules.local`), and the expert GEMMs on its
own experts: the collectives are the expert weights' gather a layer and
the expert outputs' gather over the model axis before the combine, not
the dispatch buffers. The expert GEMMs are batched matmuls over the
experts.

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

from repro_torch.sharding import rules as SR

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


def _route_groups(probs: Tensor, k: int) -> Tuple[Tensor, Tensor]:
    """:func:`route` of (g, n, E) probabilities, one token a row."""
    gate, idx = route(probs.reshape(-1, probs.shape[-1]), k)
    return (gate.reshape(*probs.shape[:-1], k),
            idx.reshape(*probs.shape[:-1], k))


def _dispatch_groups(E: int, C: int, K: int):
    """fn(xg (g, n, D), gate (g, n, K), eid (g, n, K)) -> (h_in (g, E, C,
    D), the g groups' combine metadata): the dispatch of each group."""
    def fn(xg, gate, eid):
        outs = [_local_dispatch(xg[i], gate[i], eid[i], E, C, K)
                for i in range(xg.shape[0])]
        return torch.stack([h for h, _ in outs]), [m for _, m in outs]
    return fn


def _combine_groups(n: int, metas):
    """fn(h_out (g, E, C, D)) -> y (g, n, D): the combine of each group."""
    def fn(h_out):
        return torch.stack([_local_combine(h, m, n)
                            for h, m in zip(h_out, metas)])
    return fn


def _counts(eid: Tensor, E: int) -> Tensor:
    """(E,) float32: the assignments to each expert in ``eid``."""
    return torch.zeros((E,), dtype=torch.float32, device=eid.device
                       ).index_add_(0, eid.reshape(-1), torch.ones(
                           (eid.numel(),), dtype=torch.float32,
                           device=eid.device))


def moe_fwd(params: Dict[str, Tensor], x: Tensor, cfg: ModelConfig, *,
            dropless: bool = False) -> Tuple[Tensor, Tensor]:
    """x: (B, S, D) -> (out, aux_loss), the load-balance loss of Switch.

    ``dropless=False`` (training) drops tokens over a group's expert
    capacity. Inference passes ``dropless=True``: the capacity is the
    group's token count rounded up to 8 (a token routes to K distinct
    experts, so an expert takes at most one assignment a token), and a
    token's output does not depend on how the other positions route.
    """
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.topk
    N = B * S
    dt = x.dtype
    G = SR.dp_world()
    if B % G or N % G:
        G = 1
    n_loc = N // G
    C = max(8, -(-n_loc // 8) * 8) if dropless else capacity(n_loc, cfg)

    xg = SR.constrain(SR.reshape(x, G, n_loc, D), "moe_group")
    logits = (xg @ params["router"].to(dt)).float()
    probs = torch.softmax(logits, dim=-1)                 # (G, n, E)
    gate_vals, expert_idx = SR.local(
        lambda p: _route_groups(p, K), [SR.constrain(probs, "moe_g1")],
        [("moe_g1", (G, n_loc, K))] * 2)
    gate_vals = gate_vals.to(dt)

    # load-balance auxiliary loss (Switch eq. 4): E * sum_e f_e * p_e
    me = probs.mean(dim=(0, 1))
    ce = SR.local(lambda e: _counts(e, E), [expert_idx], [("sum", (E,))]
                  )[0] / (N * K)
    aux = E * torch.sum(me * ce)

    h_in, metas = SR.local(_dispatch_groups(E, C, K),
                           [xg, gate_vals, expert_idx],
                           [("moe_g1", (G, E, C, D)), None])
    h_in = SR.constrain(h_in, "moe_gbuf")                 # (G, E, C, D)
    w_in = SR.constrain(params["w_in"].to(dt), "moe_w_in")
    w_out = SR.constrain(params["w_out"].to(dt), "moe_w_out")
    h = torch.einsum("gecd,edf->gecf", h_in, w_in)
    if cfg.glu:
        w_gate = SR.constrain(params["w_gate"].to(dt), "moe_w_in")
        h = L._act(cfg, torch.einsum("gecd,edf->gecf", h_in, w_gate)) * h
    else:
        h = L._act(cfg, h)
    h_out = SR.constrain(torch.einsum("gecf,efd->gecd", h, w_out),
                         "moe_gbuf")
    # each group's combine reads all its experts' outputs
    y, = SR.local(_combine_groups(n_loc, metas),
                  [SR.constrain(h_out, "moe_g1")], [("moe_g1", (G, n_loc, D))])
    y = SR.constrain(y, "moe_group")
    return SR.reshape(y, B, S, D), aux
