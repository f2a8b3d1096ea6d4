"""The training path's layers under autograd on the CPU, against the
reference's ``jax.grad``: ``chunked_ce_loss``, ``flash_attention`` past
``PLAIN_ATTN_MAX`` (a checkpoint a q block), the capacity-dropping MoE
(gradients through the dispatch write and the ``index_add_`` combine),
and the SSD's gradient where ``exp`` overflows.

Tolerances: losses within 1e-5 of themselves, gradients within 1e-5 of
each leaf's max|g| (``tests/torch_train_parity.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as JL
from repro.models import moe as JM
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JConfig
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert as CV
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import ssm as SS
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from torch_train_parity import TOL, grads_close


def _np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------------------------
# chunked_ce_loss, flash attention, MoE capacity dropping, SSD
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,chunk", [(250, 8), (256, 32), (200, 512)])
def test_chunked_ce_loss_and_grads_match_the_reference(vocab, chunk):
    """Padded vocab masked, labels of -1 left out and labels past the vocab
    clipped, over several chunks: loss and its gradients in h and head."""
    jcfg = dataclasses.replace(ref_smoke_config("yi-6b"), vocab=vocab)
    cfg = dataclasses.replace(get_smoke_config("yi-6b"), vocab=vocab)
    rng = np.random.default_rng(vocab)
    B, S, D = 2, 32, cfg.d_model
    h = rng.standard_normal((B, S, D)).astype(np.float32)
    head = (rng.standard_normal((D, cfg.vocab_padded)) * 0.1).astype(
        np.float32)
    labels = rng.integers(-1, vocab + 5, (B, S)).astype(np.int32)
    jl, (jgh, jgw) = jax.value_and_grad(
        lambda h_, w_: JT.chunked_ce_loss(h_, w_, jnp.asarray(labels), jcfg,
                                          chunk), argnums=(0, 1))(
        jnp.asarray(h), jnp.asarray(head))
    th = torch.from_numpy(h).requires_grad_(True)
    tw = torch.from_numpy(head).requires_grad_(True)
    tl = T.chunked_ce_loss(th, tw, torch.from_numpy(labels), cfg, chunk)
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=TOL)
    grads_close({"h": th.grad, "w": tw.grad}, {"h": jgh, "w": jgw})


def test_chunked_ce_loss_of_no_valid_label_is_zero():
    cfg = get_smoke_config("yi-6b")
    h = torch.randn(1, 8, cfg.d_model, requires_grad=True)
    loss = T.chunked_ce_loss(h, torch.randn(cfg.d_model, cfg.vocab_padded),
                             torch.full((1, 8), -1, dtype=torch.int32), cfg)
    loss.backward()
    assert float(loss.detach()) == 0.0 and not h.grad.any()


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 700),
                                          (False, 0)])
def test_flash_attention_grads_match_the_reference(causal, window):
    """Past ``PLAIN_ATTN_MAX`` (2,048 positions, 1,024-blocks), small
    width: the port's checkpointed q blocks against ``jax.grad`` of the
    reference's scan, and against the port's plain attention."""
    rng = np.random.default_rng(7)
    B, S, H, D = 1, 2 * L.FLASH_QB, 2, 8
    assert S > L.PLAIN_ATTN_MAX
    q, k, v = (rng.standard_normal((B, S, H, D)).astype(np.float32)
               for _ in range(3))
    w = rng.standard_normal((B, S, H, D)).astype(np.float32)

    def jloss(q_, k_, v_):
        o = JL.flash_attention(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(o * jnp.asarray(w))
    jl, jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    tl = torch.sum(L.flash_attention(*ts, causal=causal, window=window)
                   * torch.from_numpy(w))
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=TOL)
    grads_close({n: t.grad for n, t in zip("qkv", ts)},
                dict(zip("qkv", jg)))
    ps = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    torch.sum(L.plain_attention(*ps, causal=causal, window=window)
              * torch.from_numpy(w)).backward()
    grads_close({n: t.grad for n, t in zip("qkv", ts)},
                {n: t.grad.numpy() for n, t in zip("qkv", ps)})


BASE = dict(name="moe", family="moe", n_layers=1, d_model=16, n_heads=2,
            kv_heads=2, d_ff=24, vocab=64, n_experts=4, topk=2,
            dtype="float32")


@pytest.mark.parametrize("factor", [0.25, 0.5, 1.25])
def test_moe_capacity_dropping_grads_match_the_reference(factor):
    """``dropless=False`` at capacities that drop tokens: gradients reach
    the params and x through the dispatch write (``buf[dst] = ...``) and
    the ``index_add_`` combine as through the reference's ``.at[].set``
    and ``.at[].add``; dropped slots give none."""
    args = {**BASE, "capacity_factor": factor}
    jcfg, cfg = JConfig(**args), ModelConfig(**args)
    jp = JM.init_moe(jax.random.PRNGKey(3), jcfg)
    x = np.random.default_rng(4).standard_normal((2, 16, 16)).astype(
        np.float32)
    w = np.random.default_rng(5).standard_normal((2, 16, 16)).astype(
        np.float32)

    def jloss(p, x_):
        y, aux = JM.moe_fwd(p, x_, jcfg, dropless=False)
        return jnp.sum(y * jnp.asarray(w)) + aux
    jl, (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1)))(
        jp, jnp.asarray(x))
    tp = {k: t.requires_grad_(True)
          for k, t in CV.params_from_numpy(_np(jp), "cpu").items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    y, aux = M.moe_fwd(tp, tx, cfg, dropless=False)
    tl = torch.sum(y * torch.from_numpy(w)) + aux
    tl.backward()
    assert float(tl.detach()) == pytest.approx(float(jl), rel=TOL)
    grads_close({**{k: t.grad for k, t in tp.items()}, "x": tx.grad},
                {**jgp, "x": jgx})


def test_ssd_grads_stay_finite_where_exp_overflows():
    """Decay rates that put exp(ldiff) past float32 above the diagonal: the
    port's forward equals the reference's and its gradients are finite
    (the exponent is masked before the exp, ROADMAP §3)."""
    from repro.models import ssm as JS
    rng = np.random.default_rng(0)
    B, S, H, P, N = 1, 64, 2, 4, 3
    xh = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.full((B, S, H), 4.0, np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    A = np.array([1.0, 16.0], np.float32)
    D = np.ones(H, np.float32)
    ref = np.asarray(JS.ssd_chunked(*map(jnp.asarray, (xh, dt, Bm, Cm, A, D)),
                                    S))
    ts = [torch.from_numpy(a).requires_grad_(True)
          for a in (xh, dt, Bm, Cm, A, D)]
    y = SS.ssd_chunked(*ts, S)
    np.testing.assert_allclose(y.detach().numpy(), ref, rtol=1e-5,
                               atol=1e-5 * float(np.abs(ref).max()))
    y.sum().backward()
    assert all(torch.isfinite(t.grad).all() for t in ts)
