"""The port's MoE layer (``repro_torch.models.moe``) against the reference's
(``repro.models.moe``) on the CPU.

Both packages get the reference's weights (``init_moe`` on a
``jax.random.PRNGKey``, carried by ``convert.params_from_numpy``) and the
same activations from a seeded numpy generator. Float32 outputs and aux
losses within ``rtol=1e-5, atol=1e-5 * max|ref|``; routing indices,
dispatch slots and kept flags equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro.models.config import ModelConfig as JConfig
from repro_torch.models import convert as CV
from repro_torch.models import moe as M
from repro_torch.models.config import ModelConfig

F32 = 1e-5

BASE = dict(name="moe-test", family="moe", n_layers=1, d_model=32, n_heads=4,
            kv_heads=2, d_ff=24, vocab=256, n_experts=6, topk=2,
            dtype="float32")


def _cfgs(**kw):
    args = {**BASE, **kw}
    return JConfig(**args), ModelConfig(**args)


def _close(got, ref, tol=F32):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


def _params(jcfg, seed=0):
    jp = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    return jp, CV.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(B, S, D, seed=1):
    return np.random.default_rng(seed).standard_normal((B, S, D)).astype(
        np.float32)


@pytest.mark.parametrize("dropless", [True, False])
@pytest.mark.parametrize("glu,act", [(True, "silu"), (False, "silu"),
                                     (True, "gelu"), (False, "gelu")])
def test_moe_fwd_matches_the_reference(glu, act, dropless):
    """Output and Switch aux loss, dropless (inference) and at the
    capacity factor (training), GLU on and off, SiLU and GELU."""
    jcfg, cfg = _cfgs(glu=glu, act=act)
    jp, tp = _params(jcfg)
    x = _x(2, 16, BASE["d_model"])
    jy, jaux = JM.moe_fwd(jp, jnp.asarray(x), jcfg, dropless=dropless)
    ty, taux = M.moe_fwd(tp, torch.from_numpy(x), cfg, dropless=dropless)
    assert ty.shape == jy.shape and ty.dtype == torch.float32
    assert "w_gate" in tp if glu else "w_gate" not in tp
    _close(ty, jy)
    assert float(taux) == pytest.approx(float(jaux), rel=F32)


@pytest.mark.parametrize("factor", [0.25, 0.5, 1.0])
def test_a_capacity_that_drops_matches_the_reference(factor):
    """Capacity under the demand: the same tokens dropped to the residual
    (their expert slots left empty), the same buffer, and the same
    output; the dropped slots go to the spare row, not past the end."""
    jcfg, cfg = _cfgs(capacity_factor=factor, n_experts=4, topk=2)
    jp, tp = _params(jcfg, seed=2)
    x = _x(2, 24, BASE["d_model"], seed=3)
    N, E, K = 48, 4, 2
    C = M.capacity(N, cfg)
    assert C == JM.capacity(N, jcfg)
    probs = jax.nn.softmax(jnp.asarray(x.reshape(N, -1))
                           @ jp["router"], axis=-1)
    jg, je = jax.lax.top_k(probs, K)
    tg, te = M.route(torch.from_numpy(np.array(probs)), K)
    assert np.array_equal(te.numpy(), np.asarray(je))
    jbuf, (jtok, _, jkeep, jdst) = JM._local_dispatch(
        jnp.asarray(x.reshape(N, -1)), jg, je, E, C, K)
    tbuf, (ttok, _, tkeep, tdst) = M._local_dispatch(
        torch.from_numpy(x.reshape(N, -1)), tg, te, E, C, K)
    assert tbuf.shape == (E, C, BASE["d_model"])
    np.testing.assert_array_equal(tbuf.numpy(), np.asarray(jbuf))
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tkeep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(tdst.numpy(), np.asarray(jdst))
    dropped = int((~tkeep).sum())
    assert dropped > 0 and int(tdst.max()) == E * C
    jy, jaux = JM.moe_fwd(jp, jnp.asarray(x), jcfg)
    ty, taux = M.moe_fwd(tp, torch.from_numpy(x), cfg)
    _close(ty, jy)
    assert float(taux) == pytest.approx(float(jaux), rel=F32)


def test_dropless_never_drops_and_keeps_each_token_its_own():
    """Dropless, a token's output does not depend on the other tokens: the
    batch's rows equal each token run alone."""
    _, cfg = _cfgs()
    _, tp = _params(_cfgs()[0], seed=4)
    x = torch.from_numpy(_x(1, 20, BASE["d_model"], seed=5))
    y, _ = M.moe_fwd(tp, x, cfg, dropless=True)
    for s in (0, 7, 19):
        alone, _ = M.moe_fwd(tp, x[:, s:s + 1], cfg, dropless=True)
        _close(y[:, s], alone[:, 0].numpy())


def test_route_breaks_ties_to_the_lower_expert_as_top_k_does():
    probs = np.array([[0.2, 0.3, 0.3, 0.2],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4]], np.float32)
    jg, je = jax.lax.top_k(jnp.asarray(probs), 2)
    tg, te = M.route(torch.from_numpy(probs), 2)
    assert te.tolist() == np.asarray(je).tolist() == [[1, 2], [0, 1],
                                                       [1, 3]]
    jg = np.asarray(jg)
    np.testing.assert_allclose(tg.numpy(),
                               jg / (jg.sum(-1, keepdims=True) + 1e-9))


@pytest.mark.parametrize("n", [1, 4, 9, 64, 1000])
def test_capacity_matches_the_reference(n):
    for jcfg, cfg in (_cfgs(), _cfgs(capacity_factor=0.3, n_experts=40,
                                     topk=8)):
        assert M.capacity(n, cfg) == JM.capacity(n, jcfg)


def test_init_moe_is_the_references_tree():
    for glu in (True, False):
        jcfg, cfg = _cfgs(glu=glu)
        jp = JM.init_moe(jax.random.PRNGKey(0), jcfg)
        tp = M.init_moe(torch.Generator().manual_seed(0), cfg, (3,))
        assert jp.keys() == tp.keys()
        for k, v in jp.items():
            assert tuple(tp[k].shape) == (3, *v.shape), k
            assert abs(float(tp[k].std()) / float(jnp.std(v)) - 1) < 0.2, k


def test_bf16_compute_matches_the_reference():
    """bfloat16 activations and weights cast per matmul: within 2**-6 of
    max|ref|, the router's top-k on the same bf16 logits."""
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp, tp = _params(jcfg, seed=6)
    x = _x(2, 8, BASE["d_model"], seed=7)
    jy, _ = JM.moe_fwd(jp, jnp.asarray(x, jnp.bfloat16), jcfg, dropless=True)
    ty, _ = M.moe_fwd(tp, torch.from_numpy(x).to(torch.bfloat16), cfg,
                      dropless=True)
    assert ty.dtype == torch.bfloat16
    _close(ty, np.asarray(jy, np.float32), tol=2.0 ** -6)


def test_port_config_has_the_references_fields():
    assert [f.name for f in dataclasses.fields(ModelConfig)] == \
        [f.name for f in dataclasses.fields(JConfig)]


@pytest.mark.parametrize("train", [False, True])
def test_backbone_sums_the_aux_losses_as_the_reference(train):
    """The decoder's backbone returns the sum of its MoE blocks' aux
    losses; ``train`` drops tokens over capacity, prefill runs dropless."""
    from repro.configs import get_smoke_config as ref_smoke_config
    from repro.models import model as JMD
    from repro.models import transformer as JT
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as T
    jcfg = ref_smoke_config("granite-moe-3b-a800m")
    cfg = get_smoke_config("granite-moe-3b-a800m")
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(8))
    tp = CV.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = _x(2, 16, cfg.d_model, seed=9)
    jx, jaux = JT.backbone(jp, jnp.asarray(x), jcfg, train=train)
    tx, taux = T.backbone(tp, torch.from_numpy(x), cfg, train=train)
    _close(tx, jx)
    assert float(taux) == pytest.approx(float(jaux), rel=F32)
    assert float(taux) > 0
