"""The port's train step on the CPU against the reference's:
``make_train_step`` on identical gradients, its metrics, its purity,
gradient accumulation and sharding rules on one rank.

Tolerances: losses and metrics within 1e-5 of themselves
(``tests/torch_train_parity.py``), an AdamW update of identical gradients
within 1e-6 of each leaf's max.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert as CV
from repro_torch.models import transformer as T
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.loop import device_batch
from repro_torch.train.step import make_train_step, value_and_grad
from torch_train_parity import TOL, flat, reference

UPDATE_TOL = 1e-6


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves_close(got, ref, tol):
    got, ref = flat(got), flat(_np(ref))
    assert set(got) == set(ref)
    for path, r in ref.items():
        g = got[path].detach().numpy()
        m = max(float(np.abs(r).max()), 1e-30)
        assert float(np.abs(g - r).max()) <= tol * m, path


# ----------------------------------------------------------------------------
# make_train_step
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "granite-moe-3b-a800m",
                                  "seamless-m4t-medium"])
def test_one_step_matches_the_references_on_identical_grads(arch):
    """The reference's jitted step and the port's on the same params,
    state and batch: every metric within ``TOL``; then the port's AdamW on
    the reference's own gradients gives the reference step's new params
    and state within ``UPDATE_TOL`` (the port's own gradients differ by
    float noise, which AdamW's first step can turn into 2 lr on an entry
    whose gradient is noise: those are held in the loss files)."""
    jp, batch, (_, jg) = reference(arch)
    jcfg = ref_smoke_config(arch)
    opt = dict(lr=1e-3, weight_decay=0.1)
    jstep = jax.jit(j_make_train_step(jcfg, JAdamWConfig(**opt)))
    jnew, jopt, jm = jstep(jp, j_adamw_init(jp),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    cfg = get_smoke_config(arch)
    tp = CV.params_from_numpy(_np(jp), "cpu")
    tnew, topt, tm = make_train_step(cfg, AdamWConfig(**opt))(
        tp, adamw_init(tp), device_batch(batch, "cpu"))
    assert set(tm) == set(jm)
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=TOL,
                                             abs=1e-12), k
    assert int(topt["step"]) == int(jopt["step"]) == 1
    unew, uopt, _ = adamw_update(tp, CV.params_from_numpy(_np(jg), "cpu"),
                                 adamw_init(tp), AdamWConfig(**opt))
    _leaves_close(unew, jnew, UPDATE_TOL)
    _leaves_close(uopt["m"], jopt["m"], UPDATE_TOL)
    _leaves_close(uopt["v"], jopt["v"], UPDATE_TOL)


def _setup(arch="yi-6b", seq=32, batch=4):
    from repro_torch.data.synthetic import SyntheticLM
    from repro_torch.models import model as MD
    cfg = get_smoke_config(arch)
    params = MD.init_params(cfg, torch.Generator().manual_seed(0))
    b = device_batch(SyntheticLM(cfg, seq, batch).batch(0), "cpu")
    return cfg, params, b


def test_the_step_is_pure_and_is_value_and_grad_then_adamw():
    """The step leaves params, state and batch as they were, returns
    detached trees, and is ``value_and_grad`` + ``adamw_update`` bit for
    bit."""
    cfg, params, b = _setup()
    opt = adamw_init(params)
    snap = [t.clone() for t in CV.tree_leaves({"p": params, "o": opt,
                                               "b": b})]
    ocfg = AdamWConfig(lr=1e-3)
    new, nopt, m = make_train_step(cfg, ocfg)(params, opt, b)
    after = CV.tree_leaves({"p": params, "o": opt, "b": b})
    assert all(torch.equal(x, y) for x, y in zip(snap, after))
    assert not any(t.requires_grad for t in CV.tree_leaves(new))
    assert not any(t.requires_grad for t in m.values())
    (loss, _), g = value_and_grad(cfg)(params, b)
    p2, o2, _ = adamw_update(params, g, opt, ocfg)
    assert float(loss) == float(m["loss"])
    assert all(torch.equal(x, y) for x, y in
               zip(CV.tree_leaves(new), CV.tree_leaves(p2)))
    assert all(torch.equal(x, y) for x, y in
               zip(CV.tree_leaves(nopt), CV.tree_leaves(o2)))
    # two steps from the same inputs give the same result
    again, _, _ = make_train_step(cfg, ocfg)(params, opt, b)
    assert all(torch.equal(x, y) for x, y in
               zip(CV.tree_leaves(new), CV.tree_leaves(again)))


def test_accum_equivalence():
    """accum_steps=2 must match accum=1 on the same global batch (up to
    numerical noise from the loss averaging), as in the reference's
    test."""
    cfg, params, b = _setup()
    opt = adamw_init(params)
    p1, _, m1 = make_train_step(cfg, AdamWConfig(lr=1e-3),
                                accum_steps=1)(params, opt, b)
    p2, _, m2 = make_train_step(cfg, AdamWConfig(lr=1e-3),
                                accum_steps=2)(params, opt, b)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-3)
    np.testing.assert_allclose(p1["embed"].numpy(), p2["embed"].numpy(),
                               atol=5e-3)


@pytest.mark.parametrize("accum", [2, 4])
def test_accum_matches_the_references_accum(accum):
    """The port's accumulated step against the reference's: the averaged
    metrics within ``TOL``."""
    jcfg = ref_smoke_config("yi-6b")
    from repro.data.synthetic import SyntheticLM as JSyntheticLM
    from repro.models import model as JMD
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(2))
    batch = JSyntheticLM(jcfg, 16, 4, seed=2).batch(0)
    _, _, jm = jax.jit(j_make_train_step(
        jcfg, JAdamWConfig(lr=1e-3), accum_steps=accum))(
        jp, j_adamw_init(jp), {k: jnp.asarray(v) for k, v in batch.items()})
    tp = CV.params_from_numpy(_np(jp), "cpu")
    _, _, tm = make_train_step(get_smoke_config("yi-6b"),
                               AdamWConfig(lr=1e-3), accum_steps=accum)(
        tp, adamw_init(tp), device_batch(batch, "cpu"))
    for k in jm:
        assert float(tm[k]) == pytest.approx(float(jm[k]), rel=TOL,
                                             abs=1e-12), k


def test_rules_are_refused_naming_13e():
    """``rules=`` on one rank builds a step: on a one-rank gloo group's 1x1
    mesh, the FSDP step and the ``cast_once`` step give ``rules=None``'s
    loss, metrics and new params (the params and state DTensors laid out
    by the rules, and kept so)."""
    import torch.distributed as dist
    from repro_torch.launch import mesh as LM
    from repro_torch.sharding import rules as SR
    cfg, params, b = _setup()
    ocfg = AdamWConfig(lr=1e-3)
    make_train_step(cfg, ocfg, cast_once=True)   # no rules: no-op
    want, _, wm = make_train_step(cfg, ocfg)(params, adamw_init(params), b)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        rules = SR.make_rules(LM.make_test_mesh((1, 1)))
        dp = rules.place_params(params)
        for cast_once in (False, True):
            new, nopt, m = make_train_step(cfg, ocfg, rules,
                                           cast_once=cast_once)(
                dp, adamw_init(dp), rules.place_batch(b))
            for k in wm:
                assert float(m[k]) == pytest.approx(float(wm[k]), rel=TOL,
                                                    abs=1e-12), k
            for x, y, p in zip(CV.tree_leaves(new), CV.tree_leaves(want),
                               CV.tree_leaves(dp)):
                assert SR.is_dtensor(x) and x.placements == p.placements
                m_ = float(y.abs().max())
                assert float((x.full_tensor() - y).abs().max()) <= \
                    UPDATE_TOL * m_
    finally:
        dist.destroy_process_group()


def test_an_unknown_remat_policy_raises():
    cfg, params, b = _setup()
    with pytest.raises(KeyError):
        value_and_grad(cfg, "sometimes")(params, b)


def test_units_are_taken_apart_by_one_unbind():
    """``_unstack`` gives the units as views of one ``unbind`` and the
    reference's ``v[u]`` values."""
    t = {"a": torch.randn(3, 8, requires_grad=True),
         "b": {"c": torch.randn(3, 2, requires_grad=True)}}
    units = T._unstack(t, 3)
    assert len(units) == 3 and T._unstack(t, 0) == []
    for u in range(3):
        assert torch.equal(units[u]["a"], t["a"][u])
        assert torch.equal(units[u]["b"]["c"], t["b"]["c"][u])
        # one backward node for all units: the gradients stack once
        assert units[u]["a"].grad_fn is units[0]["a"].grad_fn
        assert "Unbind" in units[u]["a"].grad_fn.name()
