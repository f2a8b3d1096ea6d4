"""The port's RG-LRU block (``repro_torch.models.rglru``) against the
reference's (``repro.models.rglru``) on the CPU.

Both packages get the reference's weights (``init_rec`` on a
``jax.random.PRNGKey``, carried by ``convert.params_from_numpy``) and the
same inputs from a seeded numpy generator. Float32 within ``rtol=1e-5,
atol=1e-5 * max|ref|``. The port's doubling scan stands where the
reference has ``jax.lax.associative_scan``: the same recurrence, summed in
another order.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import rglru as JR
from repro_torch.models import convert as CV
from repro_torch.models import rglru as R
from repro_torch.models.config import ModelConfig

F32 = 1e-5


def _close(got, ref, tol=F32):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


def _cfgs(**kw):
    jcfg = dataclasses.replace(ref_smoke_config("recurrentgemma-9b"), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp = JR.init_rec(jax.random.PRNGKey(seed), jcfg)
    return jp, CV.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _loop(a, b):
    """h_t = a_t h_{t-1} + b_t, one step at a time in float64."""
    h = np.zeros_like(b[:, 0], dtype=np.float64)
    out = []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return np.stack(out, 1)


@pytest.mark.parametrize("S_", [1, 2, 5, 16, 63, 64])
def test_scan_is_the_recurrence(S_):
    """The doubling scan against a step loop and the reference's
    associative scan, at lengths that are and are not powers of two."""
    rng = np.random.default_rng(S_)
    a = rng.random((2, S_, 6)).astype(np.float32)
    b = rng.standard_normal((2, S_, 6)).astype(np.float32)
    got = R.scan(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, _loop(a.astype(np.float64), b.astype(np.float64)))

    def combine(u, v):
        return u[0] * v[0], v[0] * u[1] + v[1]
    _, ref = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    _close(got, ref)


def test_scan_with_decays_that_underflow_stays_finite():
    """log a near -17 a step (the gate's floor, -8 softplus(2)): a running
    product of a underflows float32 within a few steps; the scan never
    divides by one, so h stays finite and equal to the loop's."""
    rng = np.random.default_rng(7)
    a = np.exp(-8.0 * np.log1p(np.exp(2.0))
               * rng.uniform(0.9, 1.0, (2, 64, 4))).astype(np.float32)
    assert np.prod(a[0, :8, 0].astype(np.float32)) == 0.0
    b = rng.standard_normal((2, 64, 4)).astype(np.float32)
    got = R.scan(torch.from_numpy(a), torch.from_numpy(b))
    assert torch.isfinite(got).all()
    _close(got, _loop(a.astype(np.float64), b.astype(np.float64)))


def test_conv_has_no_silu_and_matches_the_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    st = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for state in (None, st):
        jy, js = JR._conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                          None if state is None else jnp.asarray(state))
        ty, ts = R._conv(torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b),
                         None if state is None else torch.from_numpy(state))
        _close(ty, jy)
        _close(ts, js)
        assert (ty < 0).any()


@pytest.mark.parametrize("S_", [16, 64])
def test_rec_fwd_matches_the_reference(S_):
    """The block's prefill at the smoke window (16) and past it (64)."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    x = np.random.default_rng(4).standard_normal(
        (2, S_, cfg.d_model)).astype(np.float32)
    _close(R.rec_fwd(tp, torch.from_numpy(x), cfg),
           JR.rec_fwd(jp, jnp.asarray(x), jcfg))


def test_rec_decode_carries_the_references_state():
    """64 single-token steps: the reference's outputs and cache, and the
    port's own prefill's outputs."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    B, T = 2, 64
    x = np.random.default_rng(5).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    jc = JR.rec_init_cache(jcfg, B, jnp.float32)
    tc = R.rec_init_cache(cfg, B, torch.float32, torch.device("cpu"))
    assert jc.keys() == tc.keys()
    jys, tys = [], []
    for t in range(T):
        jy, jc = JR.rec_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        ty, _ = R.rec_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, cfg)
        jys.append(np.asarray(jy))
        tys.append(ty)
    _close(torch.cat(tys, 1), np.concatenate(jys, 1))
    for k in jc:
        _close(tc[k], jc[k])
    _close(torch.cat(tys, 1), R.rec_fwd(tp, torch.from_numpy(x), cfg).numpy(),
           tol=1e-4)


def test_bf16_cache_keeps_a_float32_state():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    tc = R.rec_init_cache(cfg, 3, torch.bfloat16, torch.device("cpu"), (2,))
    jc = JR.rec_init_cache(jcfg, 3, jnp.bfloat16)
    assert tc["state"].dtype == torch.float32
    assert tc["conv"].dtype == torch.bfloat16
    assert tuple(tc["conv"].shape) == (2, *jc["conv"].shape)
    assert tuple(tc["state"].shape) == (2, *jc["state"].shape)


def test_init_rec_is_the_references_tree():
    jcfg, cfg = _cfgs()
    jp = JR.init_rec(jax.random.PRNGKey(0), jcfg)
    tp = R.init_rec(torch.Generator().manual_seed(0), cfg)
    assert jp.keys() == tp.keys()
    for k, v in jp.items():
        assert tuple(tp[k].shape) == v.shape and tp[k].dtype == torch.float32
        ref_std = float(jnp.std(v))
        if ref_std:
            assert abs(float(tp[k].std()) / ref_std - 1) < 0.2, k
    _close(tp["lam"], jp["lam"])
    _close(tp["conv_b"], jp["conv_b"])
