"""The port's Mamba-2 SSD block (``repro_torch.models.ssm``) against the
reference's (``repro.models.ssm``) on the CPU.

Both packages get the reference's weights (``init_ssm`` on a
``jax.random.PRNGKey``, carried by ``convert.params_from_numpy``) and the
same inputs from a seeded numpy generator. Float32 within ``rtol=1e-5,
atol=1e-5 * max|ref|``; the intra-chunk products in bfloat16 within
``2**-6 * max|ref|`` (both packages round the same operands to bf16 and
sum in float32, in other orders).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import ssm as JS
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert as CV
from repro_torch.models import ssm as S
from repro_torch.models.config import ModelConfig

F32 = 1e-5
BF16 = 2.0 ** -6


def _close(got, ref, tol=F32):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


def _cfgs(**kw):
    jcfg = dataclasses.replace(ref_smoke_config("mamba2-370m"), **kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _params(jcfg, seed=0):
    jp = JS.init_ssm(jax.random.PRNGKey(seed), jcfg)
    return jp, CV.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _ssd_inputs(B, S, H, P, N, seed, dt_scale=0.1):
    rng = np.random.default_rng(seed)
    f = np.float32
    return (rng.standard_normal((B, S, H, P)).astype(f),
            (dt_scale * rng.random((B, S, H))).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            rng.standard_normal((B, S, N)).astype(f),
            np.linspace(1.0, 16.0, H).astype(f),
            rng.standard_normal(H).astype(f))


@pytest.mark.parametrize("intra", ["float32", "bfloat16"])
@pytest.mark.parametrize("nchunks", [1, 4])
def test_ssd_chunked_matches_the_reference(nchunks, intra):
    """S = Q (one chunk) and S = 4Q (the state carried across chunks), the
    intra-chunk products in float32 and in bfloat16."""
    Q = 8
    ins = _ssd_inputs(2, nchunks * Q, 3, 4, 5, seed=nchunks)
    ref = JS.ssd_chunked(*map(jnp.asarray, ins), Q,
                         intra_dtype=jnp.dtype(intra))
    got = S.ssd_chunked(*map(torch.from_numpy, ins), Q,
                        intra_dtype=getattr(torch, intra))
    assert got.dtype == torch.float32 and tuple(got.shape) == ref.shape
    _close(got, ref, tol=F32 if intra == "float32" else BF16)
    if intra == "bfloat16":
        f32 = S.ssd_chunked(*map(torch.from_numpy, ins), Q)
        _close(got, f32.numpy(), tol=BF16)


def test_ssd_chunked_keeps_its_chunk_assertion():
    ins = [torch.from_numpy(a) for a in _ssd_inputs(1, 12, 2, 4, 3, seed=0)]
    with pytest.raises(AssertionError):
        S.ssd_chunked(*ins, 8)


def test_a_decay_that_overflows_above_the_diagonal_stays_finite():
    """Large dt * A: exp(ldiff) is inf above the diagonal; the masked
    decay is a select, so no NaN reaches the output (a product with the
    mask would give inf * 0)."""
    ins = _ssd_inputs(1, 16, 2, 4, 3, seed=9, dt_scale=40.0)
    l = np.cumsum(ins[1][0] * -ins[4], axis=0)
    with np.errstate(over="ignore"):
        assert np.isinf(np.exp(l[:, None] - l[None, :])).any()
    ref = JS.ssd_chunked(*map(jnp.asarray, ins), 16)
    got = S.ssd_chunked(*map(torch.from_numpy, ins), 16)
    assert torch.isfinite(got).all()
    _close(got, ref)


def test_causal_conv_matches_the_reference_with_and_without_a_state():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 7, 5)).astype(np.float32)
    w = rng.standard_normal((4, 5)).astype(np.float32)
    b = rng.standard_normal(5).astype(np.float32)
    st = rng.standard_normal((2, 3, 5)).astype(np.float32)
    for state in (None, st):
        jy, js = JS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b),
                                 None if state is None else jnp.asarray(state))
        ty, ts = S._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(b),
                                None if state is None
                                else torch.from_numpy(state))
        _close(ty, jy)
        _close(ts, js)


@pytest.mark.parametrize("S_", [32, 128])
def test_ssm_fwd_matches_the_reference(S_):
    """The block's prefill at one chunk (S = ssm_chunk) and four."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=1)
    x = np.random.default_rng(4).standard_normal(
        (2, S_, cfg.d_model)).astype(np.float32)
    ref = JS.ssm_fwd(jp, jnp.asarray(x), jcfg)
    got = S.ssm_fwd(tp, torch.from_numpy(x), cfg)
    _close(got, ref)


def test_ssm_decode_carries_the_references_state():
    """Token by token over 40 steps (past one chunk): the outputs and the
    cache (f32 state, conv states in the model dtype) the reference's
    ssm_decode gives, and the port's own prefill's outputs."""
    jcfg, cfg = _cfgs()
    jp, tp = _params(jcfg, seed=2)
    B, T = 2, 40
    x = np.random.default_rng(5).standard_normal(
        (B, T, cfg.d_model)).astype(np.float32)
    jc = JS.ssm_init_cache(jcfg, B, jnp.float32)
    tc = S.ssm_init_cache(cfg, B, torch.float32, torch.device("cpu"))
    assert jc.keys() == tc.keys()
    jys, tys = [], []
    for t in range(T):
        jy, jc = JS.ssm_decode(jp, jnp.asarray(x[:, t:t + 1]), jc, jcfg)
        ty, tc2 = S.ssm_decode(tp, torch.from_numpy(x[:, t:t + 1]), tc, cfg)
        assert tc2 is tc
        jys.append(np.asarray(jy))
        tys.append(ty)
    _close(torch.cat(tys, 1), np.concatenate(jys, 1))
    for k in jc:
        assert tc[k].dtype == torch.float32
        _close(tc[k], jc[k])
    assert tuple(tc["state"].shape) == (B, cfg.ssm_heads, cfg.ssm_state,
                                        cfg.ssm_head_dim)
    pre = S.ssm_fwd(tp, torch.from_numpy(x[:, :32]), cfg)
    _close(torch.cat(tys[:32], 1), pre.numpy(), tol=1e-4)


def test_bf16_cache_keeps_a_float32_state():
    jcfg, cfg = _cfgs(dtype="bfloat16")
    jp, tp = _params(jcfg, seed=3)
    jc = JS.ssm_init_cache(jcfg, 2, jnp.bfloat16)
    tc = S.ssm_init_cache(cfg, 2, torch.bfloat16, torch.device("cpu"))
    x = np.random.default_rng(6).standard_normal((2, 1, cfg.d_model)).astype(
        np.float32)
    jy, jc = JS.ssm_decode(jp, jnp.asarray(x, jnp.bfloat16), jc, jcfg)
    ty, tc = S.ssm_decode(tp, torch.from_numpy(x).to(torch.bfloat16), tc, cfg)
    assert tc["state"].dtype == torch.float32
    assert tc["conv_x"].dtype == torch.bfloat16
    _close(ty, np.asarray(jy, np.float32), tol=BF16)
    _close(tc["state"], jc["state"], tol=BF16)


def test_init_ssm_is_the_references_tree():
    jcfg, cfg = _cfgs()
    jp = JS.init_ssm(jax.random.PRNGKey(0), jcfg)
    tp = S.init_ssm(torch.Generator().manual_seed(0), cfg, (2,))
    assert jp.keys() == tp.keys()
    for k, v in jp.items():
        assert tuple(tp[k].shape) == (2, *v.shape), k
        assert tp[k].dtype == torch.float32
    for k in ("A_log", "D", "norm_scale", "conv_xb"):
        _close(tp[k][1], jp[k])
    dt = torch.nn.functional.softplus(tp["dt_bias"])
    assert float(dt.min()) >= 1e-3 * (1 - 1e-5)
    assert float(dt.max()) <= 1e-1 * (1 + 1e-5)
    assert S.init_ssm(torch.Generator().manual_seed(0), get_smoke_config(
        "mamba2-370m"))["w_x"].shape == jp["w_x"].shape
