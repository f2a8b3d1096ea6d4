"""The port's encoder-decoder (``repro_torch.models.encdec`` and the
facade's enc-dec branches) against the reference's on the CPU, the
seamless-m4t smoke config.

Both packages get the reference's weights (``jax.random.PRNGKey``, carried
by ``convert.params_from_numpy``), and the same frames and tokens from a
seeded numpy generator. Float32 within ``rtol=1e-5, atol=1e-5 *
max|ref|``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import encdec as JE
from repro.models import model as JMD
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert as CV
from repro_torch.models import encdec as E
from repro_torch.models import model as MD
from repro_torch.models.config import ModelConfig

ARCH = "seamless-m4t-medium"
F32 = 1e-5


def _close(got, ref, tol=F32):
    got = got.detach().float().numpy()
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


def _setup(seed=0, **kw):
    jcfg = dataclasses.replace(ref_smoke_config(ARCH), **kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = JMD.init_params(jcfg, jax.random.PRNGKey(seed))
    return jcfg, cfg, jp, CV.params_from_numpy(jax.tree.map(np.asarray, jp),
                                                "cpu")


def _frames(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


def _tokens(cfg, B, S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)).astype(
        np.int32)


@pytest.mark.parametrize("S_enc", [5, 24])
def test_encode_matches_the_reference(S_enc):
    jcfg, cfg, jp, tp = _setup()
    fr = _frames(cfg, 2, S_enc)
    _close(E.encode(tp, torch.from_numpy(fr), cfg),
           JE.encode(jp, jnp.asarray(fr), jcfg))


@pytest.mark.parametrize("S_dec", [1, 7, 16])
def test_decode_train_matches_the_reference(S_dec):
    jcfg, cfg, jp, tp = _setup(seed=3)
    fr = _frames(cfg, 2, 12, seed=4)
    toks = _tokens(cfg, 2, S_dec, seed=5)
    jenc = JE.encode(jp, jnp.asarray(fr), jcfg)
    tenc = E.encode(tp, torch.from_numpy(fr), cfg)
    _close(E.decode_train(tp, tenc, torch.from_numpy(toks), cfg),
           JE.decode_train(jp, jenc, jnp.asarray(toks), jcfg))


def test_build_cross_cache_matches_the_reference():
    """Every decoder layer's cross K/V of the encoder output, stacked; the
    self K/V stay the same tensors."""
    jcfg, cfg, jp, tp = _setup(seed=6)
    fr = _frames(cfg, 3, 9, seed=7)
    jc = JE.build_cross_cache(jp, JE.encode(jp, jnp.asarray(fr), jcfg), jcfg,
                              JE.init_cache(jcfg, 3, 8, enc_len=9))
    cache = E.init_cache(cfg, 3, 8, enc_len=9, device="cpu")
    tc = E.build_cross_cache(tp, E.encode(tp, torch.from_numpy(fr), cfg), cfg,
                             cache)
    assert tc["self_k"] is cache["self_k"]
    for k in jc:
        assert tuple(tc[k].shape) == jc[k].shape, k
        if k.startswith("cross"):
            _close(tc[k], jc[k])


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_init_cache_ignores_kv_dtype_as_the_reference_does(kv):
    for dtype in ("float32", "bfloat16"):
        jcfg, cfg, _, _ = _setup(dtype=dtype)
        jc = JMD.init_cache(jcfg, 2, 6, kv_dtype=kv)
        tc = MD.init_cache(cfg, 2, 6, kv_dtype=kv, device="cpu")
        assert jc.keys() == tc.keys()
        for k, v in jc.items():
            assert tuple(tc[k].shape) == v.shape
            assert str(tc[k].dtype).removeprefix("torch.") == str(v.dtype)
            assert str(v.dtype) == dtype


def test_decode_step_matches_the_reference_and_the_prefill():
    """Teacher-forced decode_step after encode + build_cross_cache: the
    reference's logits and self K/V at every step, and the port's own
    prefill's last-position logits at every length."""
    jcfg, cfg, jp, tp = _setup(seed=8)
    B, T = 2, 10
    fr = _frames(cfg, B, 14, seed=9)
    toks = _tokens(cfg, B, T, seed=10)
    jc = JE.build_cross_cache(jp, JE.encode(jp, jnp.asarray(fr), jcfg), jcfg,
                              JE.init_cache(jcfg, B, T, enc_len=14))
    tc = E.build_cross_cache(tp, E.encode(tp, torch.from_numpy(fr), cfg), cfg,
                             E.init_cache(cfg, B, T, enc_len=14,
                                          device="cpu"))
    jstep = jax.jit(lambda p, c, t, pos: JE.decode_step(p, c, t, pos, jcfg))
    for t in range(T):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t))
        tl, tc = E.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]), t,
                               cfg)
        _close(tl, jl)
        pre, _ = MD.prefill(tp, {"frames": torch.from_numpy(fr),
                                 "tokens": torch.from_numpy(toks[:, :t + 1])},
                            cfg)
        _close(tl, pre.numpy(), tol=1e-4)
    for k in ("self_k", "self_v"):
        _close(tc[k], jc[k])


@pytest.mark.parametrize("S_dec", [1, 6])
def test_facade_prefill_matches_the_reference(S_dec):
    """model.prefill: encode, decode_train, the final norm and the head."""
    jcfg, cfg, jp, tp = _setup(seed=11)
    fr = _frames(cfg, 2, 8, seed=12)
    toks = _tokens(cfg, 2, S_dec, seed=13)
    jl, jx = JMD.prefill(jp, {"frames": jnp.asarray(fr),
                              "tokens": jnp.asarray(toks)}, jcfg)
    tl, tx = MD.prefill(tp, {"frames": torch.from_numpy(fr),
                             "tokens": torch.from_numpy(toks)}, cfg)
    assert tl.shape == (2, cfg.vocab) and tl.dtype == torch.float32
    _close(tl, jl)
    _close(tx, jx)


def test_bf16_compute_matches_the_reference():
    jcfg, cfg, jp, tp = _setup(seed=14, dtype="bfloat16")
    fr = _frames(cfg, 2, 8, seed=15)
    toks = _tokens(cfg, 2, 5, seed=16)
    jl, _ = JMD.prefill(jp, {"frames": jnp.asarray(fr),
                             "tokens": jnp.asarray(toks)}, jcfg)
    tl, tx = MD.prefill(tp, {"frames": torch.from_numpy(fr),
                             "tokens": torch.from_numpy(toks)}, cfg)
    assert tx.dtype == torch.bfloat16
    _close(tl, jl, tol=2.0 ** -6)


def test_init_params_is_the_references_tree():
    cfg = get_smoke_config(ARCH)
    jp = JMD.init_params(ref_smoke_config(ARCH), jax.random.PRNGKey(0))
    tp = MD.init_params(cfg, torch.Generator().manual_seed(0))
    jflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_leaves_with_path(jp)}
    tflat = {jax.tree_util.keystr(k): v
             for k, v in jax.tree_util.tree_leaves_with_path(tp)}
    assert jflat.keys() == tflat.keys()
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == v.shape, k
    assert tp["enc"]["mlp"]["w_in"].shape[0] == cfg.enc_layers
    assert "w_gate" not in tp["dec"]["mlp"]
