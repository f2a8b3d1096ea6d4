"""The port's dense LM decoder (``repro_torch.models``, ``train.step``)
against the reference's (``repro.models``) on the CPU.

Every test gives both packages the same weights: the reference draws them
(``jax.random.PRNGKey``), ``jax.tree.map(np.asarray, ...)`` takes them to
the host, and ``convert.params_from_numpy`` carries them into the port
leaf for leaf. Tokens come from a seeded numpy generator.

Tolerances: float32 logits within ``rtol=1e-5, atol=1e-5 * max|ref|``
(both packages sum the same products in another order; the measured worst
is about 7e-7 of max|ref|); bfloat16 compute within ``2**-6 * max|ref|``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as ref_smoke_config
from repro.models import layers as JL
from repro.models import model as JMD
from repro.models import transformer as JT
from repro.train import step as JS
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert as CV
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import transformer as T
from repro_torch.train import step as S

DENSE = ("yi-6b", "gemma-2b", "glm4-9b", "deepseek-67b", "internvl2-26b")
UNPORTED = {"phi3.5-moe-42b-a6.6b": "13a", "granite-moe-3b-a800m": "13a",
            "mamba2-370m": "13b", "recurrentgemma-9b": "13b",
            "seamless-m4t-medium": "13c"}
KV = ("bfloat16", "int8")
F32 = 1e-5
BF16 = 2.0 ** -6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, ref, tol=F32):
    got = got.detach().cpu().float().numpy() if torch.is_tensor(got) \
        else np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * float(np.abs(ref).max()))


def _params(cfg, seed=1):
    """The reference's params and the port's carried copy."""
    jp = JMD.init_params(cfg, jax.random.PRNGKey(seed))
    return jp, CV.params_from_numpy(_np_tree(jp), "cpu")


def _tokens(cfg, B, S, seed=2):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)) \
        .astype(np.int32)


def _decode_both(cfg, jp, tp, toks, kv, tcfg=None):
    """Teacher-forced decode in both packages: (ref logits, port logits,
    ref cache, port cache), logits (B, S, vocab)."""
    tcfg = tcfg or cfg
    B, Sq = toks.shape
    jstep = jax.jit(lambda p, c, t, pos: JMD.decode_step(p, c, t, pos, cfg))
    jc = JMD.init_cache(cfg, B, Sq, kv_dtype=kv)
    tc = MD.init_cache(tcfg, B, Sq, kv_dtype=kv, device="cpu")
    js, ts = [], []
    for t in range(Sq):
        jl, jc = jstep(jp, jc, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(t))
        tl, tc = MD.decode_step(tp, tc, torch.from_numpy(toks[:, t:t + 1]),
                                t, tcfg)
        js.append(np.asarray(jl))
        ts.append(tl)
    return np.stack(js, 1), torch.stack(ts, 1), jc, tc


def _port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    from repro_torch.models.config import ModelConfig
    return ModelConfig(**dataclasses.asdict(cfg))


# ----------------------------------------------------------------------------
# the five dense archs
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("arch", DENSE)
def test_decode_step_matches_the_reference(arch, kv):
    """decode_step's logits step by step, and the cache it leaves."""
    cfg = ref_smoke_config(arch)
    jp, tp = _params(cfg)
    jl, tl, jc, tc = _decode_both(cfg, jp, tp, _tokens(cfg, 2, 12), kv,
                                  get_smoke_config(arch))
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    _close(tl, jl)
    jleaves = jax.tree_util.tree_leaves_with_path(jc)
    for path, leaf in jleaves:
        node = tc
        for key in path:
            node = node[key.key]
        if kv == "int8" and node.dtype == torch.int8:
            # a rounding tie can fall either side in one in 10^4 entries
            diff = np.abs(node.numpy().astype(np.int32)
                          - np.asarray(leaf).astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 1e-3
        else:
            _close(node, leaf)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_the_reference(arch):
    """prefill's last-position logits and hidden states; internvl2 takes
    its patch embeddings as ``prefix``."""
    cfg = ref_smoke_config(arch)
    jp, tp = _params(cfg, seed=3)
    toks = _tokens(cfg, 2, 16, seed=4)
    batch = {"tokens": toks}
    if cfg.frontend == "patches":
        batch["prefix"] = np.random.default_rng(5).standard_normal(
            (2, cfg.n_prefix, cfg.d_model)).astype(np.float32)
    jl, jx = JMD.prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                         cfg)
    tl, tx = MD.prefill(tp, {k: torch.from_numpy(v)
                             for k, v in batch.items()},
                        get_smoke_config(arch))
    assert tuple(tx.shape) == jx.shape
    _close(tl, jl)
    _close(tx, jx)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("arch", DENSE)
def test_init_cache_is_the_references_tree(arch, kv):
    jc = JMD.init_cache(ref_smoke_config(arch), 3, 10, kv_dtype=kv)
    tc = MD.init_cache(get_smoke_config(arch), 3, 10, kv_dtype=kv,
                       device="cpu")
    jflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_leaves_with_path(jc)}
    tflat = {jax.tree_util.keystr(p): v
             for p, v in jax.tree_util.tree_leaves_with_path(tc)}
    assert jflat.keys() == tflat.keys()
    for k, v in jflat.items():
        assert tuple(tflat[k].shape) == v.shape, k
        assert str(tflat[k].dtype).removeprefix("torch.") == str(v.dtype), k
        assert not tflat[k].any()


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_is_the_references_tree(arch):
    """The port's own draw has the reference's tree, shapes, dtypes and
    init scales (not its values: the two PRNGs differ)."""
    cfg = get_smoke_config(arch)
    jp = JMD.init_params(ref_smoke_config(arch), jax.random.PRNGKey(0))
    tp = MD.init_params(cfg, torch.Generator().manual_seed(0))
    jflat = dict(jax.tree_util.tree_leaves_with_path(jp))
    tflat = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert {jax.tree_util.keystr(k) for k in jflat} == \
        {jax.tree_util.keystr(k) for k in tflat}
    tby = {jax.tree_util.keystr(k): v for k, v in tflat.items()}
    for k, v in jflat.items():
        t = tby[jax.tree_util.keystr(k)]
        assert tuple(t.shape) == v.shape and t.dtype == torch.float32
        ref_std, std = float(jnp.std(v)), float(t.std())
        assert (ref_std == 0) == (std == 0)
        if ref_std:
            assert abs(std / ref_std - 1) < 0.2, k
    assert MD.init_params(cfg, torch.Generator().manual_seed(0))[
        "embed"].equal(tp["embed"])


# ----------------------------------------------------------------------------
# windows, remainders, bf16
# ----------------------------------------------------------------------------

VARIANTS = {
    # a lattn ring of 8 slots decoded to position 19
    "lattn": dict(layer_pattern=("lattn",), window=8),
    # one (attn, lattn) unit and an attn remainder layer
    "unit+rem": dict(layer_pattern=("attn", "lattn"), n_layers=3, window=5),
}


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_lattn_ring_past_its_window_matches_the_reference(variant, kv):
    cfg = dataclasses.replace(ref_smoke_config("yi-6b"), **VARIANTS[variant])
    jp, tp = _params(cfg, seed=6)
    toks = _tokens(cfg, 2, 20, seed=7)
    jl, tl, jc, tc = _decode_both(cfg, jp, tp, toks, kv, _port_cfg(cfg))
    _close(tl, jl)
    ring = tc["units"]["0"]["k"] if variant == "lattn" else \
        tc["units"]["1"]["k"]
    assert ring.shape[2] == cfg.window
    if kv == "bfloat16":
        # decoding past the window keeps the teacher-forced logits
        ref, _ = T.prefill(tp, torch.from_numpy(toks), _port_cfg(cfg))
        _close(tl[:, -1], ref.numpy(), tol=1e-4)


@pytest.mark.parametrize("kv", KV)
def test_bf16_compute_matches_the_reference(kv):
    """cfg.dtype bfloat16 on f32 masters (each matmul casts its weight):
    the logits within 2**-6 of max|ref|."""
    cfg = dataclasses.replace(ref_smoke_config("gemma-2b"), dtype="bfloat16")
    jp, tp = _params(cfg, seed=8)
    jl, tl, _, tc = _decode_both(cfg, jp, tp, _tokens(cfg, 2, 10, seed=9),
                                 kv, _port_cfg(cfg))
    _close(tl, jl, tol=BF16)
    if kv == "bfloat16":
        assert tc["units"]["0"]["k"].dtype == torch.bfloat16


def test_plain_attn_max_dispatches_to_flash_as_in_the_reference(monkeypatch):
    """Past PLAIN_ATTN_MAX both packages' prefill runs flash attention."""
    monkeypatch.setattr(JL, "PLAIN_ATTN_MAX", 8)
    monkeypatch.setattr(L, "PLAIN_ATTN_MAX", 8)
    calls = []
    flash = L.flash_attention
    monkeypatch.setattr(L, "flash_attention",
                        lambda *a, **k: calls.append(1) or flash(*a, **k))
    cfg = ref_smoke_config("glm4-9b")
    jp, tp = _params(cfg, seed=10)
    toks = _tokens(cfg, 2, 16, seed=11)
    jl, _ = JMD.prefill(jp, {"tokens": jnp.asarray(toks)}, cfg)
    tl, _ = MD.prefill(tp, {"tokens": torch.from_numpy(toks)},
                       get_smoke_config("glm4-9b"))
    assert calls
    _close(tl, jl)


# ----------------------------------------------------------------------------
# attention, rope, norms, int8 KV
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, 0), (True, 24), (False, 0),
                                           (True, 3)])
def test_flash_attention_matches_the_references(causal, window):
    """The port's flash attention at small qb / kvb against the
    reference's flash_attention and plain_attention, and the port's plain
    against the reference's."""
    rng = np.random.default_rng(5)
    B, Sq, H, D = 2, 64, 4, 16
    q, k, v = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
               for _ in range(3))
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    ref_flash = JL.flash_attention(jq, jk, jv, causal=causal, window=window,
                                   qb=16, kvb=16)
    ref_plain = JL.plain_attention(jq, jk, jv, causal=causal, window=window)
    got = L.flash_attention(tq, tk, tv, causal=causal, window=window, qb=16,
                            kvb=8)
    _close(got, ref_flash)
    _close(got, ref_plain)
    _close(L.plain_attention(tq, tk, tv, causal=causal, window=window),
           ref_plain)


def test_rope_and_rmsnorm_match_the_reference_in_bf16():
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32)
    pos = np.arange(5)[None, :]
    scale = rng.standard_normal(16).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    got = L.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    ref = JL.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    assert got.dtype == torch.bfloat16
    _close(got, np.asarray(ref, np.float32), tol=2.0 ** -8)
    got = L.rmsnorm(tx, torch.from_numpy(scale))
    ref = JL.rmsnorm(jx, jnp.asarray(scale))
    _close(got, np.asarray(ref, np.float32), tol=2.0 ** -8)
    # halves rotate, not interleaved pairs: the first half's first entry
    # turns with the second half's first entry
    e = torch.zeros(1, 1, 4)
    e[..., 0] = 1.0
    r = L.apply_rope(e, torch.tensor([[1]]), 1.0)
    assert r[..., 2] == pytest.approx(float(np.sin(1.0)))


def test_quantize_kv_matches_the_reference_with_ties():
    """Round half to even, scale max|k|/127 + 1e-8, as ``jnp.round``."""
    rng = np.random.default_rng(13)
    k = rng.standard_normal((2, 3, 2, 8)).astype(np.float32)
    k[0, 0, 0] = [127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.0, 0.0]
    tq, ts = L.quantize_kv(torch.from_numpy(k))
    jq, js = JL.quantize_kv(jnp.asarray(k))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0].tolist() == [127, 0, 2, 2, 0, -2, 3, 0]
    _close(L.dequantize_kv(tq, ts, torch.float32),
           JL.dequantize_kv(jq, js, jnp.float32))
    # bf16: k / scale reaches 127.5 in some rows, rounds to 128 and
    # saturates to 127 (a wrapping cast would give -128)
    kb = torch.from_numpy(rng.standard_normal((1000, 8)).astype(
        np.float32)).to(torch.bfloat16)
    scale = kb.abs().amax(-1, keepdim=True) / 127.0 + 1e-8
    assert float((kb / scale).abs().max()) == 127.5
    tq, _ = L.quantize_kv(kb)
    jq, _ = JL.quantize_kv(jnp.asarray(kb.float().numpy(), jnp.bfloat16))
    assert np.array_equal(tq.numpy(), np.asarray(jq))
    assert ((tq > 0) == (kb > 0))[kb.abs() > 0.5].all()


def test_decode_slot_and_ring_positions_use_a_floor_modulo():
    assert [L.decode_slot(p, 4, 4) for p in range(7)] == [0, 1, 2, 3, 0, 1,
                                                          2]
    assert L.decode_slot(9, 0, 8) == 7          # clamped to the last slot
    pos, idx = 2, torch.arange(4)
    assert (pos - torch.remainder(pos - idx, 4)).tolist() == [0, 1, 2, -1]


# ----------------------------------------------------------------------------
# the serving half of train.step, convert, and the refusals
# ----------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-6b", "gemma-2b"])
def test_greedy_serve_loop_matches_the_reference(arch):
    """The slice as a whole: make_serve_step's greedy loop from a zero
    token gives the reference's tokens, and make_prefill_step its next
    token."""
    cfg = ref_smoke_config(arch)
    tcfg = get_smoke_config(arch)
    jp, tp = _params(cfg, seed=14)
    B, T_ = 3, 10
    jstep = jax.jit(JS.make_serve_step(cfg))
    tstep = S.make_serve_step(tcfg)
    jc = JMD.init_cache(cfg, B, T_)
    tc = MD.init_cache(tcfg, B, T_, device="cpu")
    jt = jnp.zeros((B, 1), jnp.int32)
    tt = torch.zeros((B, 1), dtype=torch.long)
    seq = []
    for t in range(T_ - 1):
        jt, jc = jstep(jp, jc, jt, jnp.asarray(t))
        tt, tc = tstep(tp, tc, tt, t)
        assert tt.shape == (B, 1)
        assert np.array_equal(tt.numpy(), np.asarray(jt)), t
        seq.append(tt)
    toks = torch.cat(seq, 1).numpy().astype(np.int32)
    jn = JS.make_prefill_step(cfg)(jp, {"tokens": jnp.asarray(toks)})
    tn = S.make_prefill_step(tcfg)(tp, {"tokens": torch.from_numpy(toks)})
    assert np.array_equal(tn.numpy(), np.asarray(jn))


def test_argmax_ties_go_to_the_first_index():
    logits = torch.tensor([[0.0, 3.0, 3.0, 1.0]])
    assert int(torch.argmax(logits, dim=-1)) == \
        int(jnp.argmax(jnp.asarray(logits.numpy()), axis=-1)[0]) == 1


def test_step_builders_refuse_rules_and_other_sampling():
    cfg = get_smoke_config("yi-6b")
    for build in (S.make_serve_step, S.make_prefill_step):
        with pytest.raises(NotImplementedError, match="item 13e"):
            build(cfg, rules=object())
    with pytest.raises(ValueError):
        S.make_serve_step(cfg, sample="top-k")


def test_cast_params_gives_the_references_per_matmul_cast():
    cfg = ref_smoke_config("deepseek-67b")
    jp, tp = _params(cfg, seed=15)
    cast = S.cast_params(tp, torch.bfloat16)
    ref = _np_tree(JS.cast_params(jp, jnp.bfloat16))
    for (path, leaf) in jax.tree_util.tree_leaves_with_path(ref):
        node = cast
        for key in path:
            node = node[key.key]
        assert node.dtype == torch.bfloat16
        assert np.array_equal(node.view(torch.int16).numpy(),
                              leaf.view(np.int16))
    assert S.cast_params(tp, "bfloat16")["embed"].equal(cast["embed"])


def test_params_from_numpy_keeps_dtypes_and_bits():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.array([1, -2, 3], np.int8),
                  "d": np.asarray(jnp.asarray([1.5, -2.25], jnp.bfloat16))}}
    out = CV.params_from_numpy(tree, "cpu")
    assert out["a"].dtype == torch.float32 and out["a"].sum() == 15
    assert out["b"]["c"].dtype == torch.int8
    assert out["b"]["d"].dtype == torch.bfloat16
    assert out["b"]["d"].tolist() == [1.5, -2.25]
    cache = CV.cache_from_numpy({"units": {"0": {"k": tree["b"]["c"]}}},
                                "cpu")
    assert cache["units"]["0"]["k"].tolist() == [1, -2, 3]


@pytest.mark.parametrize("arch", sorted(UNPORTED))
def test_unported_blocks_are_refused_naming_their_part(arch):
    """MoE, SSM, RG-LRU and enc-dec configs raise at every entry point,
    naming the part of ROADMAP queue 1 item 13 that ports them."""
    cfg = get_smoke_config(arch)
    match = f"ROADMAP queue 1 item {UNPORTED[arch]}"
    tp = {"embed": torch.zeros(1)}
    for call in (lambda: MD.init_params(cfg, torch.Generator()),
                 lambda: MD.init_cache(cfg, 1, 4, device="cpu"),
                 lambda: MD.decode_step(tp, {}, torch.zeros((1, 1),
                                                            dtype=torch.long),
                                        0, cfg),
                 lambda: MD.prefill(tp, {"tokens": torch.zeros(
                     (1, 2), dtype=torch.long)}, cfg)):
        with pytest.raises(NotImplementedError, match=match):
            call()
