"""chip_smoke.py's checks of the LM decode card against the CPU
(``lm_hold``, ``lm_cache_err``, ``lm_route_split``), run here on the CPU
with both runs on the host: two equal decodes pass with no split, and a
quantiser that rounds another way, a cache that was never quantised and
int8 entries two steps apart each fail. A MoE router that breaks exact
ties the other way (as a card may) is a split at a near-tie: the CPU run
is replayed on its experts and the pair passes; one that swaps experts
away from a tie fails. Small smoke configs; imports no JAX.
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.models import convert as CV
from repro_torch.models import layers as L
from repro_torch.models import model as MD
from repro_torch.models import moe as M

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _params(arch, tie=None):
    """A smoke config's params drawn on the host; ``tie=(a, b)`` gives
    experts a and b of every router the same column (exact ties)."""
    cfg = get_smoke_config(arch)
    host = MD.init_params(cfg, torch.Generator().manual_seed(0))
    if tie:
        for unit in host["units"].values():
            unit["moe"]["router"][..., tie[1]] = \
                unit["moe"]["router"][..., tie[0]]
    return cfg, CV.params_from_numpy(CV.tree_map(lambda t: t.numpy(), host),
                                     CPU)


def _run(smoke, arch, kv, tie=None, forced=None):
    cfg, params = _params(arch, tie)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)))
    calls, routes = [], []
    return (*smoke._lm_decode(params, cfg, toks, kv, calls, routes, forced),
            calls, routes)


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
@pytest.mark.parametrize("arch", ["gemma-2b", "deepseek-67b"])
def test_equal_decodes_pass_with_no_split(smoke, arch, kv):
    run = _run(smoke, arch, kv)
    case = smoke.lm_hold(run, _run(smoke, arch, kv), kv, CPU)
    assert case["logits"] == 0 and case["int8_one_step"] == 0
    if kv == "int8":
        assert len(run[2]) == case["quantiser"]["calls"] > 0
        assert case["quantiser"]["first_split"] is None
    else:
        assert not run[2]


def test_a_quantiser_that_truncates_fails(smoke, monkeypatch):
    ref = _run(smoke, "deepseek-67b", "int8")

    def truncate(k):
        scale = torch.amax(torch.abs(k), dim=-1, keepdim=True) / 127.0 + 1e-8
        q = torch.clamp(torch.trunc(k / scale), -128, 127)
        return q.to(torch.int8), scale.float()
    with monkeypatch.context() as m:
        m.setattr(L, "quantize_kv", truncate)
        bad = _run(smoke, "deepseek-67b", "int8")
    with pytest.raises(smoke.SmokeFailure):
        smoke.lm_hold(bad, ref, "int8", CPU)


def test_the_cache_check_needs_int8_entries_one_step_apart(smoke):
    cfg = get_smoke_config("gemma-2b")
    ref = MD.init_cache(cfg, 2, 12, kv_dtype="int8", device=CPU)
    with pytest.raises(smoke.SmokeFailure, match="came back"):
        smoke.lm_cache_err(MD.init_cache(cfg, 2, 12, kv_dtype="bfloat16",
                                         device=CPU), ref, "int8")
    one = MD.init_cache(cfg, 2, 12, kv_dtype="int8", device=CPU)
    one["units"]["0"]["k"].view(-1)[0] = 1
    assert smoke.lm_cache_err(one, ref, "int8")[1] == 1 / 3072
    one["units"]["0"]["k"].view(-1)[0] = 2
    with pytest.raises(smoke.SmokeFailure, match="2 steps apart"):
        smoke.lm_cache_err(one, ref, "int8")


@pytest.mark.parametrize("arch", ["phi3.5-moe-42b-a6.6b",
                                  "granite-moe-3b-a800m", "mamba2-370m",
                                  "recurrentgemma-9b", "seamless-m4t-medium"])
def test_equal_decodes_of_every_family_pass_with_no_split(smoke, arch):
    cfg = get_smoke_config(arch)
    kvs = smoke.lm_kv_dtypes(cfg)
    assert kvs == (("bfloat16",) if arch in ("mamba2-370m",
                                            "seamless-m4t-medium")
                   else ("bfloat16", "int8"))
    for kv in kvs:
        run = _run(smoke, arch, kv)
        case = smoke.lm_hold(run, _run(smoke, arch, kv), kv, CPU)
        assert case["logits"] == 0 and "replayed" not in case
        if cfg.n_experts:
            assert len(run[3]) == 12 * cfg.n_layers
            assert case["routing"]["splits"] == 0
            assert case["routing"]["calls"] == len(run[3])
        else:
            assert "routing" not in case and not run[3]


def _route_high(probs, k):
    """A router that breaks exact ties toward the higher expert."""
    flipped = probs.flip(-1)
    _, idx = torch.sort(flipped, dim=-1, descending=True, stable=True)
    idx = probs.shape[-1] - 1 - idx[..., :k]
    g = probs.gather(-1, idx)
    return g / (g.sum(-1, keepdim=True) + 1e-9), idx


@pytest.mark.parametrize("kv", ["bfloat16", "int8"])
def test_a_split_at_an_exact_tie_is_replayed_and_held(smoke, monkeypatch,
                                                      kv):
    """Experts 3 and 4 share their router column: the stand-in card breaks
    their ties toward 4, the CPU toward 3. The first token whose tie
    straddles the top-k is a split with a gap of 0; the CPU replayed on
    the stand-in's experts matches it from the first step."""
    arch, tie = "granite-moe-3b-a800m", (3, 4)
    host = _run(smoke, arch, kv, tie)
    with monkeypatch.context() as m:
        m.setattr(M, "route", _route_high)
        card = _run(smoke, arch, kv, tie)
    assert any(not a[1].equal(b[1]) for a, b in zip(card[3], host[3]))
    assert float((card[0] - host[0]).abs().max()) > 1e-3
    with pytest.raises(smoke.SmokeFailure, match="no replay"):
        smoke.lm_hold(card, host, kv, CPU)
    case = smoke.lm_hold(card, host, kv, CPU,
                         replay=lambda picks: _run(smoke, arch, kv, tie,
                                                   forced=picks))
    assert case["replayed"] and case["logits"] == 0
    first = case["routing"]["first"]
    assert case["routing"]["splits"] >= 1 and first["gap"] == 0.0
    assert {3, 4} == set(first["card"]) ^ set(first["cpu"])
    per = get_smoke_config(arch).n_layers
    assert (first["step"], first["layer"]) == divmod(first["call"], per)


def test_a_split_away_from_a_tie_fails(smoke, monkeypatch):
    """A stand-in card that takes the third most probable expert for the
    second at one call: its gap is no near-tie, and lm_hold refuses it."""
    arch = "granite-moe-3b-a800m"
    host = _run(smoke, arch, "bfloat16")
    route, n = M.route, [0]

    def swapped(probs, k):
        gate, idx = route(probs, k)
        n[0] += 1
        if n[0] == 3:
            _, order = torch.sort(probs, dim=-1, descending=True,
                                  stable=True)
            idx = idx.clone()
            idx[0, -1] = order[0, k]
        return gate, idx
    with monkeypatch.context() as m:
        m.setattr(M, "route", swapped)
        card = _run(smoke, arch, "bfloat16")
    with pytest.raises(smoke.SmokeFailure, match="not a near-tie"):
        smoke.lm_hold(card, host, "bfloat16", CPU,
                      replay=lambda picks: _run(smoke, arch, "bfloat16",
                                                forced=picks))


def test_lm_route_split_reads_gaps_in_log_probability(smoke):
    p = torch.tensor([[0.5, 0.25, 0.25, 0.0]])
    same = smoke.lm_route_split([(p, torch.tensor([[0, 1]]))],
                                [(p, torch.tensor([[1, 0]]))], 1e-5)
    assert same["splits"] == 0 and same["logp_err"] == 0.0
    tie = smoke.lm_route_split([(p, torch.tensor([[0, 2]]))],
                               [(p, torch.tensor([[0, 1]]))], 1e-5)
    assert tie["splits"] == 1 and tie["first"]["gap"] == 0.0
    with pytest.raises(smoke.SmokeFailure, match="not a near-tie"):
        smoke.lm_route_split([(p, torch.tensor([[0, 2]]))],
                             [(p * 1.0, torch.tensor([[0, 3]]))], 1e-5)
