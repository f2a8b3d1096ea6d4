"""chip_smoke.py's phase 5c checks, run here on the CPU: ``lm_train_case``
with both of its runs on the host passes for every smoke config (card
and CPU the same device: every error 0), its leaf comparison catches a
perturbed gradient, a MoE router that breaks exact ties the other way is
a split at a near-tie whose replay passes, and ``lm_train_flops`` counts
what its docstring says. Imports no JAX.
"""
import dataclasses
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.configs import get_config, get_smoke_config

CPU = torch.device("cpu")
ARCHS = ("yi-6b", "gemma-2b", "glm4-9b", "deepseek-67b", "internvl2-26b",
         "phi3.5-moe-42b-a6.6b", "granite-moe-3b-a800m", "mamba2-370m",
         "recurrentgemma-9b", "seamless-m4t-medium")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("arch", ARCHS)
def test_train_case_passes_with_both_runs_on_the_host(smoke, arch):
    out = smoke.lm_train_case(arch, CPU)
    assert len(out["steps"]) == smoke.LM_TRAIN["steps"]
    for s in out["steps"]:
        assert s["loss_err"] == 0 and s["grad_err"] == 0
        assert s["update_err"] == 0
        assert ("routing" in s) == bool(get_smoke_config(arch).n_experts)
    assert out["train_step_loss_err"] == 0
    assert set(out["remat"]) == {"dots", "everything"}
    assert all(r["grad_err"] <= smoke.LM_TRAIN_TOL
               for r in out["remat"].values())


def test_leaf_errors_find_a_perturbed_gradient(smoke):
    ref = {"a": torch.ones(3), "b": {"c": torch.zeros(2)}}
    got = {"a": torch.tensor([1.0, 1.0, 1.5]), "b": {"c": torch.zeros(2)}}
    errs = smoke._leaf_errs(got, ref)
    assert errs == {"a": 0.5, "b/c": 0.0}
    assert smoke._worst(errs) == (0.5, "a")
    got["b"]["c"][0] = 1e-3     # a leaf whose reference is all zero
    assert smoke._leaf_errs(got, ref)["b/c"] == pytest.approx(1e-3)


def test_a_tie_broken_the_other_way_is_replayed(smoke, monkeypatch):
    """Experts 0 and 1 given one router column (exact ties) in a one-layer
    granite-moe; the "card" runs' router picks the higher expert at a tie:
    a split at a gap of 0, after which the CPU replays the card's experts
    and the case passes."""
    import repro_torch.configs as RC
    from repro_torch.models import moe as M
    from repro_torch.models import model as MD
    init = MD.init_params
    one = dataclasses.replace(get_smoke_config("granite-moe-3b-a800m"),
                              n_layers=1)
    monkeypatch.setattr(RC, "get_smoke_config", lambda arch: one)

    def tied(cfg, gen):
        p = init(cfg, gen)
        for unit in p["units"].values():
            unit["moe"]["router"][..., 1] = unit["moe"]["router"][..., 0]
        return p
    monkeypatch.setattr(MD, "init_params", tied)
    route = M.route
    calls = {"n": 0}

    def flipped(probs, k):
        gate, idx = route(probs, k)
        # the "card" runs break ties to the higher one: every call but the
        # CPU run's and its replay's (calls 2-5: a forward and a recompute
        # each)
        if calls["n"] not in range(2, 6):
            idx = torch.where(idx == 0, 1, torch.where(idx == 1, 0, idx))
            g = probs.gather(-1, idx)
            gate = g / (g.sum(-1, keepdim=True) + 1e-9)
        calls["n"] += 1
        return gate, idx
    monkeypatch.setattr(M, "route", flipped)
    monkeypatch.setitem(smoke.LM_TRAIN, "steps", 1)
    out = smoke.lm_train_case("granite-moe-3b-a800m", CPU)
    assert out["steps"][0]["routing"]["splits"] > 0
    assert out["steps"][0]["routing"]["gap_max"] == 0.0
    assert out["steps"][0]["grad_err"] <= smoke.LM_TRAIN_TOL


def test_train_flops_count(smoke):
    """yi-6b at 4 layers, 8 x 256: 6 N T for the weights past the
    embedding, the attention squares three times, the head's recompute,
    and under "nothing" the units' forward again."""
    cfg = dataclasses.replace(get_config("yi-6b"), n_layers=4)
    T = 8 * 256
    emb = cfg.vocab_padded * cfg.d_model
    n = cfg.n_params() - emb
    attn = 4 * 8 * 256 * 256 * cfg.n_heads * cfg.resolved_head_dim * 4
    everything = smoke.lm_train_flops(cfg, 8, 256, "everything")
    assert everything == 6 * n * T + 3 * attn + 2 * emb * T
    assert smoke.lm_train_flops(cfg, 8, 256, "dots") == everything + attn
    assert smoke.lm_train_flops(cfg, 8, 256) == \
        everything + attn + 2 * (n - emb) * T
    assert 1.5e13 < smoke.lm_train_flops(cfg, 8, 256) < 1.65e13
