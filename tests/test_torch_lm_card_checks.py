"""chip_smoke.py's checks of the LM decode card against the CPU
(``lm_hold``, ``lm_cache_err``), run here on the CPU with both runs on the
host: two equal decodes pass with no split, and a quantiser that rounds
another way, a cache that was never quantised and int8 entries two steps
apart each fail. Small smoke configs; imports no JAX.
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

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _run(smoke, arch, kv):
    cfg = get_smoke_config(arch)
    host = MD.init_params(cfg, torch.Generator().manual_seed(0))
    params = CV.params_from_numpy(CV.tree_map(lambda t: t.numpy(), host),
                                  CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 12)))
    calls = []
    return (*smoke._lm_decode(params, cfg, toks, kv, calls), calls)


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
