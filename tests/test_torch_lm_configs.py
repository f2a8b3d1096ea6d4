"""The port's architecture registry (``repro_torch.configs``) and model
config (``repro_torch.models.config``) against the reference's: the same
ten architectures, full and smoke, field for field, with the same derived
sizes."""
import dataclasses

import pytest

import repro.configs as JC
import repro.models.config as JMC
import repro_torch.configs as C
import repro_torch.models.config as MC

PROPERTIES = ("vocab_padded", "resolved_head_dim", "d_inner", "ssm_heads",
              "resolved_lru_width", "is_encdec", "subquadratic",
              "pattern_units", "remainder_layers")


def test_archs_and_their_order_are_the_references():
    assert C.ARCHS == JC.ARCHS and len(C.ARCHS) == 10
    assert list(C.REGISTRY) == list(JC.REGISTRY)
    assert list(C.SMOKE_REGISTRY) == list(JC.SMOKE_REGISTRY)


@pytest.mark.parametrize("registry", ["REGISTRY", "SMOKE_REGISTRY"])
@pytest.mark.parametrize("arch", JC.ARCHS)
def test_each_config_is_the_references_field_for_field(arch, registry):
    cfg, ref = getattr(C, registry)[arch], getattr(JC, registry)[arch]
    assert isinstance(cfg, MC.ModelConfig)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)
    assert cfg.n_params() == ref.n_params()
    assert cfg.n_active_params() == ref.n_active_params()
    for name in PROPERTIES:
        assert getattr(cfg, name) == getattr(ref, name), name


@pytest.mark.parametrize("arch", JC.ARCHS)
def test_getters_return_the_registries_entries(arch):
    assert C.get_config(arch) is C.REGISTRY[arch]
    assert C.get_smoke_config(arch) is C.SMOKE_REGISTRY[arch]
    assert C.get_config(arch).n_params() == JC.get_config(arch).n_params()


def test_unknown_arch_raises_as_in_the_reference():
    with pytest.raises(KeyError, match="unknown arch 'gpt-17'"):
        C.get_config("gpt-17")
    with pytest.raises(KeyError):
        C.get_smoke_config("gpt-17")


def test_model_config_and_shapes_are_the_references():
    assert [f.name for f in dataclasses.fields(MC.ModelConfig)] == \
        [f.name for f in dataclasses.fields(JMC.ModelConfig)]
    assert {k: dataclasses.asdict(v) for k, v in MC.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JMC.SHAPES.items()}
    assert MC.round_up(64_001, 256) == JMC.round_up(64_001, 256) == 64_256


def test_yi_6b_is_the_full_size_the_smoke_decodes():
    cfg = C.get_config("yi-6b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.kv_heads,
            cfg.d_ff, cfg.vocab) == (32, 4096, 32, 4, 11008, 64000)
    assert 6.0e9 < cfg.n_params() < 6.1e9
