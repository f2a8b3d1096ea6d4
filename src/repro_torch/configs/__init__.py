"""Architecture config registry: --arch <id> resolves here.

A copy of ``repro.configs``: the same ten architectures, full and smoke
configurations, on the port's :class:`~repro_torch.models.config.ModelConfig`."""
from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ModelConfig

from . import (deepseek_67b, gemma_2b, glm4_9b, granite_moe_3b, internvl2_26b,
               mamba2_370m, phi35_moe_42b, recurrentgemma_9b,
               seamless_m4t_medium, yi_6b)

_MODULES = (phi35_moe_42b, granite_moe_3b, glm4_9b, gemma_2b, deepseek_67b,
            yi_6b, seamless_m4t_medium, mamba2_370m, recurrentgemma_9b,
            internvl2_26b)

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.SMOKE_CONFIG for m in _MODULES}

ARCHS = tuple(REGISTRY)


def get_config(arch: str) -> ModelConfig:
    if arch not in REGISTRY:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[arch]


def get_smoke_config(arch: str) -> ModelConfig:
    return SMOKE_REGISTRY[arch]
