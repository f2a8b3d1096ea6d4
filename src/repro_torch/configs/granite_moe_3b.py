"""granite-moe-3b-a800m [hf:ibm-granite/granite-3.0-1b-a400m-base].

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40 experts top-8.
(The assignment's trailing note says "32 experts top-8"; the primary spec says
40e top-8 -- we take 40, discrepancy recorded in DESIGN.md §5.)
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    kv_heads=8,
    d_ff=512,
    vocab=49155,
    n_experts=40,
    topk=8,
    act="silu",
    glu=True,
)

SMOKE_CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=2,
    d_model=48,
    n_heads=6,
    kv_heads=2,
    d_ff=32,
    vocab=256,
    n_experts=5,
    topk=2,
    act="silu",
    glu=True,
    dtype="float32",
)
