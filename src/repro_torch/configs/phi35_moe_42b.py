"""phi3.5-moe-42b-a6.6b [hf:microsoft/Phi-3.5-MoE-instruct].

32L d_model=4096 32H (GQA kv=8) d_ff=6400 vocab=32064, MoE 16 experts top-2.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=8,
    d_ff=6400,
    vocab=32064,
    n_experts=16,
    topk=2,
    act="silu",
    glu=True,
)

SMOKE_CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    family="moe",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=96,
    vocab=256,
    n_experts=4,
    topk=2,
    act="silu",
    glu=True,
    dtype="float32",
)
