"""recurrentgemma-9b [arXiv:2402.19427]: 38L d4096 16H MQA(kv=1) d_ff=12288
v256000. Griffin pattern -- 2 RG-LRU recurrent blocks : 1 local-attention
block (window 2048), GeGLU MLP in every layer. Sub-quadratic => long_500k runs.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab=256000,
    act="gelu",
    glu=True,
    layer_pattern=("rec", "rec", "lattn"),
    window=2048,
    lru_width=4096,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=3,
    d_model=64,
    n_heads=4,
    kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab=256,
    act="gelu",
    glu=True,
    layer_pattern=("rec", "rec", "lattn"),
    window=16,
    lru_width=64,
    tie_embeddings=True,
    dtype="float32",
)
