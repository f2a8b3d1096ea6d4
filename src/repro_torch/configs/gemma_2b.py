"""gemma-2b [arXiv:2403.08295]: 18L d2048 8H MQA(kv=1) d_ff=16384 v256000.

GeGLU activation, head_dim=256 (larger than d_model/n_heads).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab=256000,
    act="gelu",
    glu=True,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="gemma-2b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=1,
    head_dim=32,
    d_ff=128,
    vocab=256,
    act="gelu",
    glu=True,
    tie_embeddings=True,
    dtype="float32",
)
