"""deepseek-67b [arXiv:2401.02954]: 95L d8192 64H (GQA kv=8) d_ff=22016 v102400."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    kv_heads=8,
    d_ff=22016,
    vocab=102400,
    act="silu",
    glu=True,
)

SMOKE_CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=3,
    d_model=64,
    n_heads=8,
    kv_heads=2,
    d_ff=96,
    vocab=256,
    act="silu",
    glu=True,
    dtype="float32",
)
