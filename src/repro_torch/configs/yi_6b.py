"""yi-6b [arXiv:2403.04652]: 32L d4096 32H (GQA kv=4) d_ff=11008 v64000."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    kv_heads=4,
    d_ff=11008,
    vocab=64000,
    act="silu",
    glu=True,
)

SMOKE_CONFIG = ModelConfig(
    name="yi-6b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=96,
    vocab=256,
    act="silu",
    glu=True,
    dtype="float32",
)
