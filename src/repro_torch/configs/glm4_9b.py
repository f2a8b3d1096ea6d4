"""glm4-9b [hf:THUDM/glm-4-9b]: 40L d4096 32H (GQA kv=2) d_ff=13696 v151552."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    kv_heads=2,
    d_ff=13696,
    vocab=151552,
    act="silu",
    glu=True,
)

SMOKE_CONFIG = ModelConfig(
    name="glm4-9b",
    family="dense",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=128,
    vocab=256,
    act="silu",
    glu=True,
    dtype="float32",
)
