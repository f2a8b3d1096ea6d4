"""seamless-m4t-medium [arXiv:2308.11596]: enc-dec, 12L each side,
d1024 16H d_ff=4096 vocab=256206. Audio frontend is a STUB: input_specs()
provides precomputed frame embeddings (B, S, d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=12,            # decoder layers
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    kv_heads=16,
    d_ff=4096,
    vocab=256206,
    act="gelu",
    glu=False,              # conformer-style plain MLP on the text side
    frontend="frames",
    dec_ratio=4,
)

SMOKE_CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="audio",
    n_layers=2,
    enc_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=4,
    d_ff=128,
    vocab=256,
    act="gelu",
    glu=False,
    frontend="frames",
    dec_ratio=4,
    dtype="float32",
)
