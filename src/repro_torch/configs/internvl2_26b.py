"""internvl2-26b [arXiv:2404.16821]: InternLM2-20B backbone,
48L d6144 48H (GQA kv=8) d_ff=16384 v92553. InternViT frontend is a STUB:
input_specs() provides precomputed patch embeddings (B, n_prefix, d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    kv_heads=8,
    d_ff=16384,
    vocab=92553,
    act="silu",
    glu=True,
    frontend="patches",
    n_prefix=256,           # ViT patch tokens prepended to the text sequence
)

SMOKE_CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=2,
    d_model=64,
    n_heads=4,
    kv_heads=2,
    d_ff=96,
    vocab=256,
    act="silu",
    glu=True,
    frontend="patches",
    n_prefix=8,
    dtype="float32",
)
