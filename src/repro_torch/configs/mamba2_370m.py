"""mamba2-370m [arXiv:2405.21060]: 48L d1024, attn-free, ssm_state=128.

SSD (state-space duality) blocks: expand=2 (d_inner 2048), head_dim 64
(32 ssm heads), chunked-scan training path, O(1)-state decode path.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=50280,
    layer_pattern=("ssm",),
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    tie_embeddings=True,
)

SMOKE_CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=2,
    d_model=64,
    n_heads=0,
    kv_heads=0,
    d_ff=0,
    vocab=256,
    layer_pattern=("ssm",),
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=16,
    ssm_chunk=32,
    tie_embeddings=True,
    dtype="float32",
)
