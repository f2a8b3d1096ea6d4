"""The port's LM stack (ROADMAP queue 1 item 13): configs, layers, the
decoder-only blocks (attention, MoE, SSM, RG-LRU), the encoder-decoder
and the model facade, copies of ``repro.models`` on torch.

Importing this package imports none of its modules but the config."""
from .config import SHAPES, ModelConfig, ShapeConfig  # noqa: F401
