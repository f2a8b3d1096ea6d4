"""Model configuration covering every assigned architecture family.

A copy of ``repro.models.config`` (a dataclass and a shape table, with no
JAX in it), kept in the port because importing ``repro`` loads JAX."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 => d_model // n_heads

    # MLP
    act: str = "silu"           # silu | gelu
    glu: bool = True            # gated (SwiGLU/GeGLU) vs plain MLP

    # MoE
    n_experts: int = 0
    topk: int = 0
    capacity_factor: float = 1.25

    # Attention
    rope_theta: float = 10_000.0
    window: int = 0             # local attention window; 0 = global causal
    # Repeating block pattern; layer i uses pattern[i % len(pattern)]:
    #   "attn" = full attention, "lattn" = local windowed attention,
    #   "rec" = RG-LRU recurrent block, "ssm" = mamba2 SSD block
    layer_pattern: Tuple[str, ...] = ("attn",)

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    ssd_dtype: str = "float32"   # intra-chunk SSD math ("bfloat16" halves
                                 # the HBM traffic of the chunk tensors)

    # RG-LRU (recurrentgemma)
    lru_width: int = 0          # 0 => d_model

    # Encoder-decoder (audio family)
    enc_layers: int = 0         # >0 => encoder-decoder
    dec_ratio: int = 4          # decoder seq = seq // dec_ratio for training

    # Modality frontend stubs (vlm/audio): precomputed embeddings arrive as
    # inputs via input_specs(); n_prefix is the patch count for vlm.
    frontend: str = "none"      # none | patches | frames
    n_prefix: int = 0

    # Norm / embeddings
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    logit_softcap: float = 0.0

    # Numerics
    dtype: str = "bfloat16"

    # Vocab padded for even sharding (embedding rows beyond vocab are dead;
    # logits for them are masked to -inf in the loss).
    @property
    def vocab_padded(self) -> int:
        return round_up(self.vocab, 256)

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def d_inner(self) -> int:  # ssm inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def resolved_lru_width(self) -> int:
        return self.lru_width or self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def subquadratic(self) -> bool:
        """True if no layer does full-context attention (long_500k eligible)."""
        return all(p != "attn" for p in self.layer_pattern)

    @property
    def pattern_units(self) -> int:
        """Number of complete pattern repetitions (scanned);
        remainder layers are unrolled."""
        return self.n_layers // len(self.layer_pattern)

    @property
    def remainder_layers(self) -> Tuple[str, ...]:
        rem = self.n_layers % len(self.layer_pattern)
        return self.layer_pattern[:rem]

    def n_params(self) -> int:
        """Total parameter count (embeddings included once if tied)."""
        d, hd = self.d_model, self.resolved_head_dim
        per: dict = {}
        per["attn"] = per["lattn"] = (
            d * self.n_heads * hd + 2 * d * self.kv_heads * hd
            + self.n_heads * hd * d)
        mlp = (3 if self.glu else 2) * d * self.d_ff
        if self.n_experts:
            mlp = self.n_experts * mlp + d * self.n_experts  # + router
        di = self.d_inner
        per["ssm"] = (d * (2 * di + 2 * self.ssm_state + self.ssm_heads)
                      + di * d + self.conv_width * (di + 2 * self.ssm_state))
        w = self.resolved_lru_width
        # two input branches + out proj + RG-LRU gates + conv + Lambda
        per["rec"] = 2 * d * w + w * d + 2 * w * w + self.conv_width * w + w
        total = 0
        for i in range(self.n_layers):
            kind = self.layer_pattern[i % len(self.layer_pattern)]
            total += per[kind] + (mlp if kind in ("attn", "lattn", "rec") else 0)
            total += 2 * d  # norms
        if self.is_encdec:
            enc_per = per["attn"] + (3 if self.glu else 2) * d * self.d_ff + 2 * d
            total += self.enc_layers * enc_per
            total += self.n_layers * (per["attn"] + d)  # cross-attn
        emb = self.vocab_padded * d
        total += emb if self.tie_embeddings else 2 * emb
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE: topk experts instead of all)."""
        if not self.n_experts:
            return self.n_params()
        full_mlp = self.n_experts * (3 if self.glu else 2) * self.d_model * self.d_ff
        act_mlp = self.topk * (3 if self.glu else 2) * self.d_model * self.d_ff
        return self.n_params() - self.n_layers * (full_mlp - act_mlp)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
