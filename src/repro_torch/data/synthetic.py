"""Seeded, stateless synthetic LM data pipeline, a copy of
``repro.data.synthetic`` (numpy only; importing the reference loads JAX).

``batch(step)`` is a pure function of (seed, step), so a restart after a
failure reproduces the exact token stream with no data-loader state to
checkpoint. Tokens follow a deterministic Markov backbone over a
Zipf-ish vocab, so the loss falls during the example training runs. The
arrays are the reference's byte for byte: int32 tokens and labels (the
last label -1), float32 ``prefix`` (vlm) and ``frames`` (enc-dec, whose
tokens are cut to ``max(256, S // dec_ratio)``). They stay numpy; the
training loop's ``put_batch`` moves them to the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

from repro_torch.models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass
class SyntheticLM:
    cfg: ModelConfig
    seq_len: int
    global_batch: int
    seed: int = 0

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, 0xD06F00D]))
        V = self.cfg.vocab
        B, S = self.global_batch, self.seq_len
        # Markov chain: next = (3 * cur + noise) mod V_eff, over a zipf vocab
        v_eff = min(V, 4096)
        start = rng.integers(0, v_eff, size=(B, 1))
        noise = rng.integers(0, 7, size=(B, S))
        toks = np.zeros((B, S), dtype=np.int64)
        toks[:, 0] = start[:, 0]
        for t in range(1, S):
            toks[:, t] = (3 * toks[:, t - 1] + noise[:, t]) % v_eff
        tokens = toks.astype(np.int32)
        labels = np.concatenate(
            [tokens[:, 1:], np.full((B, 1), -1, np.int32)], axis=1)
        out = {"tokens": tokens, "labels": labels}
        if self.cfg.frontend == "patches":
            out["prefix"] = rng.standard_normal(
                (B, self.cfg.n_prefix, self.cfg.d_model)).astype(np.float32)
        if self.cfg.is_encdec:
            out["frames"] = rng.standard_normal(
                (B, self.seq_len, self.cfg.d_model)).astype(np.float32)
            Sd = max(256, self.seq_len // self.cfg.dec_ratio)
            out["tokens"] = tokens[:, :Sd]
            out["labels"] = labels[:, :Sd]
        return out


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int,
               seed: int = 0) -> Dict[str, np.ndarray]:
    return SyntheticLM(cfg, shape.seq_len, shape.global_batch,
                       seed=seed).batch(step)
