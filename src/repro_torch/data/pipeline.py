"""Deterministic synthetic token streams (port of the synthetic corpus of
`repro/data/pipeline.py`).

A seeded affine Markov stream with a small uniform-noise fraction, made in
numpy exactly as the reference makes it, so both packages train on
bit-identical tokens. The dry-run input specs and the ``batch``/iterator
views of the reference serve its uniform arch stack and are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    noise: float = 0.05  # fraction of uniformly-random tokens


class SyntheticLMPipeline:
    """Affine Markov token stream: t_{i+1} = (a·t_i + b) mod V, with a small
    uniform-noise fraction. Deterministic given (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # affine params coprime-ish with V for long cycles
        self.a = int(rng.integers(2, max(3, v - 1))) | 1
        self.b = int(rng.integers(1, v))

    def _batch_np(self, step: int) -> np.ndarray:
        c = self.cfg
        rng = np.random.default_rng((c.seed, step))
        t0 = rng.integers(0, c.vocab_size, size=(c.global_batch, 1))
        toks = [t0]
        for _ in range(c.seq_len):
            nxt = (self.a * toks[-1] + self.b) % c.vocab_size
            noise_mask = rng.random((c.global_batch, 1)) < c.noise
            rand = rng.integers(0, c.vocab_size, size=(c.global_batch, 1))
            toks.append(np.where(noise_mask, rand, nxt))
        return np.concatenate(toks, axis=1).astype(np.int32)  # (B, S+1)
