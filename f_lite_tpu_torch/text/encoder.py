"""Text encoders producing (embeddings (B, S, C), mask (B, S)) pairs
(counterpart of `f_lite_tpu/text/encoder.py`; only the hermetic encoder is
ported so far)."""

from __future__ import annotations

import hashlib

import numpy as np


class ZeroTextEncoder:
    """Deterministic hermetic encoder: md5-seeded pseudo-embeddings, bit
    for bit those of the JAX package's `ZeroTextEncoder`."""

    def __init__(self, embed_dim: int = 4096, seq_len: int = 128,
                 random: bool = True):
        self.embed_dim = embed_dim
        self.seq_len = seq_len
        self.random = random

    def encode(self, prompts):
        b = len(prompts)
        out = np.zeros((b, self.seq_len, self.embed_dim), np.float32)
        if self.random:
            for i, p in enumerate(prompts):
                seed = int(hashlib.md5(p.encode()).hexdigest()[:8], 16)
                rs = np.random.RandomState(seed)
                out[i] = rs.randn(self.seq_len, self.embed_dim) * 0.02
        mask = np.ones((b, self.seq_len), bool)
        return out, mask
