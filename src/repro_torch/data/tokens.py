"""Synthetic token pipeline for the transformer substrate (a copy of
``repro/data/tokens.py``, numpy only, so both packages draw the same
streams from one seed).

Produces reproducible Zipf-distributed token streams with short-range
structure (Markov bigram mixing) so language-model smoke training has a
learnable signal. Used by the per-arch smoke tests and the training example.
"""
from __future__ import annotations

from typing import Iterator, NamedTuple

import numpy as np


class Batch(NamedTuple):
    tokens: np.ndarray   # (B, S) int32 inputs
    targets: np.ndarray  # (B, S) int32 next-token targets
    mask: np.ndarray     # (B, S) float32 loss mask


def synthetic_stream(seed: int, vocab_size: int, length: int,
                     zipf_a: float = 1.3) -> np.ndarray:
    rng = np.random.default_rng(seed)
    # zipf base distribution truncated to vocab
    ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
    probs = ranks ** (-zipf_a)
    probs /= probs.sum()
    base = rng.choice(vocab_size, size=length, p=probs)
    # inject bigram structure: with prob .5, next token = f(prev)
    shift = rng.integers(1, 17)
    follow = rng.uniform(size=length) < 0.5
    base[1:] = np.where(follow[1:], (base[:-1] * 31 + shift) % vocab_size,
                        base[1:])
    return base.astype(np.int32)


def batches(seed: int, vocab_size: int, batch_size: int, seq_len: int,
            n_batches: int) -> Iterator[Batch]:
    stream = synthetic_stream(seed, vocab_size,
                              n_batches * batch_size * (seq_len + 1) + 1)
    pos = 0
    for _ in range(n_batches):
        chunk = stream[pos:pos + batch_size * (seq_len + 1)]
        pos += batch_size * (seq_len + 1)
        chunk = chunk.reshape(batch_size, seq_len + 1)
        yield Batch(chunk[:, :-1].copy(), chunk[:, 1:].copy(),
                    np.ones((batch_size, seq_len), np.float32))
