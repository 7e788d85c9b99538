"""Synthetic data pipelines — a numpy copy of the reference's module, so
the same seed gives the same batches in both packages.

LM side: a deterministic, seekable synthetic token stream with enough
structure to make next-token loss meaningfully decrease (a mixture of
Zipf-distributed unigrams and copied n-gram motifs — pure noise would make
training-loss validation impossible).

The iterator yields host-side numpy batches; device placement is the
trainer's job (launch/train.py), matching the paper's split of data IO
from optimization.
"""
from __future__ import annotations

import numpy as np


def synthetic_tokens(rng: np.random.Generator, n: int, vocab: int,
                     motif_len: int = 8, n_motifs: int = 256) -> np.ndarray:
    """Zipf unigrams interleaved with repeated motifs (learnable bigram+
    structure). Returns (n,) int32 in [0, vocab)."""
    zipf = rng.zipf(1.3, size=n).astype(np.int64)
    toks = (zipf - 1) % vocab
    motifs = rng.integers(0, vocab, size=(n_motifs, motif_len))
    i = 0
    while i < n - motif_len:
        if rng.random() < 0.15:
            m = motifs[rng.integers(0, n_motifs)]
            toks[i:i + motif_len] = m
            i += motif_len
        else:
            i += rng.integers(1, motif_len)
    return toks.astype(np.int32)


def synthetic_lm_batch(rng: np.random.Generator, batch: int, seq: int,
                       vocab: int) -> dict:
    toks = synthetic_tokens(rng, batch * seq, vocab)
    return {"tokens": toks.reshape(batch, seq)}


def lm_batch_iterator(seed: int, batch: int, seq: int, vocab: int,
                      *, frontend: str | None = None, d_model: int = 0,
                      encoder_seq: int = 0, prefix_len: int = 0):
    """Infinite iterator of host batches for any assigned arch.

    For audio/vlm archs the stub frontend embeddings are random but
    deterministic per step (the brief's carve-out: we train the backbone,
    not the frontend)."""
    rng = np.random.default_rng(seed)
    while True:
        b = synthetic_lm_batch(rng, batch, seq, vocab)
        if frontend == "audio":
            b["frames"] = rng.normal(
                0, 0.1, size=(batch, encoder_seq, d_model)).astype(np.float32)
        elif frontend == "vision":
            b["patches"] = rng.normal(
                0, 0.1, size=(batch, prefix_len, d_model)).astype(np.float32)
        yield b
