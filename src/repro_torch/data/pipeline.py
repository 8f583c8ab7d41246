"""Deterministic synthetic token pipeline (offline substrate).

A copy of ``repro.data.pipeline``: reproducible LM batches with a simple
learnable structure (a fixed random transition table with 10 % noise),
so short training runs show a real loss decrease.  Numpy only: the same
seed gives the JAX package's batches bit for bit.  Where the JAX module
places a host batch on a mesh (``as_global_array``), the port moves it
to one device (:func:`to_device`).
"""

from __future__ import annotations

import numpy as np
import torch


class SyntheticTokens:
    """Infinite iterator of {tokens, labels} batches."""

    def __init__(self, vocab_size: int, seq_len: int, batch: int,
                 seed: int = 0):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = batch
        self.rng = np.random.default_rng(seed)
        # fixed random transition table -> learnable structure
        self._next = self.rng.integers(0, vocab_size,
                                       size=(vocab_size,), dtype=np.int32)

    def __iter__(self):
        return self

    def __next__(self):
        start = self.rng.integers(0, self.vocab, size=(self.batch, 1),
                                  dtype=np.int32)
        seqs = [start]
        noise = self.rng.random((self.batch, self.seq)) < 0.1
        for t in range(self.seq):
            nxt = self._next[seqs[-1][:, 0]][:, None]
            rand = self.rng.integers(0, self.vocab, size=(self.batch, 1),
                                     dtype=np.int32)
            seqs.append(np.where(noise[:, t:t + 1], rand, nxt))
        toks = np.concatenate(seqs, axis=1)
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


def to_device(batch: dict, device) -> dict:
    """Host numpy batch -> tensors on ``device`` (int32 stays int32)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
