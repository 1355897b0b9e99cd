"""LM token pipeline (the reference's ``data/tokens.py``): deterministic
synthetic streams and packed file-backed datasets.

Host numpy code, bit-equal to the reference's: the same
``np.random.default_rng`` draws in the same order.  Synthetic batches are
a seeded stream with local n-gram structure (so losses go down in the
example training runs and convergence is assertable in tests); the
file-backed path memory-maps a flat uint16/uint32 token file and yields
packed (tokens, labels, mask) rows.  The batches are numpy arrays; a
:class:`~repro_torch.data.prefetch.Prefetcher` uploads them.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class TokenDataset:
    """Memory-mapped flat token file, packed into fixed-length rows."""
    path: str
    seq_len: int
    vocab: int
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")

    def __len__(self):
        return (len(self._data) - 1) // self.seq_len

    def batches(self, batch: int, *, seed: int = 0,
                host_id: int = 0, n_hosts: int = 1) -> Iterator[dict]:
        """Shuffled, host-sharded epoch iterator (each host reads only its
        1/n_hosts row subset)."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(self))[host_id::n_hosts]
        for lo in range(0, len(order) - batch + 1, batch):
            rows = order[lo:lo + batch]
            tok = np.stack([
                self._data[r * self.seq_len: r * self.seq_len + self.seq_len + 1]
                for r in rows]).astype(np.int32)
            yield {
                "tokens": tok[:, :-1] % self.vocab,
                "labels": tok[:, 1:] % self.vocab,
                "mask": np.ones((batch, self.seq_len), np.float32),
            }


def synthetic_lm_batches(vocab: int, seq_len: int, batch: int, *,
                         seed: int = 0, order: int = 2) -> Iterator[dict]:
    """Infinite synthetic stream with learnable order-``order`` structure:
    token_t = (a * token_{t-1} + b * token_{t-order}) mod vocab, replaced
    by a uniform draw with probability 0.1.  A model that learns the
    linear rule drops well below the unigram entropy."""
    rng = np.random.default_rng(seed)
    a, b = 31, 17
    while True:
        tok = np.zeros((batch, seq_len + 1), np.int64)
        tok[:, :order] = rng.integers(0, vocab, (batch, order))
        noise = (rng.random((batch, seq_len + 1)) < 0.1)
        for t in range(order, seq_len + 1):
            nxt = (a * tok[:, t - 1] + b * tok[:, t - order]) % vocab
            rnd = rng.integers(0, vocab, batch)
            tok[:, t] = np.where(noise[:, t], rnd, nxt)
        yield {
            "tokens": tok[:, :-1].astype(np.int32),
            "labels": tok[:, 1:].astype(np.int32),
            "mask": np.ones((batch, seq_len), np.float32),
        }
