"""Data pipeline: deterministic synthetic tokens + memmapped corpora.

Port of ``repro.data.pipeline``, the port's own numpy copy: ``batch_at``
returns the reference's batch bit for bit for the same (seed, step,
shape).  ``batch_at(step)`` is a pure function of (seed, step, shape),
so a restart from any checkpoint replays the exact token stream of an
uninterrupted run.  Batches are host numpy arrays; the trainer moves
each to its device.

The synthetic stream is a Zipf-ish Markov chain: 75% of the tokens are
a fixed hash of the two before, so a small LM has structure to learn.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticTokenDataset:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    order: int = 2            # Markov order of the synthetic language

    def batch_at(self, step: int) -> np.ndarray:
        """(global_batch, seq_len + 1) int32 tokens, pure in (seed, step)."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        B, S, V = self.global_batch, self.seq_len + 1, self.vocab_size
        base = rng.zipf(1.5, size=(B, S)).astype(np.int64)
        toks = np.empty((B, S), np.int64)
        toks[:, 0] = base[:, 0] % V
        mix_a, mix_b = 2654435761, 40503
        for t in range(1, S):
            prev = toks[:, t - 1]
            prev2 = toks[:, t - 2] if t >= 2 else prev
            det = (prev * mix_a + prev2 * mix_b) % V
            use_det = (base[:, t] % 4) != 0          # 75% predictable
            toks[:, t] = np.where(use_det, det, base[:, t] % V)
        return toks.astype(np.int32)


@dataclasses.dataclass
class MemmapTokenDataset:
    """Flat binary token file (uint16/uint32), random crops by step."""

    path: str
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    dtype: str = "uint16"

    def __post_init__(self):
        self._data = np.memmap(self.path, dtype=self.dtype, mode="r")
        if len(self._data) < self.seq_len + 1:
            raise ValueError("token file shorter than one sequence")

    def batch_at(self, step: int) -> np.ndarray:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        hi = len(self._data) - self.seq_len - 1
        starts = rng.integers(0, hi, size=self.global_batch)
        out = np.stack([np.asarray(self._data[s:s + self.seq_len + 1])
                        for s in starts])
        return (out.astype(np.int64) % self.vocab_size).astype(np.int32)


def make_dataset(kind: str, **kw):
    if kind == "synthetic":
        return SyntheticTokenDataset(**kw)
    if kind == "memmap":
        return MemmapTokenDataset(**kw)
    raise KeyError(kind)
