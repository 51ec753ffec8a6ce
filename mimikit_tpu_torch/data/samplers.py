"""Index samplers for training and prompting.

A verbatim copy of ``mimikit_tpu/data/samplers.py``, so that one data seed
draws the same batches in both packages.
:class:`TBPTTSampler` yields batches of start indices that walk contiguous
chunks sequentially, so that RNN hidden state carried across consecutive
batches stays aligned with the data (truncated backprop through time).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

__all__ = ["TBPTTSampler", "IndicesSampler"]


class TBPTTSampler:
    """Yields tuples of start indices for TBPTT training.

    Each "round" picks ``batch_size`` chunk offsets; within a round, batches
    advance by ``seq_len`` through the chunks so consecutive batches are
    time-contiguous per batch lane (reference ``samplers.py:12-47``).
    """

    def __init__(
        self,
        n_samples: int,
        batch_size: int = 64,
        chunk_length: int = 8 * 16000,
        seq_len: int = 512,
        oversampling: int = 1,
        seed: Optional[int] = None,
    ):
        self.n_samples = n_samples
        self.chunk_length = min(chunk_length, n_samples)
        self.seq_len = seq_len
        self.n_chunks = max(
            1, self.n_samples // self.chunk_length - int(oversampling > 1)
        )
        self.remainder = max(self.n_samples % self.chunk_length, 1)
        self.n_per_chunk = self.chunk_length // self.seq_len
        self.batch_size = batch_size
        self.oversampling = oversampling
        self._rng = np.random.RandomState(seed)

    def __iter__(self):
        indices = self._rng.permutation(self.n_chunks * self.oversampling)
        # partial final batch included (torch BatchSampler drop_last=False)
        for b in range(0, len(indices), self.batch_size):
            top = indices[b : b + self.batch_size]
            offsets = self._rng.randint(0, self.remainder, size=len(top))
            top_idx = tuple(
                int(o) + (int(t) % self.n_chunks) * self.chunk_length
                for t, o in zip(top, offsets)
            )
            for start in range(self.n_per_chunk):
                yield tuple(t + start * self.seq_len for t in top_idx)

    def __len__(self):
        n_rounds = -(-(self.oversampling * self.n_chunks) // self.batch_size)
        return n_rounds * self.n_per_chunk


class IndicesSampler:
    """Fixed-or-random prompt positions, optionally redrawn each epoch,
    quantized to ``sampling_stride`` (reference ``samplers.py:50-81``)."""

    def __init__(
        self,
        N: int = 0,
        indices: Tuple[Optional[int], ...] = (),
        min_i: int = 0,
        max_i: Optional[int] = None,
        redraw: bool = True,
        sampling_stride: int = 1,
        seed: Optional[int] = None,
    ):
        self.N = N
        self._indices = indices
        self.min_i = min_i
        self.max_i = max_i
        self.redraw = redraw
        self.sampling_stride = sampling_stride
        self._rng = np.random.RandomState(seed)
        self.indices = self.draw_indices(N, indices)

    def __iter__(self):
        for i in self.indices:
            yield int(i)
        if self.redraw:
            self.indices = self.draw_indices(self.N, self._indices)

    def __len__(self):
        return self.N

    def draw_indices(self, N, indices):
        if isinstance(indices, tuple) and len(indices) > 0:
            return tuple(
                self.sampling_stride
                * (int(self._rng.randint(self.min_i, self.max_i)) // self.sampling_stride)
                if i is None
                else i
                for i in indices
            )
        return self._rng.randint(self.min_i, self.max_i, size=(N,))
