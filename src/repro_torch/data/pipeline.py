"""Per-client batched loaders with epoch shuffling (numpy-side; the
training loop moves each batch to the device).

A copy of ``repro/data/pipeline.py``: the same seed gives the same
batches in both packages."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


class ClientLoader:
    """Cycling batch iterator over one client's index set."""

    def __init__(self, data: Dict[str, np.ndarray], indices: np.ndarray,
                 batch_size: int, seed: int = 0):
        self.data = data
        self.indices = np.asarray(indices)
        self.batch_size = batch_size
        self.rng = np.random.default_rng(seed)
        self._order = self.rng.permutation(len(self.indices))
        self._cursor = 0

    def __len__(self):
        return max(len(self.indices) // self.batch_size, 1)

    def next_batch(self) -> Dict[str, np.ndarray]:
        bs = self.batch_size
        if len(self.indices) < bs:
            # sample with replacement when a client is data-poor
            pick = self.rng.choice(self.indices, size=bs, replace=True)
        else:
            if self._cursor + bs > len(self._order):
                self._order = self.rng.permutation(len(self.indices))
                self._cursor = 0
            pick = self.indices[self._order[self._cursor:self._cursor + bs]]
            self._cursor += bs
        return {k: v[pick] for k, v in self.data.items()}


def stacked_client_batch(loaders: List[ClientLoader]) -> Dict[str, np.ndarray]:
    """One batch per client, stacked on a leading client axis."""
    batches = [ld.next_batch() for ld in loaders]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}
