"""Deterministic synthetic token streams (numpy only).

A copy of ``repro/data/synthetic.py::make_token_stream`` and ``lm_batch``:
the same seed gives bit-identical streams in both packages.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def make_token_stream(n_seqs: int, seq_len: int, vocab: int,
                      seed: int = 0, order: int = 2) -> np.ndarray:
    """Mixture of Markov chains over a reduced alphabet mapped into vocab."""
    rng = np.random.default_rng(seed)
    k = min(vocab, 64)
    trans = rng.dirichlet(np.ones(k) * 0.3, size=(4, k))
    out = np.zeros((n_seqs, seq_len), np.int32)
    for i in range(n_seqs):
        chain = rng.integers(0, 4)
        s = rng.integers(0, k)
        for t in range(seq_len):
            s = rng.choice(k, p=trans[chain, s])
            out[i, t] = s
    # map alphabet into the full vocab range deterministically
    lift = (np.arange(k) * max(vocab // k, 1)) % vocab
    return lift[out].astype(np.int32)


def lm_batch(n_seqs: int, seq_len: int, vocab: int, seed: int = 0
             ) -> Dict[str, np.ndarray]:
    """Next-token pairs: ``tokens`` and ``labels`` (n_seqs, seq_len), the
    labels shifted by one (a copy of ``repro/data/synthetic.py::lm_batch``)."""
    toks = make_token_stream(n_seqs, seq_len + 1, vocab, seed)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
