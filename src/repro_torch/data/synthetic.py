"""Deterministic synthetic datasets (numpy only).

Copies of ``repro/data/synthetic.py``'s makers: the same seed gives
bit-identical arrays in both packages.  The paper's datasets are gated
(Human Gait Sensor; CIFAR-10 offline), so the paper loop trains on
shape-matched stand-ins with a planted, learnable structure:

* gait_like  — 28 sensor features, a binary label from a random two-layer
  teacher network plus noise, with a per-subject covariate shift (what
  makes the by-subject client split non-IID).
* image_like — 32x32x3 images in 10 classes: class templates under
  structured noise, CIFAR-10's cardinality.
* token stream — language-model token sequences from a mixture of
  order-2 Markov chains.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


# ---------------------------------------------------------------------------
# Gait-like tabular data
# ---------------------------------------------------------------------------


def make_gait_like(n: int = 40_000, num_features: int = 28,
                   num_subjects: int = 30, noise: float = 0.15,
                   seed: int = 0) -> Dict[str, np.ndarray]:
    """Binary classification with per-subject covariate shift."""
    rng = np.random.default_rng(seed)
    h = 16
    w1 = rng.normal(size=(num_features, h)) / np.sqrt(num_features)
    w2 = rng.normal(size=(h,))
    subj = rng.integers(0, num_subjects, size=n)
    subj_shift = rng.normal(scale=0.8, size=(num_subjects, num_features))
    x = rng.normal(size=(n, num_features)) + subj_shift[subj]
    logits = np.tanh(x @ w1) @ w2
    y = (logits + noise * rng.normal(size=n) > 0).astype(np.int32)
    # standard-scale like the paper's preprocessing
    x = (x - x.mean(0)) / (x.std(0) + 1e-8)
    return {"x": x.astype(np.float32), "y": y, "subject": subj.astype(np.int32)}


# ---------------------------------------------------------------------------
# Image-like data (CIFAR-10 stand-in)
# ---------------------------------------------------------------------------


def make_image_like(n: int = 12_000, size: int = 32, channels: int = 3,
                    num_classes: int = 10, noise: float = 1.8,
                    label_flip: float = 0.15,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Calibrated so the paper's qualitative CIFAR ordering reproduces
    (§V-F: distributed WSSL decisively above centralized): classes share a
    low-frequency background; class identity is a small mid-frequency delta
    under heavy noise, translation jitter, and 15% label noise."""
    rng = np.random.default_rng(seed)

    def field(freq_lo, freq_hi, scale, count):
        out = np.zeros((count, size, size, channels), np.float32)
        for c in range(count):
            f = np.zeros((size, size, channels), np.complex128)
            f[freq_lo:freq_hi, freq_lo:freq_hi] = rng.normal(
                size=(freq_hi - freq_lo, freq_hi - freq_lo, channels))
            t = np.real(np.fft.ifft2(f, axes=(0, 1)))
            out[c] = (t / (t.std() + 1e-8)) * scale
        return out

    base = field(0, 5, 1.0, 4)                       # shared backgrounds
    deltas = field(4, 9, 0.9, num_classes)           # class signatures
    y = rng.integers(0, num_classes, size=n).astype(np.int32)
    bg = rng.integers(0, 4, size=n)
    x = base[bg] + deltas[y] + noise * rng.normal(
        size=(n, size, size, channels))
    # random circular shifts (translation jitter)
    sh = rng.integers(-2, 3, size=(n, 2))
    for i in range(n):
        x[i] = np.roll(np.roll(x[i], sh[i, 0], axis=0), sh[i, 1], axis=1)
    x = (x - x.mean()) / (x.std() + 1e-8)
    if label_flip > 0:
        m = rng.random(n) < label_flip
        y = np.where(m, rng.integers(0, num_classes, n), y).astype(np.int32)
    return {"x": x.astype(np.float32), "y": y}


# ---------------------------------------------------------------------------
# Token streams
# ---------------------------------------------------------------------------


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
