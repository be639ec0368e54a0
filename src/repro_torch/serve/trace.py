"""Load-scenario serving: a model-free engine and bursty request traces.

The router's control plane (EDF admission, shedding, autoscaling, fault
re-routing, byte accounting) is pure host logic — it never looks inside
the engine beyond the ``DecodeEngine`` surface.  :class:`SimEngine`
implements that surface with a deterministic integer recurrence instead
of a transformer, so million-request routing experiments (and the
``benchmarks/serve_bench.py`` trace) run at host speed while exercising
exactly the same scheduler/router/allocator code paths as real serving —
including the speculative accept/rollback arithmetic, whose token streams
must stay bit-identical to greedy just like the real engine's.

A copy of ``repro/serve/trace.py`` (numpy-only), kept in the port so that
it imports nothing of ``repro``; ``SimEngine`` builds the port's
``BatchState``.

``bursty_trace`` generates the matching workload: a steady arrival
baseline punctuated by synchronized bursts, mixed prompt/generation
lengths, and a mix of tight/loose/absent deadlines — the shape that makes
EDF + shedding + autoscaling do real work.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.serve.engine import BatchState
from repro_torch.serve.scheduler import Request

_A, _B, _C = 7919, 104729, 12345   # primes; int64-safe for vocab < 2**31


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """The slice of ModelConfig the router's byte accounting reads."""

    d_model: int = 256
    vocab_size: int = 32000
    dtype: str = "float32"
    num_layers: int = 8


class SimEngine:
    """Deterministic stand-in for
    :class:`~repro_torch.serve.engine.DecodeEngine`.

    The "model" is the integer recurrence ``next = (tok·7919 + pos·104729
    + 12345) mod vocab`` — a pure function of (token, position), so
    re-prefill + replay after a fault reproduces the clean trajectory
    bit-for-bit, exactly like the real greedy engine.  Speculative rounds
    draft with a perturbed copy of the recurrence (every position divisible
    by ``draft_divergence`` drafts wrong) and verify against the true one,
    so acceptance is partial but emitted tokens are always the greedy
    stream.  Compile counters tick once per distinct shape, mirroring the
    AOT engine's once-per-shape behavior."""

    def __init__(self, cfg: SimConfig = SimConfig(), *, num_hops: int = 1,
                 draft_divergence: int = 5, draft_fraction: float = 0.3):
        self.cfg = cfg
        self.num_hops = num_hops
        self.draft_divergence = max(int(draft_divergence), 1)
        self.draft_fraction = float(draft_fraction)
        self.decode_compiles = 0
        self.prefill_compiles = 0
        self.draft_compiles = 0
        self.verify_compiles = 0
        self._shapes = set()

    def _count(self, counter: str, key: Tuple) -> None:
        if key not in self._shapes:
            self._shapes.add(key)
            setattr(self, counter, getattr(self, counter) + 1)

    def _step(self, tok: np.ndarray, pos: np.ndarray) -> np.ndarray:
        tok = tok.astype(np.int64)
        pos = pos.astype(np.int64)
        return ((tok * _A + pos * _B + _C) % self.cfg.vocab_size).astype(
            np.int64)

    # -- DecodeEngine surface ----------------------------------------------

    def new_batch_state(self, slots: int, max_len: int, *,
                        block_size: int = 0,
                        pool_blocks: int = 0) -> BatchState:
        table = None
        if block_size:
            if max_len % block_size:
                raise ValueError("max_len must be a multiple of block_size")
            nb = max_len // block_size
            table = np.repeat(np.arange(slots, dtype=np.int32)[:, None],
                              nb, axis=1)
        return BatchState(cache=None,
                          tok=np.zeros((slots,), np.int64),
                          pos=np.ones((slots,), np.int64),
                          max_len=max_len, table=table,
                          block_size=block_size)

    def admit(self, state: BatchState, params, prompt: np.ndarray,
              slot: int, blocks: Optional[Sequence[int]] = None) -> int:
        prompt = np.asarray(prompt)
        length = int(prompt.shape[0])
        if length >= state.max_len:
            raise ValueError(f"prompt of length {length} does not fit "
                             f"max_len={state.max_len}")
        if state.table is not None:
            if blocks is None:
                raise ValueError("paged admission needs reserved blocks")
            nb = state.table.shape[1]
            row = np.full((nb,), slot, np.int32)
            row[:len(blocks)] = np.asarray(blocks, np.int32)
            state.table[slot] = row
            state.mark_table_dirty()
        self._count("prefill_compiles", ("prefill", 1, length))
        tok0 = int(self._step(np.asarray(prompt[-1]),
                              np.asarray(length - 1)))
        state.tok[slot] = tok0
        state.pos[slot] = length
        return tok0

    def decode_chunk(self, state: BatchState, params, forced: np.ndarray,
                     force_len: np.ndarray, rng,
                     temperature: float = 0.0) -> np.ndarray:
        forced = np.asarray(forced)
        force_len = np.asarray(force_len)
        b, t = forced.shape
        self._count("decode_compiles", ("chunk", b, t))
        toks = np.zeros((b, t), np.int64)
        tok, pos = state.tok, state.pos
        for j in range(t):
            out = self._step(tok, pos)
            use_forced = j < force_len
            out = np.where(use_forced, forced[:, j], out)
            toks[:, j] = out
            tok = out
            pos = pos + 1
        state.tok, state.pos = tok, pos
        return toks

    def spec_chunk(self, state: BatchState, params, draft_k: int
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        b = state.tok.shape[0]
        self._count("draft_compiles", ("draft", b, draft_k))
        self._count("verify_compiles", ("verify", b, draft_k))
        g = np.zeros((b, draft_k), np.int64)
        draft = np.zeros((b, draft_k), np.int64)
        tok, pos = state.tok, state.pos
        for j in range(draft_k):
            out = self._step(tok, pos)
            bad = (pos % self.draft_divergence) == 0
            draft[:, j] = np.where(bad, (out + 1) % self.cfg.vocab_size,
                                   out)
            g[:, j] = out
            tok = out          # verifier trajectory (the true greedy one)
            pos = pos + 1
        mism = draft != g
        acc = np.where(mism.any(axis=1), np.argmax(mism, axis=1), draft_k)
        n = np.minimum(acc + 1, draft_k)
        rows = np.arange(b)
        state.tok = g[rows, n - 1]
        state.pos = state.pos + n
        return g, acc.astype(np.int64), n.astype(np.int64)


def bursty_trace(n: int, *, prompt_len: int = 16, gen: int = 16,
                 vocab_size: int = 32000, seed: int = 0,
                 base_spacing: float = 2.0, burst_every: int = 256,
                 burst_size: int = 64, deadline_frac: float = 0.5,
                 slack: Tuple[float, float] = (1.5, 20.0)
                 ) -> List[Request]:
    """``n`` requests with bursty arrivals and mixed SLOs.

    Arrivals advance ``base_spacing`` per request, except that every
    ``burst_every``-th request opens a burst: the next ``burst_size``
    requests land at the same instant (a flash crowd).  ``deadline_frac``
    of requests carry a deadline at ``arrival + ideal_latency · s`` with
    slack ``s`` drawn log-uniformly from ``slack`` — the tight end is
    shed bait, the loose end is comfortably servable — and the rest are
    deadline-less batch traffic."""
    rng = np.random.default_rng(seed)
    plens = rng.integers(max(prompt_len // 2, 1), prompt_len + 1, size=n)
    gens = rng.integers(max(gen // 2, 2), gen + 1, size=n)
    has_dl = rng.random(n) < deadline_frac
    lo, hi = slack
    slacks = np.exp(rng.uniform(math.log(lo), math.log(hi), size=n))
    reqs: List[Request] = []
    now = 0.0
    burst_left = 0
    for rid in range(n):
        if burst_every and rid and rid % burst_every == 0:
            burst_left = burst_size
        if burst_left > 0:
            burst_left -= 1          # arrive with the crowd: no spacing
        else:
            now += base_spacing
        plen = int(plens[rid])
        g = int(gens[rid])
        prompt = ((np.arange(plen, dtype=np.int64) * _A + rid * _B + _C)
                  % vocab_size)
        ideal = plen * 0.25 + g      # prefill_unit=0.25 decode-units/token
        deadline = (now + ideal * float(slacks[rid])
                    if has_dl[rid] else math.inf)
        reqs.append(Request(rid=rid, prompt=prompt, max_new=g,
                            arrival=now, deadline=deadline))
    return reqs
