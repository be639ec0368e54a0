"""Request queue + continuous-batching slot admission.

A copy of ``repro/serve/scheduler.py`` (numpy-only), kept in the port so
that it imports nothing of ``repro``.

One :class:`SlotScheduler` manages one replica's fixed set of decode
slots.  Requests join at **slot granularity**: whenever a slot frees up
(its request finished) the next queued request is admitted into it — the
other slots keep decoding; there is no batch-wide barrier and no
recompile, because the decode executable's shapes never change (per-slot
positions carry each request's own depth).

The queue is an **EDF heap** (earliest deadline first, FIFO within equal
deadlines): deadline-less requests all carry ``deadline = inf`` and the
heap degrades to the classic FIFO.  An optional shed predicate lets the
router reject provably-late work at admission time instead of silently
serving it past its deadline.  With a :class:`~repro_torch.serve.blocks.
BlockAllocator` attached, admission additionally reserves the request's
worst-case KV blocks (O(1) free-list check) and blocks head-of-line when
the pool cannot fit the EDF head — slots stop being the only capacity
axis.

Admission, completion, and eviction all happen at **chunk boundaries**
(the engine decodes T tokens per fused call); tokens a request decodes
past its ``max_new`` inside its final chunk are discarded.  A request
re-routed after a replica drop re-enters the queue as
:class:`PendingWork` carrying its already-credited tokens: re-admission
re-prefills the prompt and *replays* the credited suffix through the
decode executable's forced-token lane (see ``engine.decode_chunk``), so
re-routing never needs a new compile and reproduces the clean trajectory
bit-for-bit.
"""

from __future__ import annotations

import dataclasses
import heapq
import math
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Request:
    """One serving request: a prompt, a generation budget, and an optional
    completion deadline (absolute sim time; ``inf`` = no SLO)."""

    rid: int
    prompt: np.ndarray          # (L,) int prompt tokens
    max_new: int                # tokens to generate (incl. the prefill token)
    arrival: float = 0.0        # simulated arrival time
    deadline: float = math.inf  # absolute completion deadline (SLO)

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[0])


@dataclasses.dataclass
class PendingWork:
    """A queued unit of work: a fresh request (``done`` empty) or a
    re-routed one (``done`` carries the tokens already credited on the
    replica that dropped — they will be replayed, not re-credited).
    ``blocks`` are the KV pool blocks reserved at admission (paged mode);
    ``seq`` preserves FIFO order among equal deadlines in the EDF heap."""

    req: Request
    done: List[int] = dataclasses.field(default_factory=list)
    blocks: Optional[List[int]] = None
    seq: int = 0


@dataclasses.dataclass
class ActiveSlot:
    """A request resident in a decode slot."""

    work: PendingWork
    replay: List[int] = dataclasses.field(default_factory=list)

    @property
    def req(self) -> Request:
        return self.work.req

    @property
    def done(self) -> List[int]:
        return self.work.done

    @property
    def finished(self) -> bool:
        return len(self.work.done) >= self.work.req.max_new


def synthetic_requests(cfg, n: int, *, prompt_len: int, gen: int,
                       seed: int = 0,
                       arrival_spacing: float = 0.0) -> List[Request]:
    """A mixed-length synthetic request set (the serving workload the CLI,
    benchmark, and tests share): prompt lengths in [prompt_len/2,
    prompt_len], generation budgets in [max(gen/2, 2), gen], optionally
    staggered arrivals."""
    from repro_torch.data.synthetic import make_token_stream
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(n):
        plen = int(rng.integers(prompt_len // 2, prompt_len + 1))
        g = int(rng.integers(max(gen // 2, 2), gen + 1))
        prompt = np.asarray(make_token_stream(1, plen, cfg.vocab_size,
                                              seed=seed + rid))[0]
        reqs.append(Request(rid=rid, prompt=prompt, max_new=g,
                            arrival=rid * arrival_spacing))
    return reqs


class SlotScheduler:
    """EDF queue + slot table for one replica (FIFO when no deadlines)."""

    def __init__(self, num_slots: int, allocator=None,
                 reserve_margin: int = 0, max_reserve: int = 0):
        assert num_slots >= 1
        self.num_slots = num_slots
        # heap of (deadline, seq, work); len(queue) is the queue depth
        self.queue: List[Tuple[float, int, PendingWork]] = []
        self.slots: List[Optional[ActiveSlot]] = [None] * num_slots
        self.allocator = allocator
        self.reserve_margin = reserve_margin
        self.max_reserve = max_reserve        # cache length cap (paged mode)
        self.shed: List[PendingWork] = []
        self._seq = 0

    # -- queue -------------------------------------------------------------

    def submit(self, work: PendingWork) -> None:
        work.seq = self._seq
        self._seq += 1
        heapq.heappush(self.queue, (work.req.deadline, work.seq, work))

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(s is not None for s in self.slots)

    @property
    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    def _tokens_needed(self, req: Request) -> int:
        """Worst-case KV entries a request can touch: prompt + budget +
        the chunk/draft overshoot margin, capped at the cache length (a
        slot's logical address space is max_len entries)."""
        need = req.prompt_len + req.max_new + self.reserve_margin
        return min(need, self.max_reserve) if self.max_reserve else need

    # -- admission (slot granularity, EDF) ---------------------------------

    def admissions(self, shed: Optional[Callable[[PendingWork], bool]] = None
                   ) -> Iterator[Tuple[int, PendingWork]]:
        """Yield (slot, work) pairs filling free slots in EDF order.  The
        caller prefills each admission and then calls :meth:`activate`.

        ``shed(work) == True`` rejects the work instead of admitting it
        (collected in ``self.shed`` for the router to report).  With an
        allocator attached, each admission reserves its worst-case blocks
        first; if the pool cannot fit the EDF head, admission stops —
        head-of-line blocking is deliberate, so a large early-deadline
        request is never starved by small late-deadline ones."""
        for i, s in enumerate(self.slots):
            if s is not None:
                continue
            work = None
            while self.queue:
                _, _, cand = heapq.heappop(self.queue)
                if shed is not None and shed(cand):
                    self.shed.append(cand)
                    continue
                if self.allocator is not None and cand.blocks is None:
                    need = self._tokens_needed(cand.req)
                    if not self.allocator.can_fit(need):
                        heapq.heappush(self.queue,
                                       (cand.req.deadline, cand.seq, cand))
                        break
                    cand.blocks = self.allocator.allocate(need)
                work = cand
                break
            if work is None:
                break
            yield i, work

    def activate(self, slot: int, work: PendingWork,
                 first_token: int) -> ActiveSlot:
        """Install admitted work in ``slot``.  Fresh work credits the
        prefill token; re-routed work re-derived the same first token and
        queues the remaining credited tokens for replay."""
        assert self.slots[slot] is None
        if not work.done:
            work.done.append(int(first_token))
            replay: List[int] = []
        else:
            replay = list(work.done[1:])
        active = ActiveSlot(work=work, replay=replay)
        self.slots[slot] = active
        return active

    def active(self) -> Iterator[Tuple[int, ActiveSlot]]:
        for i, s in enumerate(self.slots):
            if s is not None:
                yield i, s

    def release(self, slot: int) -> None:
        s = self.slots[slot]
        if s is not None and self.allocator is not None and s.work.blocks:
            self.allocator.free(s.work.blocks)
            s.work.blocks = None
        self.slots[slot] = None

    # -- chunk plumbing ----------------------------------------------------

    def force_buffers(self, chunk: int) -> Tuple[np.ndarray, np.ndarray]:
        """(B, T) forced tokens + (B,) force lengths for the next chunk:
        each slot replays up to T of its pending replay tokens."""
        forced = np.zeros((self.num_slots, chunk), np.int32)
        force_len = np.zeros((self.num_slots,), np.int32)
        for i, s in self.active():
            n = min(len(s.replay), chunk)
            if n:
                forced[i, :n] = s.replay[:n]
                force_len[i] = n
        return forced, force_len

    def credit_chunk(self, tokens: np.ndarray
                     ) -> Tuple[List[Tuple[int, ActiveSlot]], int]:
        """Distribute one chunk's (B, T) tokens: consume replay first, then
        credit new tokens up to each request's ``max_new``.  Returns the
        slots that finished (not yet released) and the number of tokens
        newly credited this chunk (replayed tokens are not re-credited)."""
        chunk = tokens.shape[1]
        finished: List[Tuple[int, ActiveSlot]] = []
        credited = 0
        for i, s in self.active():
            consumed = min(len(s.replay), chunk)
            del s.replay[:consumed]
            new = tokens[i, consumed:]
            need = s.req.max_new - len(s.done)
            if need > 0:
                take = new[:need]
                s.done.extend(int(t) for t in take)
                credited += len(take)
            if s.finished and not s.replay:
                finished.append((i, s))
        return finished, credited

    def credit_spec(self, tokens: np.ndarray, counts: np.ndarray
                    ) -> Tuple[List[Tuple[int, ActiveSlot]], int]:
        """Distribute one speculative round's tokens: slot ``i`` emitted
        the first ``counts[i]`` entries of ``tokens[i]`` (verified greedy
        tokens).  The router only speculates when no slot is replaying —
        the replay lane rides normal chunks."""
        finished: List[Tuple[int, ActiveSlot]] = []
        credited = 0
        for i, s in self.active():
            assert not s.replay, "speculative rounds never overlap replay"
            need = s.req.max_new - len(s.done)
            take = tokens[i, :min(int(counts[i]), need)]
            s.done.extend(int(t) for t in take)
            credited += len(take)
            if s.finished:
                finished.append((i, s))
        return finished, credited

    # -- fault handling ----------------------------------------------------

    def drain(self) -> List[PendingWork]:
        """Dump all state (replica drop): active slots re-enter the world
        as re-routable work carrying their credited tokens; queued work
        follows in EDF order.  Block reservations die with the replica's
        pool (the allocator is reset wholesale).  The scheduler is empty
        afterwards."""
        moved: List[PendingWork] = []
        for i, s in list(self.active()):
            moved.append(s.work)
            self.slots[i] = None
        while self.queue:
            moved.append(heapq.heappop(self.queue)[2])
        for w in moved:
            w.blocks = None
        if self.allocator is not None:
            self.allocator.reset()
        return moved
