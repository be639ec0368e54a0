"""The decode engine: prefill one request into a slot, then advance every
slot a chunk of tokens at a time.

The PyTorch twin of ``repro/serve/engine.py``.  The JAX engine compiles
one ``lax.scan`` executable per shape; here the chunk is a Python loop of
``decode_step`` calls (CUDA graphs for the chunk are later work), and the
compile counters count the distinct shape keys the engine has run, which
is what the JAX counters pin.  The engine is params-free: parameters are
an argument of every call, so replicas share one engine.

Caches are updated in place where the JAX engine donated its buffers.
Every ported layer kind serves: global attention (contiguous or paged),
local attention (a ring per slot), and the SSM and RG-LRU states (one row
per slot).  Prefill is exact-length, never padded, so no pad token enters
a recurrent state.  An MoE layer routes the tokens of each call as one
batch, its expert capacity set by their count, as in JAX: an admission's
prompt, and at decode every slot, dead ones included.

Split mode (``cuts``) decodes through the client -> edge -> server stages
(``transformer.split_decode_step``): the same logits, every step crossing
``len(cuts)`` activation hops, which the router accounts.  Speculative
decode (``spec_chunk``) drafts with the client stage at ``spec_cut`` read
out through the early-exit head, verifies the drafts in one teacher-forced
pass of the whole model and rolls every cache family back exactly.

``decode_window_override`` (the long-context decode window) makes every
global layer a ring of that window in every cache the engine builds, in
admission, the decode chunk, draft, verify and split mode alike: such a
ring never pages (the paged kernel then has no layer to run), the prompt
still attends in full at admission and keeps its last ``window`` entries,
and speculative rollback restores the ring's overwritten lines as it does
a local layer's.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, WSSLConfig
from repro_torch.models import transformer as tf
from repro_torch.models.layers import resolve_device

Params = Any

# the prefill paths the engine serves: the plain one and the flash kernel
SERVE_IMPLS = ("dense", "kernel", "pallas")


@dataclasses.dataclass
class BatchState:
    """Mutable per-replica decode state: the batched cache plus each slot's
    current token and next absolute position.

    In paged mode (``block_size > 0``) the KV lives in a shared block pool
    and ``table`` maps each slot's logical blocks to pool blocks.  The table
    is host-side numpy; whoever rewrites a row calls
    :meth:`mark_table_dirty`, and :meth:`device_table` re-uploads only
    then."""

    cache: Params
    tok: torch.Tensor   # (B, 1) int32 — last token per slot
    pos: torch.Tensor   # (B,)   int32 — next absolute position per slot
    max_len: int
    table: Optional[np.ndarray] = None   # (B, nb) int32 block table
    block_size: int = 0
    _table_dev: Optional[torch.Tensor] = dataclasses.field(
        default=None, repr=False)
    _table_dirty: bool = True

    def mark_table_dirty(self) -> None:
        """Host-side ``table`` rows changed; the next chunk re-uploads."""
        self._table_dirty = True

    def device_table(self) -> Optional[torch.Tensor]:
        if self.table is None:
            return None
        if self._table_dev is None or self._table_dirty:
            self._table_dev = torch.as_tensor(self.table, dtype=torch.int32,
                                              device=self.pos.device)
            self._table_dirty = False
        return self._table_dev


def _layer_caches(cache: Params):
    """(stacked, layer cache dict) for every cache entry of the tree:
    stacked entries carry the leading layer axis (batch at axis 1)."""
    for d in cache["stack"]:
        yield True, d
    for d in cache["rem"]:
        yield False, d


def _is_recurrent(d: Params) -> bool:
    """SSM / RG-LRU layer caches: cumulative state (and conv windows)."""
    return "state" in d or "h" in d


def _is_ring(d: Params, max_len: int) -> bool:
    """A ring (a local layer's, or a global one's under the decode-window
    override): contiguous KV shorter than ``max_len``, whose decode writes
    wrap onto entries that may still be visible."""
    return "pos" in d and d["pos"].shape[-1] < max_len


def _copy_row(d: Params, s: Params, slot: int, stacked: bool) -> None:
    """Replace row ``slot`` of every leaf of layer cache ``d`` with row 0
    of ``s``, in place."""
    for key in d:
        if stacked:
            d[key][:, slot] = s[key][:, 0]
        else:
            d[key][slot] = s[key][0]


def _scatter_slot(dst: Params, src: Params, slot: int) -> None:
    """Write a batch-1 contiguous cache into row ``slot`` of a batched one,
    in place.  The whole row is replaced, which also wipes any stale
    validity (and recurrent state) from the slot's previous occupant."""
    for (stacked, d), (_, s) in zip(_layer_caches(dst), _layer_caches(src)):
        _copy_row(d, s, slot, stacked)


def _scatter_slot_paged(dst: Params, src: Params, slot: int,
                        blocks: Sequence[int], block_size: int) -> None:
    """Paged admission, in place: reshape the batch-1 contiguous prefill
    cache into blocks and write ONLY the ``len(blocks)`` reserved pool
    blocks (the tail blocks of the reservation carry fresh -1 entries,
    wiping their previous owner).  The slot's scratch block gets its
    ``ppos`` row wiped to -1: its stale K/V is never read, but a stale
    position from the slot's empty-phase garbage decode would pass the
    validity mask.  Layers that are not paged — local rings, SSM and
    RG-LRU states — keep the per-row layout and take the row copy."""
    nr = len(blocks)
    for (stacked, d), (_, s) in zip(_layer_caches(dst), _layer_caches(src)):
        if "pk" not in d:
            _copy_row(d, s, slot, stacked)
            continue
        idx = torch.as_tensor(np.asarray(blocks), dtype=torch.long,
                              device=d["pk"].device)
        lead = 1 if stacked else 0

        def resh(a):   # ([L,] 1, max_len, ...) -> ([L,] nr, bs, ...)
            a = a.select(lead, 0)
            nb = a.shape[lead] // block_size
            return a.reshape(a.shape[:lead] + (nb, block_size)
                             + a.shape[lead + 1:]).narrow(lead, 0, nr)

        for pool, key in (("pk", "k"), ("pv", "v"), ("ppos", "pos")):
            if stacked:
                d[pool][:, idx] = resh(s[key])
            else:
                d[pool][idx] = resh(s[key])
        if stacked:
            d["ppos"][:, slot] = -1
        else:
            d["ppos"][slot] = -1


class DecodeEngine:
    """Decode engine for one architecture on one device.

    ``impl`` picks the prefill attention ("dense" or "kernel"; "pallas" is
    an alias of "kernel"); ``paged_kernel`` sends paged decode through the
    CUDA block-table kernel instead of the gather.  ``cuts`` serves through
    the pipeline stages at those WSSL cuts instead of the merged model.
    ``spec_cut`` is the draft model's cut (default: ``cuts[0]`` in split
    mode, else the WSSL default cut).  ``decode_window_override`` decodes
    every global layer within that many positions (a ring cache).
    ``device`` defaults to the card and raises when there is none."""

    def __init__(self, cfg: ModelConfig, *, impl: str = "dense",
                 cuts: Optional[Sequence[int]] = None,
                 decode_window_override: Optional[int] = None,
                 spec_cut: Optional[int] = None,
                 paged_kernel: bool = False, device="cuda"):
        if impl not in SERVE_IMPLS:
            raise ValueError(f"unknown attn impl {impl!r} for the engine: it "
                             f"prefills with {SERVE_IMPLS}")
        tf._superblock_layout(cfg)        # raises on an unported layer kind
        self.cfg = cfg
        self.impl = impl
        self.cuts = tf._check_cuts(cfg, cuts) if cuts else None
        self.decode_window_override = decode_window_override
        if spec_cut is None:
            # the draft model is the client stage: in split mode that stage
            # exists at cuts[0]; merged mode drafts at the WSSL default cut
            # (cut 0, an embedding-only draft, is legal)
            spec_cut = (self.cuts[0] if self.cuts
                        else WSSLConfig().resolve_split(cfg))
        self.spec_cut = tf._check_cuts(cfg, (spec_cut,))[0]
        self.paged_kernel = bool(paged_kernel)
        self.device = resolve_device(device)
        self._shape_keys = set()
        self.decode_compiles = 0
        self.prefill_compiles = 0
        self.draft_compiles = 0
        self.verify_compiles = 0
        # decode steps run, by kind: a chunk's, a draft's, a verify's
        self.steps = {"decode": 0, "draft": 0, "verify": 0}

    # -- topology ----------------------------------------------------------

    @property
    def num_stages(self) -> int:
        return len(self.cuts) + 1 if self.cuts else 1

    @property
    def num_hops(self) -> int:
        """Activation crossings per decode step (0 for the merged model)."""
        return len(self.cuts) if self.cuts else 0

    @property
    def draft_fraction(self) -> float:
        """Cost of one draft step against a full decode step: the layers up
        to the spec cut plus the early-exit readout (counted as one layer).
        The router prices the speculative clock with it."""
        return (self.spec_cut + 1) / (self.cfg.num_layers + 1)

    def _count(self, kind: str, key: Tuple) -> None:
        """Count a new shape key, as the JAX engine counts compilations."""
        if (kind,) + key in self._shape_keys:
            return
        self._shape_keys.add((kind,) + key)
        counter = {"chunk": "decode_compiles"}.get(kind, f"{kind}_compiles")
        setattr(self, counter, getattr(self, counter) + 1)

    @staticmethod
    def _cache_shapes(cache: Params) -> Tuple:
        return tuple(tuple(t.shape) for _, d in _layer_caches(cache)
                     for t in d.values())

    def _prefill(self, params: Params, prompts: torch.Tensor,
                 cache: Params) -> torch.Tensor:
        """Prefill ``prompts`` into ``cache`` (in place) -> the greedy next
        token (B, 1) int32.  Split mode prefills the merged model too: the
        stages would compute the same cache."""
        self._count("prefill", tuple(prompts.shape) + self._cache_shapes(cache))
        logits, _ = tf.prefill(params, self.cfg, prompts, cache=cache,
                               impl=self.impl, last_only=True)
        return torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)

    def _stepper(self, params: Params, cache: Params,
                 table: Optional[torch.Tensor]):
        """``step(tok (B, 1), pos (B,)) -> logits (B, V)``: one decode step of
        the merged model, or of the pipeline stages in split mode (params
        and cache partitioned once, as views), updating ``cache`` in
        place."""
        kw = dict(decode_window_override=self.decode_window_override,
                  table=table, paged_kernel=self.paged_kernel)
        if self.cuts is None:
            def step(tok, pos):
                return tf.decode_step(params, self.cfg, tok, cache, pos,
                                      **kw)[0][:, 0]
            return step
        stages = tf.partition_params(params, self.cfg, self.cuts, copy=False)
        caches = tf.partition_cache(cache, self.cfg, self.cuts)

        def step(tok, pos):
            return tf.split_decode_step(stages, self.cfg, tok, caches, pos,
                                        **kw)[0][:, 0]
        return step

    # -- cache / state -----------------------------------------------------

    def init_cache(self, batch: int, max_len: int,
                   paged: Optional[Tuple[int, int]] = None) -> Params:
        return tf.init_cache(
            self.cfg, batch, max_len,
            decode_window_override=self.decode_window_override, paged=paged,
            device=self.device)

    def new_batch_state(self, slots: int, max_len: int, *,
                        block_size: int = 0,
                        pool_blocks: int = 0) -> BatchState:
        """Empty slots decode garbage in lockstep with the live ones — safely,
        because decode writes each row's K/V before it masks, so even an
        empty row attends to its own fresh entry.  Admission replaces the
        row.

        ``block_size > 0`` switches the KV to a paged pool of
        ``pool_blocks`` blocks (default: every slot can hold ``max_len``,
        plus one scratch block per slot).  Fresh table rows point every
        logical block at the slot's scratch block."""
        tok = torch.zeros((slots, 1), dtype=torch.int32, device=self.device)
        pos = torch.ones((slots,), dtype=torch.int32, device=self.device)
        if not block_size:
            return BatchState(cache=self.init_cache(slots, max_len), tok=tok,
                              pos=pos, max_len=max_len)
        if max_len % block_size:
            raise ValueError(
                f"max_len {max_len} must be a multiple of block_size "
                f"{block_size} (the table maps whole blocks)")
        nb = max_len // block_size
        if not pool_blocks:
            pool_blocks = slots * (nb + 1)
        if pool_blocks <= slots:
            raise ValueError(
                f"pool_blocks {pool_blocks} leaves no allocatable blocks "
                f"after {slots} per-slot scratch blocks")
        cache = self.init_cache(slots, max_len, paged=(pool_blocks, block_size))
        table = np.repeat(np.arange(slots, dtype=np.int32)[:, None], nb, axis=1)
        return BatchState(cache=cache, tok=tok, pos=pos, max_len=max_len,
                          table=table, block_size=block_size)

    # -- serving primitives ------------------------------------------------

    def admit(self, state: BatchState, params: Params, prompt: np.ndarray,
              slot: int, blocks: Optional[Sequence[int]] = None) -> int:
        """Prefill one request at its exact prompt length into ``slot``;
        returns its first generated token (greedy over the last prompt
        position).

        Paged mode: ``blocks`` are the pool blocks reserved for the request
        (allocator order == logical order); the table row maps the rest of
        the logical blocks to the slot's scratch block."""
        prompt_t = torch.as_tensor(np.asarray(prompt), dtype=torch.int32,
                                   device=self.device)[None]
        length = prompt_t.shape[1]
        if length >= state.max_len:
            raise ValueError(
                f"prompt of length {length} does not fit a max_len="
                f"{state.max_len} cache with room to decode")
        cache1 = self.init_cache(1, state.max_len)
        tok = self._prefill(params, prompt_t, cache1)
        if state.table is not None:
            if blocks is None:
                raise ValueError("paged admission needs the request's reserved "
                                 "blocks (BlockAllocator.allocate)")
            row = np.full((state.table.shape[1],), slot, np.int32)
            row[:len(blocks)] = np.asarray(blocks, np.int32)
            state.table[slot] = row
            state.mark_table_dirty()
            _scatter_slot_paged(state.cache, cache1, slot, blocks,
                                state.block_size)
        else:
            _scatter_slot(state.cache, cache1, slot)
        state.tok[slot] = tok[0]
        state.pos[slot] = length
        return int(tok[0, 0])

    def decode_chunk(self, state: BatchState, params: Params,
                     forced: np.ndarray, force_len: np.ndarray,
                     generator: Optional[torch.Generator] = None,
                     temperature: float = 0.0) -> np.ndarray:
        """Advance every slot by ``forced.shape[1]`` tokens.  Slot ``b``
        takes ``forced[b, t]`` for ``t < force_len[b]`` (replay), else the
        greedy token, or one sampled at ``temperature`` from ``generator``.
        Returns the (B, T) emitted tokens."""
        if temperature > 0 and generator is None:
            raise ValueError("temperature > 0 requires a torch.Generator")
        forced_t = torch.as_tensor(np.asarray(forced), dtype=torch.int32,
                                   device=self.device)
        force_len_t = torch.as_tensor(np.asarray(force_len),
                                      dtype=torch.int32, device=self.device)
        b, t_chunk = forced_t.shape
        table = state.device_table()
        self._count("chunk", (b, t_chunk, table is not None)
                    + self._cache_shapes(state.cache))
        step = self._stepper(params, state.cache, table)
        tok, pos = state.tok, state.pos
        emitted = []
        for t in range(t_chunk):
            lg = step(tok, pos)
            if temperature > 0:
                probs = torch.softmax(lg / temperature, dim=-1)
                nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
            else:
                nxt = torch.argmax(lg, dim=-1)
            nxt = torch.where(t < force_len_t, forced_t[:, t],
                              nxt.to(torch.int32))
            emitted.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        self.steps["decode"] += t_chunk
        state.tok, state.pos = tok, pos
        return torch.stack(emitted, dim=1).cpu().numpy()

    # -- speculative decode ------------------------------------------------

    def _draft(self, params: Params, state: BatchState, k: int,
               table: Optional[torch.Tensor]) -> torch.Tensor:
        """K greedy tokens (B, K) from the client stage alone (the layers up
        to ``spec_cut``), each read out through the early-exit head.  It
        decodes on the live cache, in place: :meth:`spec_chunk` saves what
        the draft overwrites beforehand."""
        client = tf.partition_params(params, self.cfg, (self.spec_cut,),
                                     copy=False)[0]
        ccache = tf.partition_cache(state.cache, self.cfg, (self.spec_cut,))[0]
        tok, pos = state.tok, state.pos
        drafts = []
        for _ in range(k):
            x, _ = tf.stage_decode_step(
                client, self.cfg, tok, ccache, pos, 0, 2,
                decode_window_override=self.decode_window_override,
                table=table, paged_kernel=self.paged_kernel)
            nxt = torch.argmax(tf.early_exit_logits(params, self.cfg, x)[:, 0],
                               dim=-1).to(torch.int32)
            drafts.append(nxt)
            tok, pos = nxt[:, None], pos + 1
        self.steps["draft"] += k
        return torch.stack(drafts, dim=1)

    @staticmethod
    def _ring_lines(state: BatchState, k: int) -> List[Tuple]:
        """Every ring's lines at positions pos .. pos + k - 1 of each row,
        copied: ``(layer cache, stacked, index of the (B, k) lines, saved)``.
        Taken before the round, they are the lines each of its steps
        overwrites (``k`` <= the ring's size, so a round hits distinct
        lines)."""
        rows = torch.arange(state.pos.shape[0], device=state.pos.device)[:, None]
        steps = torch.arange(k, device=state.pos.device)[None]
        lines = []
        for stacked, d in _layer_caches(state.cache):
            if not _is_ring(d, state.max_len):
                continue
            idx = ((state.pos.long()[:, None] + steps) % d["pos"].shape[-1])
            at = (slice(None), rows, idx) if stacked else (rows, idx)
            lines.append((d, stacked, at, {key: d[key][at].clone()
                                           for key in ("k", "v", "pos")}))
        return lines

    @staticmethod
    def _copies(recurrent: List[Tuple[bool, Params]]
                ) -> List[Dict[str, torch.Tensor]]:
        """A copy of the leaves of each ``(stacked, layer cache)``."""
        return [{key: t.clone() for key, t in d.items()} for _, d in recurrent]

    def spec_chunk(self, state: BatchState, params: Params,
                   draft_k: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """One speculative round: draft ``draft_k`` tokens with the client
        stage, verify them in one teacher-forced pass of the whole model
        (merged or split), accept the longest matching prefix plus the
        verifier's first correction.

        Advances each slot by ``n[b]`` in [1, draft_k] positions and returns
        ``(tokens (B, K), accepted drafts (B,), emitted (B,))``: the first
        ``emitted[b]`` tokens of row ``b`` are exactly greedy decoding's.

        The JAX engine drafts on a copy of the client cache and discards it.
        Here the draft decodes on the live cache in place, so the round
        first copies what the draft would corrupt, every ring's lines at
        pos .. pos + K - 1 and the recurrent states, and copies both back
        right after the draft: the verify starts from the pre-round cache,
        as JAX's does (a ring line the draft wrote for step j' > j still
        holds a key that verify step j sees).  Full-length and paged KV
        need no copy: every entry the draft wrote lies at a position the
        verify step reading it masks as future, each verify step rewrites
        its own position before reading it, and the rollback invalidates
        the rejected ones.  The rollback is JAX's, per
        cache family: a recurrent layer takes its state after step n - 1
        (the verify records a copy each step), full-length KV invalidates
        positions past pos + n - 1, a ring restores the lines of the
        rejected steps, a paged pool sets ``ppos`` of the rejected
        positions to -1 through the table."""
        k = int(draft_k)
        b = state.tok.shape[0]
        table = state.device_table()
        shapes = self._cache_shapes(state.cache)
        self._count("draft", (b, k, table is not None) + shapes)
        self._count("verify", (b, k, state.max_len, table is not None)
                    + shapes)
        pos0 = state.pos
        rows = torch.arange(b, device=pos0.device)
        lines = self._ring_lines(state, k)
        recurrent = [(stacked, d) for stacked, d in _layer_caches(state.cache)
                     if _is_recurrent(d)]
        saved = self._copies(recurrent)
        draft = self._draft(params, state, k, table)
        for (_, d), s in zip(recurrent, saved):     # the pre-round cache
            for key in d:
                d[key].copy_(s[key])
        for d, _, at, line in lines:
            for key, old in line.items():
                d[key][at] = old

        # verify: step j feeds the token before draft j at pos0 + j
        step = self._stepper(params, state.cache, table)
        tok, pos = state.tok, pos0
        greedy, recs = [], []
        for j in range(k):
            greedy.append(torch.argmax(step(tok, pos), dim=-1).to(torch.int32))
            recs.append(self._copies(recurrent))
            tok, pos = draft[:, j:j + 1], pos + 1
        self.steps["verify"] += k
        greedy = torch.stack(greedy, dim=1)                     # (B, K)
        acc = torch.cumprod((greedy == draft).to(torch.int32), dim=1).sum(
            1, dtype=torch.int32)                              # accepted
        n = torch.clamp(acc + 1, max=k)                         # emitted
        thr = pos0 + n - 1                                      # last valid
        last = n.long() - 1

        for i, (stacked, d) in enumerate(recurrent):
            for key in d:
                per_step = torch.stack([r[i][key] for r in recs])  # (K, ...)
                if stacked:                        # (K, L, B, ...)
                    d[key].copy_(per_step[last, :, rows].movedim(0, 1))
                else:
                    d[key].copy_(per_step[last, rows])
        rej = torch.arange(k, device=pos0.device)[None] >= n[:, None]
        for d, stacked, at, line in lines:
            for key, old in line.items():
                sel = rej[None] if stacked else rej
                sel = sel.reshape(sel.shape + (1,) * (old.dim() - sel.dim()))
                d[key][at] = torch.where(sel, old, d[key][at])
        for stacked, d in _layer_caches(state.cache):
            if "pk" in d:
                tab = table.long()
                view = d["ppos"][:, tab] if stacked else d["ppos"][tab]
                lim = (thr[None, :, None, None] if stacked
                       else thr[:, None, None])
                view = torch.where(view > lim, -1, view)
                if stacked:
                    d["ppos"][:, tab] = view
                else:
                    d["ppos"][tab] = view
            elif "pos" in d and not _is_ring(d, state.max_len):
                lim = thr[None, :, None] if stacked else thr[:, None]
                d["pos"].masked_fill_(d["pos"] > lim, -1)
        state.tok = torch.gather(greedy, 1, last[:, None])
        state.pos = pos0 + n
        return greedy.cpu().numpy(), acc.cpu().numpy(), n.cpu().numpy()

    # -- one-shot batched generation --------------------------------------

    def generate(self, params: Params, prompts, gen: int, *,
                 temperature: float = 0.0,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Batched generation of ``gen`` tokens per prompt row: prefill,
        then one chunk of ``gen - 1`` decode steps (through the stages in
        split mode).  Returns (B, gen)."""
        prompts = torch.as_tensor(np.asarray(prompts), dtype=torch.int32,
                                  device=self.device)
        b, s0 = prompts.shape
        cache = self.init_cache(b, s0 + gen)
        tok = self._prefill(params, prompts, cache)
        out = [tok.cpu().numpy()]
        if gen > 1:
            state = BatchState(cache=cache, tok=tok,
                               pos=torch.full((b,), s0, dtype=torch.int32,
                                              device=self.device),
                               max_len=s0 + gen)
            out.append(self.decode_chunk(
                state, params, np.zeros((b, gen - 1), np.int32),
                np.zeros((b,), np.int32), generator, temperature))
        return np.concatenate(out, axis=1)


_ENGINES: Dict[Tuple, DecodeEngine] = {}


def get_engine(cfg: ModelConfig, *, impl: str = "dense",
               cuts: Optional[Sequence[int]] = None,
               decode_window_override: Optional[int] = None,
               spec_cut: Optional[int] = None,
               paged_kernel: bool = False, device="cuda") -> DecodeEngine:
    """Process-wide engine cache: repeated ``generate()`` calls (and every
    replica of a served model) reuse one engine and its shape counters."""
    key = (cfg, impl, tuple(cuts) if cuts else None, decode_window_override,
           spec_cut, paged_kernel, str(resolve_device(device)))
    if key not in _ENGINES:
        _ENGINES[key] = DecodeEngine(
            cfg, impl=impl, cuts=cuts,
            decode_window_override=decode_window_override,
            spec_cut=spec_cut, paged_kernel=paged_kernel, device=device)
    return _ENGINES[key]
