"""Paged KV-cache block allocator (the vLLM block-table idea, sized for

A copy of ``repro/serve/blocks.py`` (numpy-only), kept in the port so
that it imports nothing of ``repro``.
the WSSL serving plane).

The engine's contiguous layout gives every decode slot a private
``max_len`` KV region, so a 4-token request and a 120-token request cost
the same cache memory and admission is gated on *slots*.  Paged mode
carves the global-attention KV pool into fixed-size blocks; each slot
owns a *block table* row mapping logical block ``pos // block_size`` to a
physical pool block.  Short requests hold few blocks, long requests hold
many, and admission becomes a single O(1) free-list check
(``can_fit``) instead of a slot-shaped capacity cliff.

Reservation discipline: a request reserves ALL the blocks it can ever
touch (prompt + max_new + the decode-chunk overshoot margin) at
admission.  That is deliberately conservative — it makes the scheduler
deadlock-free (an admitted request can always finish; nothing ever
blocks mid-decode waiting for a block) and keeps eviction at chunk
boundaries, matching the slot scheduler's discipline.  Blocks return to
the free list when the request finishes (or when its replica drops and
the whole pool is reset).

The first ``reserved`` block ids are per-slot *scratch* blocks that are
never allocated: slot ``b``'s table rows point at scratch block ``b``
wherever no real block is mapped, so the lockstep garbage decode of an
empty slot writes into its own scratch block instead of corrupting a
neighbour (see ``engine.DecodeEngine.new_batch_state``).
"""

from __future__ import annotations

from typing import List


class BlockAllocator:
    """Free-list allocator over a fixed pool of KV blocks.

    All operations are O(blocks moved); ``can_fit`` is O(1) — the
    admission-loop hot path at a million queued requests.
    """

    def __init__(self, num_blocks: int, block_size: int, reserved: int = 0):
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {block_size}")
        if num_blocks <= reserved:
            raise ValueError(
                f"pool of {num_blocks} blocks leaves nothing to allocate "
                f"after {reserved} per-slot scratch blocks")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self.reserved = int(reserved)
        self._free: List[int] = []
        self._held = set()
        self.peak_in_use = 0
        self.reset()

    # -- introspection -----------------------------------------------------

    @property
    def capacity(self) -> int:
        """Allocatable blocks (scratch excluded)."""
        return self.num_blocks - self.reserved

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def blocks_in_use(self) -> int:
        return self.capacity - len(self._free)

    def blocks_for(self, tokens: int) -> int:
        """Blocks needed to hold ``tokens`` cache entries."""
        return -(-int(tokens) // self.block_size)

    def can_fit(self, tokens: int) -> bool:
        return self.blocks_for(tokens) <= len(self._free)

    # -- allocate / free ---------------------------------------------------

    def allocate(self, tokens: int) -> List[int]:
        """Reserve blocks for ``tokens`` entries; returns the block ids in
        logical order (table row order)."""
        need = self.blocks_for(tokens)
        if need > len(self._free):
            raise RuntimeError(
                f"pool exhausted: need {need} blocks, {len(self._free)} "
                f"free (call can_fit before allocate)")
        ids = [self._free.pop() for _ in range(need)]
        self._held.update(ids)
        self.peak_in_use = max(self.peak_in_use, self.blocks_in_use)
        return ids

    def free(self, ids: List[int]) -> None:
        for i in ids:
            if i not in self._held:
                raise RuntimeError(f"double free of block {i}")
            self._held.discard(i)
            self._free.append(i)

    def reset(self) -> None:
        """Return every block (replica drop: the whole pool is lost)."""
        self._held.clear()
        # LIFO free list, ids descending so early allocations get low ids
        self._free = list(range(self.num_blocks - 1, self.reserved - 1, -1))
