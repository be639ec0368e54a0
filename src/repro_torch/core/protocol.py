"""Byte accounting: the serving log and its byte counts, and the sync
bytes of a training round.

A copy of the serving part of ``repro/core/protocol.py`` (``ServeTick``,
``ServeLog``, ``serve_hop_bytes``, ``reroute_sync_bytes``) and of its
``tree_bytes`` and ``sync_round_bytes``.
Every crossing is recorded per tick; split mode counts per-hop activation
bytes, and fault recovery (re-prefill after a replica drop) lands in the
sync column.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Sequence, Tuple

import numpy as np


@dataclass
class ServeTick:
    """One replica-chunk of serving work."""

    tick: int
    replica: int
    admitted: int               # requests prefilled this tick
    tokens: int                 # tokens credited to requests this tick
    bytes_per_hop: Tuple[int, ...] = ()   # split-mode activation crossings
    bytes_sync: int = 0         # re-prefill traffic after a replica drop
    rerouted: int = 0           # requests re-routed away from this replica
    drafted: int = 0            # speculative draft tokens proposed
    accepted: int = 0           # draft tokens the verifier accepted
    rejected: int = 0           # requests shed at admission (SLO)

    @property
    def total(self) -> int:
        return sum(self.bytes_per_hop) + self.bytes_sync


@dataclass
class ServeLog:
    """Per-tick serving log (the CommLog of the serving plane)."""

    ticks: List[ServeTick] = field(default_factory=list)

    def record(self, tick: int, replica: int, admitted: int, tokens: int,
               bytes_per_hop: Sequence[int] = (), bytes_sync: int = 0,
               rerouted: int = 0, drafted: int = 0, accepted: int = 0,
               rejected: int = 0) -> None:
        self.ticks.append(ServeTick(int(tick), int(replica), int(admitted),
                                    int(tokens),
                                    tuple(int(b) for b in bytes_per_hop),
                                    int(bytes_sync), int(rerouted),
                                    int(drafted), int(accepted),
                                    int(rejected)))

    @property
    def total_bytes(self) -> int:
        return sum(t.total for t in self.ticks)

    @property
    def total_tokens(self) -> int:
        return sum(t.tokens for t in self.ticks)

    @property
    def num_hops(self) -> int:
        return max((len(t.bytes_per_hop) for t in self.ticks), default=0)

    def summary(self) -> Dict[str, float]:
        if not self.ticks:
            return {}
        out = {
            "ticks": float(len(self.ticks)),
            "tokens": float(self.total_tokens),
            "admitted": float(np.sum([t.admitted for t in self.ticks])),
            "rerouted": float(np.sum([t.rerouted for t in self.ticks])),
            "sync_MB": float(np.sum([t.bytes_sync
                                     for t in self.ticks])) / 1e6,
            "total_MB": self.total_bytes / 1e6,
        }
        for h in range(self.num_hops):
            vals = [t.bytes_per_hop[h] for t in self.ticks
                    if len(t.bytes_per_hop) > h]
            out[f"hop{h}_MB"] = float(np.sum(vals)) / 1e6
        drafted = float(np.sum([t.drafted for t in self.ticks]))
        if drafted > 0:
            out["drafted"] = drafted
            out["accepted"] = float(np.sum([t.accepted for t in self.ticks]))
            out["acceptance"] = out["accepted"] / drafted
        rejected = float(np.sum([t.rejected for t in self.ticks]))
        if rejected > 0:
            out["rejected"] = rejected
        return out


def serve_hop_bytes(tokens: int, d_model: int, itemsize: int,
                    num_hops: int) -> Tuple[int, ...]:
    """Split-mode activation traffic: each decoded (or prefilled) token
    ships one (d_model,) activation across every hop crossing."""
    return tuple(tokens * d_model * itemsize for _ in range(num_hops))


def reroute_sync_bytes(prompt_len: int, replay_len: int,
                       token_bytes: int = 4) -> int:
    """Fault-recovery traffic when a request is re-routed after a replica
    drop: the prompt plus the already-credited tokens are re-shipped to the
    new replica for re-prefill + replay."""
    return (int(prompt_len) + int(replay_len)) * token_bytes


# ---------------------------------------------------------------------------
# Training accounting
# ---------------------------------------------------------------------------


def tree_bytes(tree) -> int:
    """Total bytes of a tree's tensor leaves, from shape and dtype metadata
    only (no device-to-host copy)."""
    from torch.utils._pytree import tree_leaves
    return sum(l.numel() * l.element_size() for l in tree_leaves(tree))


def sync_round_bytes(selected, num_clients, client_stage_bytes):
    """Client-stage sync traffic of a round: the ``selected`` participants
    upload their stage for aggregation and the aggregated stage goes back
    to all N clients.  Works on tensors (the round passes its mask sum)."""
    return (selected + num_clients) * client_stage_bytes
