"""Byte accounting: the serving log and its byte counts, and the bytes of
a training round.

A copy of the serving part of ``repro/core/protocol.py`` (``ServeTick``,
``ServeLog``, ``serve_hop_bytes``, ``reroute_sync_bytes``) and of its
training part (``tree_bytes``, ``sync_round_bytes``,
``hierarchical_sync_bytes``, ``compressed_update_bytes``, ``RoundComm``,
``CommLog``).
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


def hierarchical_sync_bytes(selected, num_clients: int, num_shards: int,
                            client_stage_bytes, decomposes: bool):
    """(cross_shard, intra_shard) sync bytes of the two-level aggregation
    of a client-sharded round.  intra: each selected client uploads its
    stage to its shard, sel |theta|, what the flat round pays.  cross: a
    decomposable rule sends one partial a shard up the combine tree and
    the global stage back down, 2 S |theta| whatever the client count; the
    all-gather fallback moves every selected update to every shard's copy
    of the rule once and the broadcast leg, (sel + S) |theta|.  Works on
    tensors (the round passes its mask sum)."""
    intra = selected * client_stage_bytes
    if decomposes:
        cross = 2 * num_shards * client_stage_bytes
    else:
        cross = (selected + num_shards) * client_stage_bytes
    return cross, intra


def _itemsize(dtype) -> int:
    size = getattr(dtype, "itemsize", None)      # torch.dtype
    return int(size) if size is not None else np.dtype(dtype).itemsize


def compressed_update_bytes(tree, scheme: str, rate: float = 0.05,
                            num_clients: int = 1) -> int:
    """Wire bytes of ONE client's compressed stage upload, from shapes and
    dtypes only (tensor or numpy leaves).  For a *stacked* tree (leaves
    (N, ...)) pass ``num_clients=N`` so each leaf counts one client's share.

    * ``none``  — raw: m * itemsize per leaf
    * ``topk``  — k (fp32 value, int32 index) pairs: 8k, k = round(rate *
      m) in fp32, clipped to [1, m]
    * ``int8`` / ``int4`` — m * bits / 8 payload (whole bytes) + one fp32
      scale per leaf
    """
    from torch.utils._pytree import tree_leaves
    bits = {"int8": 8, "int4": 4}.get(scheme)
    total = 0.0
    for l in tree_leaves(tree):
        shape = getattr(l, "shape", ())
        dtype = getattr(l, "dtype", np.float32)
        m = int(np.prod(shape, dtype=np.int64)) // max(num_clients, 1)
        if m == 0:
            continue
        if scheme == "none":
            total += m * _itemsize(dtype)
        elif scheme == "topk":
            # fp32 round, as the round's own count
            k = min(max(float(np.round(np.float32(rate) * np.float32(m))),
                        1.0), float(m))
            total += k * 8.0
        elif bits is not None:
            # whole wire bytes per leaf: an odd-m int4 payload pads a nibble
            total += float(np.ceil(m * bits / 8.0)) + 4.0
        else:
            raise ValueError(f"unknown compression scheme {scheme!r}")
    return int(total)


@dataclass
class RoundComm:
    round_index: int
    selected: int
    bytes_up: int
    bytes_down: int
    bytes_sync: int
    # per hop crossing (client->edge_0, ..., edge->server)
    bytes_per_hop: Tuple[int, ...] = ()
    # bounded-staleness async rounds: zero on synchronous logs
    arrived: int = 0
    mean_staleness: float = 0.0
    buffered: int = 0
    evicted: int = 0
    # update-path compression: raw vs wire bytes of the uploaded client
    # updates (equal when scheme="none")
    bytes_update_raw: int = 0
    bytes_update_comp: int = 0
    # hierarchical aggregation of client-sharded rounds: zero on flat logs
    bytes_cross_shard: int = 0
    bytes_intra_shard: int = 0
    # activation-path compression: raw vs wire bytes of the per-hop
    # activations and cotangents (zero when it is off)
    bytes_act_raw: int = 0
    bytes_act_comp: int = 0

    @property
    def total(self) -> int:
        return self.bytes_up + self.bytes_down + self.bytes_sync


@dataclass
class CommLog:
    rounds: List[RoundComm] = field(default_factory=list)

    def record(self, round_index: int, selected: int, bytes_up: int,
               bytes_down: int, bytes_sync: int = 0,
               bytes_per_hop: Sequence[int] = (), arrived: int = 0,
               mean_staleness: float = 0.0, buffered: int = 0,
               evicted: int = 0, bytes_update_raw: int = 0,
               bytes_update_comp: int = 0, bytes_cross_shard: int = 0,
               bytes_intra_shard: int = 0, bytes_act_raw: int = 0,
               bytes_act_comp: int = 0) -> None:
        self.rounds.append(RoundComm(round_index, selected, int(bytes_up),
                                     int(bytes_down), int(bytes_sync),
                                     tuple(int(b) for b in bytes_per_hop),
                                     int(arrived), float(mean_staleness),
                                     int(buffered), int(evicted),
                                     int(bytes_update_raw),
                                     int(bytes_update_comp),
                                     int(bytes_cross_shard),
                                     int(bytes_intra_shard),
                                     int(bytes_act_raw),
                                     int(bytes_act_comp)))

    @property
    def total_bytes(self) -> int:
        return sum(r.total for r in self.rounds)

    @property
    def num_hops(self) -> int:
        return max((len(r.bytes_per_hop) for r in self.rounds), default=0)

    @property
    def is_async(self) -> bool:
        """True if any round carried staleness traffic."""
        return any(r.arrived or r.buffered or r.evicted for r in self.rounds)

    def summary(self) -> Dict[str, float]:
        if not self.rounds:
            return {}
        ups = [r.bytes_up for r in self.rounds]
        out = {
            "rounds": len(self.rounds),
            "total_GB": self.total_bytes / 1e9,
            "mean_up_MB": float(np.mean(ups)) / 1e6,
            "mean_sync_MB": float(np.mean([r.bytes_sync
                                           for r in self.rounds])) / 1e6,
            "mean_selected": float(np.mean([r.selected for r in self.rounds])),
        }
        for h in range(self.num_hops):
            # over ALL rounds: a round that logged () moved zero bytes
            # across hop h
            vals = [r.bytes_per_hop[h] if len(r.bytes_per_hop) > h else 0
                    for r in self.rounds]
            out[f"mean_hop{h}_MB"] = float(np.mean(vals)) / 1e6
        raw = float(np.sum([r.bytes_update_raw for r in self.rounds]))
        comp = float(np.sum([r.bytes_update_comp for r in self.rounds]))
        if comp > 0:
            out["update_raw_MB"] = raw / 1e6
            out["update_comp_MB"] = comp / 1e6
            out["update_compression_ratio"] = raw / comp
        cross = float(np.sum([r.bytes_cross_shard for r in self.rounds]))
        if cross > 0:
            out["cross_shard_MB"] = cross / 1e6
            out["intra_shard_MB"] = float(
                np.sum([r.bytes_intra_shard for r in self.rounds])) / 1e6
        act_raw = float(np.sum([r.bytes_act_raw for r in self.rounds]))
        act_comp = float(np.sum([r.bytes_act_comp for r in self.rounds]))
        if act_comp > 0:
            out["act_raw_MB"] = act_raw / 1e6
            out["act_comp_MB"] = act_comp / 1e6
            out["act_compression_ratio"] = act_raw / act_comp
        if self.is_async:
            arr = [r.arrived for r in self.rounds]
            out["stale_arrivals"] = float(np.sum(arr))
            out["mean_staleness"] = float(
                np.sum([r.arrived * r.mean_staleness for r in self.rounds])
                / max(np.sum(arr), 1))
            out["evictions"] = float(np.sum([r.evicted
                                             for r in self.rounds]))
        return out
