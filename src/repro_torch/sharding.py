"""Client-axis scale-out: which leaves of a round's state ride the client
axis, how a state and a batch split into shards and merge back, and the
two collectives the sharded rounds use.

The twin of the client-axis part of ``repro/sharding.py``
(``round_state_specs``, ``client_axis_spec``, ``place_state`` /
``place_batch``'s layout).  The client axis is a ``torch.distributed``
process group (``launch/mesh.py``), one rank a shard:

* **The leaf rule** (``round_state_specs``): a leaf whose logical axes
  lead with ``"client"`` is local, ``(N/S, ...)``; everything else is
  replicated.  So the client stack, its optimizer moments, the
  error-feedback residuals and the async buffer ride the axis; the edge
  and server stages, their optimizer state, the importance, the round
  index, the selection generator and the async ``pending`` /
  ``staleness`` counters are whole on every rank.
* **The layout**: shard ``index`` holds clients ``index * N/S`` to
  ``(index + 1) * N/S - 1``, the block layout of ``P(dp)``; a gather
  concatenates in rank order, which is flat client order.
* **Transport**: :func:`all_reduce_sum` sums tensors across the group in
  place, :func:`all_gather_rows` concatenates each rank's rows, on the
  tensors' own device, over the group's backend: NCCL, or gloo where the
  ranks share one card (NCCL refuses two ranks on one GPU).  Gloo takes
  CUDA tensors itself, copying them through host memory (chip_smoke phase
  25 checks both collectives on the card), so nothing is staged here.  A
  collective runs at every world size, 1 too.

The logical-axis GSPMD machinery of the JAX module (``use_sharding_rules``,
``shard_activation``, ``resolve_spec``, ``auto_rules``, ``default_rules``)
and a model axis are not ported (ROADMAP Queue 1, item 13b).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.tree import tree_leaves

Params = Any

CLIENT = "client"        # a leaf local to its shard, (N/S, ...)
REPLICATED = None        # a leaf whole on every rank

# state field -> whether its leaves lead with the client axis; an
# optimizer state's ``step`` is replicated and its moments follow the
# params it steps
_CLIENT_FIELDS = {"client_stack": True, "opt_client": True,
                  "ef_residual": True, "buffer": True}


def _is_opt_state(v) -> bool:
    return dataclasses.is_dataclass(v) and hasattr(v, "step")


def _map_opt(opt, fn, rep_fn):
    return type(opt)(**{g.name: (rep_fn(getattr(opt, g.name))
                                 if g.name == "step"
                                 else tree_map(fn, getattr(opt, g.name)))
                        for g in dataclasses.fields(opt)})


def _map_fields(state, client_fn, rep_fn):
    """``state`` (a ``WSSLState`` or an ``AsyncState``) with ``client_fn``
    on every client-axis leaf and ``rep_fn`` on every replicated one."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        fn = client_fn if _CLIENT_FIELDS.get(f.name, False) else rep_fn
        if _is_opt_state(v):
            out[f.name] = _map_opt(v, fn, rep_fn)
        elif isinstance(v, tuple) and v and all(map(_is_opt_state, v)):
            out[f.name] = tuple(_map_opt(o, fn, rep_fn) for o in v)
        else:
            out[f.name] = tree_map(fn, v)
    return type(state)(**out)


def round_state_specs(state):
    """``state`` with each tensor leaf replaced by :data:`CLIENT` (local
    to its shard) or :data:`REPLICATED`: the leaf rule of the JAX
    module's ``round_state_specs``.  The selection generator maps to
    :data:`REPLICATED` too."""
    return _map_fields(state, lambda _: CLIENT, lambda _: REPLICATED)


def _clone(v):
    if isinstance(v, torch.Generator):
        g = torch.Generator(device=v.device)
        g.set_state(v.get_state())
        return g
    return v.clone() if isinstance(v, torch.Tensor) else v


def _rows(n: int, num_shards: int, index: int) -> slice:
    if n % num_shards:
        raise ValueError(f"num_clients={n} must divide evenly over "
                         f"{num_shards} client shards")
    if not 0 <= index < num_shards:
        raise ValueError(f"shard index {index} out of range for "
                         f"{num_shards} shards")
    k = n // num_shards
    return slice(index * k, (index + 1) * k)


def shard_state(state, num_shards: int, index: int):
    """Shard ``index``'s copy of a whole ``WSSLState`` or ``AsyncState``:
    its rows of every client-axis leaf, and every replicated leaf (the
    selection generator at the same point of its stream).  Every tensor
    is a copy, so the whole state survives a sharded round, as JAX's
    ``place_state`` puts a copy."""
    n = _num_clients(state)
    rows = _rows(n, num_shards, index)
    return _map_fields(state, lambda t: t[rows].clone(), _clone)


def shard_batch(batch: Dict[str, torch.Tensor], num_shards: int,
                index: int) -> Dict[str, torch.Tensor]:
    """Shard ``index``'s rows of a per-client batch (leaves ``(N, ...)``:
    tokens, labels and patch embeddings)."""
    n = next(iter(batch.values())).shape[0]
    rows = _rows(n, num_shards, index)
    return {k: v[rows] for k, v in batch.items()}


def merge_shards(shards: Sequence[Any]):
    """The whole state from every shard's, in rank order: client-axis
    leaves concatenated (flat client order), replicated leaves from shard
    0 (every shard holds the same)."""
    shards = list(shards)
    first = shards[0]
    it = [iter(tree_leaves_state(s)) for s in shards]

    def client(_):
        return torch.cat([next(i) for i in it], dim=0)

    def rep(v):
        for i in it[1:]:
            next(i)
        return _clone(next(it[0]))

    return _map_fields(first, client, rep)


def tree_leaves_state(state) -> List[Any]:
    """Every leaf of ``state`` (tensors and the generator) in the order
    :func:`merge_shards` walks them."""
    out: List[Any] = []

    def grab(v):
        out.append(v)
        return v

    _map_fields(state, grab, grab)
    return out


def _num_clients(state) -> int:
    field = "client_stack" if hasattr(state, "client_stack") else "buffer"
    return tree_leaves(getattr(state, field))[0].shape[0]


def init_shard_state(gen: torch.Generator, model_cfg, wssl_cfg, train_cfg,
                     num_shards: int, index: int, *, device="cuda"):
    """``shard_state(init_state(gen, ...), num_shards, index)`` without
    building the other shards' rows: every client starts from the same
    stage, so shard ``index`` is the state of N/S clients with the whole
    (N,) importance.  ``gen`` draws what ``init_state`` draws, in order."""
    from repro_torch.core.round import init_state
    n = wssl_cfg.num_clients
    rows = _rows(n, num_shards, index)
    local = init_state(gen, model_cfg, dataclasses.replace(
        wssl_cfg, num_clients=rows.stop - rows.start), train_cfg,
        device=device)
    local.importance = torch.full((n,), 1.0 / n, dtype=torch.float32,
                                  device=local.importance.device)
    return local


# ---------------------------------------------------------------------------
# Transport
# ---------------------------------------------------------------------------

# collective calls, bytes and (while ``timing`` is on) seconds since the
# last reset: the sharded round's collective share
_STATS = {"calls": 0, "bytes": 0, "seconds": 0.0}
_TIMING = [False]


def reset_collective_stats(timing: bool = False) -> None:
    """Zero the counts of :func:`collective_stats`.  ``timing`` times each
    collective from a device synchronise before it to one after it (the
    synchronisation is the cost of the reading)."""
    _STATS.update(calls=0, bytes=0, seconds=0.0)
    _TIMING[0] = bool(timing)


def collective_stats() -> Dict[str, float]:
    """Collective calls, bytes sent by this rank and seconds (0 unless
    timed) since :func:`reset_collective_stats`."""
    return dict(_STATS)


def _timed(tensors: Sequence[torch.Tensor], fn) -> None:
    _STATS["calls"] += 1
    _STATS["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    cuda = any(t.is_cuda for t in tensors)
    if not _TIMING[0]:
        fn()
        return
    if cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    if cuda:
        torch.cuda.synchronize()
    _STATS["seconds"] += time.perf_counter() - t0


def all_reduce_sum(tensors: Sequence[torch.Tensor], group) -> None:
    """Sum each tensor across the group's ranks, in place (a contiguous
    tensor each)."""
    for t in tensors:
        _timed([t], lambda t=t: dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                                group=group))


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim
    0 in rank order: a shard's ``(N/S, ...)`` rows back to the whole
    ``(N, ...)``."""
    world = dist.get_world_size(group)
    out: List[torch.Tensor] = []

    def run():
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(world)]
        dist.all_gather(parts, src, group=group)
        out.append(torch.cat(parts, dim=0))

    _timed([t], run)
    return out[0]


def all_reduce_tree(tree: Params, group) -> Params:
    """:func:`all_reduce_sum` on every tensor leaf of ``tree``, in place;
    returns ``tree``."""
    all_reduce_sum(tree_leaves(tree), group)
    return tree


def sum_scalars(group, *xs: torch.Tensor) -> List[torch.Tensor]:
    """0-d tensors of one device summed across the group in one
    collective (stacked, reduced, split)."""
    packed = torch.stack([x.reshape(()) for x in xs])
    all_reduce_sum([packed], group)
    return list(packed.unbind(0))
