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

  Each collective is logged (:func:`collective_stats`: calls, the bytes
  this rank sends, seconds) and credits its result bytes by op kind to
  an active op counter (``roofline/op_cost.py``) as JAX's
  ``roofline/analysis.py::collective_bytes`` counts them (an all-reduce's
  result is its input, an all-gather's the world's rows).
  :class:`MetaGroup` stands in for a group of ``size`` ranks on the meta
  device (the dry run): its collectives log their bytes and return
  shape-true results without moving anything.

**Placement arithmetic** (the logical-axis rules of the JAX module):
:func:`default_rules`, :func:`resolve_spec` (non-dividing axes dropped,
a prefix of a tuple axis taken where the whole does not divide),
:func:`placement_tree` (the counterpart of ``named_sharding_tree``),
:func:`auto_rules` and :func:`wssl_state_shardings`.  A placement is the
tuple of per-dimension mesh-axis entries a ``PartitionSpec`` holds, and
:func:`local_shape` is the block one device holds.  A mesh is its
axis-name -> size map (``launch/mesh.py``).

Not ported: what runs a model axis across ranks (``use_sharding_rules``,
``shard_activation``, ``bound_axes``, ``current_mesh``), a model-parallel
server stage, and JAX's per-shard MoE dispatch (ROADMAP Queue 1, item
13b).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.utils._pytree import tree_map

from repro_torch.roofline import op_cost
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


class MetaGroup:
    """A client axis of ``size`` ranks for meta tensors: this rank's
    collectives log their bytes and return shape-true results, moving
    nothing (the dry run counts one rank of a sharded round with it)."""

    def __init__(self, size: int):
        self.size = int(size)


def _world(group) -> int:
    if isinstance(group, MetaGroup):
        return group.size
    return dist.get_world_size(group)


def _timed(tensors: Sequence[torch.Tensor], fn, kind: str,
           world: int = 1) -> None:
    _STATS["calls"] += 1
    sent = sum(t.numel() * t.element_size() for t in tensors)
    _STATS["bytes"] += sent
    op_cost.credit_collective(
        kind, sent * (world if kind == "all-gather" else 1))
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
    meta = isinstance(group, MetaGroup)
    for t in tensors:
        if meta and not t.is_meta:
            raise ValueError("a MetaGroup reduces meta tensors only")
        _timed([t], (lambda: None) if meta else
               (lambda t=t: dist.all_reduce(t, op=dist.ReduceOp.SUM,
                                            group=group)), "all-reduce")


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) concatenated along dim
    0 in rank order: a shard's ``(N/S, ...)`` rows back to the whole
    ``(N, ...)``."""
    world = _world(group)
    out: List[torch.Tensor] = []

    def run():
        src = t.contiguous()
        parts = [torch.empty_like(src) for _ in range(world)]
        if not isinstance(group, MetaGroup):
            dist.all_gather(parts, src, group=group)
        out.append(torch.cat(parts, dim=0))

    _timed([t], run, "all-gather", world)
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


# ---------------------------------------------------------------------------
# Placement arithmetic: logical axes -> mesh axes
# ---------------------------------------------------------------------------

Logical = Union[str, None, Tuple[str, ...]]
Placement = Tuple[Logical, ...]


def _mesh_shape(mesh) -> Dict[str, int]:
    return dict(getattr(mesh, "shape", mesh))


def is_axes_leaf(a) -> bool:
    """True for the logical-axes tuples at an axes tree's leaves."""
    return isinstance(a, tuple) and all(
        isinstance(e, (str, type(None), tuple)) for e in a)


def _mesh_axis_size(shape: Dict[str, int], axis) -> int:
    if isinstance(axis, tuple):
        n = 1
        for a in axis:
            n *= shape[a]
        return n
    return shape[axis]


def resolve_spec(mesh, rules: Dict[str, Logical],
                 logical_axes: Sequence[Logical],
                 shape: Optional[Sequence[int]] = None) -> Placement:
    """Map logical axis names to a placement, dropping non-dividing axes,
    exactly as JAX's ``resolve_spec`` builds its ``PartitionSpec``: no
    mesh axis serves two dims, and where a tuple axis does not divide a
    dim its longest dividing prefix does."""
    ms = _mesh_shape(mesh)
    entries: List[Logical] = []
    used: set = set()
    for i, name in enumerate(logical_axes):
        phys = rules.get(name) if isinstance(name, str) else None
        if phys is None:
            entries.append(None)
            continue
        flat = phys if isinstance(phys, tuple) else (phys,)
        if any(f in used for f in flat):
            entries.append(None)
            continue
        if shape is not None and shape[i] % _mesh_axis_size(ms, phys) != 0:
            pref: List[str] = []
            if isinstance(phys, tuple):
                n = 1
                for a in phys:
                    if shape[i] % (n * ms[a]) != 0:
                        break
                    pref.append(a)
                    n *= ms[a]
            if pref:
                entries.append(tuple(pref))
                used.update(pref)
            else:
                entries.append(None)
            continue
        entries.append(phys)
        used.update(flat)
    # a one-axis tuple reads as that axis, as PartitionSpec stores it
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def local_shape(placement: Placement, shape: Sequence[int],
                mesh) -> Tuple[int, ...]:
    """The block of ``shape`` one device holds under ``placement`` (each
    placed dim divided by its mesh axes' product; placements from
    :func:`resolve_spec` divide exactly)."""
    ms = _mesh_shape(mesh)
    out = []
    for i, d in enumerate(shape):
        e = placement[i] if i < len(placement) else None
        out.append(d if e is None else d // _mesh_axis_size(ms, e))
    return tuple(out)


def map_axes(fn, axes_tree, tree):
    """``fn(axes, leaf)`` at every tensor leaf of ``tree``, ``axes_tree``
    (the same structure, logical-axes tuples where ``tree`` has tensors)
    walked beside it.  Dicts, lists, tuples, named tuples and dataclasses
    recurse; a leaf that is not a tensor (a generator) maps to None."""
    if isinstance(tree, torch.Tensor):
        return fn(axes_tree, tree)
    if isinstance(tree, dict):
        return {k: map_axes(fn, axes_tree[k], v) for k, v in tree.items()}
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return type(tree)(**{f.name: map_axes(fn, getattr(axes_tree, f.name),
                                              getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, (list, tuple)):
        out = [map_axes(fn, a, v) for a, v in zip(axes_tree, tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*out)
        return type(tree)(out)
    return None


def placement_tree(mesh, rules: Dict[str, Logical], axes_tree, tree):
    """The placement of every tensor leaf of ``tree`` (tensors, meta ones
    too) from its logical axes: the counterpart of JAX's
    ``named_sharding_tree`` / ``launch/specs.py::shardings_from_axes``."""
    return map_axes(lambda ax, t: resolve_spec(mesh, rules, ax, t.shape),
                    axes_tree, tree)


def device_bytes(mesh, rules: Dict[str, Logical], axes_tree, tree) -> int:
    """Bytes of ``tree``'s tensor leaves that one device holds under the
    rules: each leaf's local block times its element size."""
    total = [0]

    def one(ax, t):
        block = local_shape(resolve_spec(mesh, rules, ax, t.shape),
                            t.shape, mesh)
        n = 1
        for d in block:
            n *= d
        total[0] += n * t.element_size()

    map_axes(one, axes_tree, tree)
    return total[0]


def data_axes_of(mesh) -> Tuple[str, ...]:
    """The mesh axes the client axis shards over."""
    ms = _mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in ms)


def auto_axes_of(mesh) -> frozenset:
    """The mesh axes that are not data-parallel (e.g. 'model')."""
    return frozenset(_mesh_shape(mesh)) - set(data_axes_of(mesh))


def auto_rules(mesh, base: Optional[Dict[str, Logical]] = None
               ) -> Dict[str, Logical]:
    """A rule set restricted to the non-data (auto) axes of a
    client-sharded body: rules that bind a data-parallel axis, and the
    ``client`` / ``batch`` rules, are dropped; what stays is the
    model-parallel placement of the shared stages."""
    if base is None:
        base = default_rules()
    auto = auto_axes_of(mesh)

    def ok(phys: Logical) -> bool:
        flat = phys if isinstance(phys, tuple) else (phys,)
        return all(a in auto for a in flat)

    return {k: v for k, v in base.items()
            if v is not None and ok(v) and not (k in ("client", "batch"))}


def wssl_state_shardings(mesh, state_axes, state,
                         rules: Optional[Dict[str, Logical]] = None):
    """The placement tree of a ``WSSLState``: client-stage leaves
    (leading ``"client"`` axis) over the data axes, the shared stages
    through ``rules`` (default :func:`default_rules`)."""
    if rules is None:
        rules = default_rules()
    rules = dict(rules)
    dp = data_axes_of(mesh)
    rules["client"] = dp if len(dp) > 1 else dp[0]
    return placement_tree(mesh, rules, state_axes, state)


def default_rules(multi_pod: bool = False, *, seq_shard_kv: bool = False,
                  fsdp: bool = True) -> Dict[str, Logical]:
    """Baseline logical -> mesh-axis binding: batch / client on the
    data-parallel axes, tensor dims on 'model', fsdp on 'data', kv_seq on
    'model' only when asked."""
    dp: Logical = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "client": dp,
        "heads": "model",
        "act_heads": "model",
        "kv_heads": "model",
        "ff": "model",
        "vocab": "model",
        "expert": "model",
        "lru": "model",
        "ssm_inner": "model",
        "ssm_heads": "model",
        "fsdp": "data" if fsdp else None,
        "attn_din": "data" if fsdp else None,
        "attn_dout": "data" if fsdp else None,
        "seq": None,
        "attn_seq": None,
        "moe_tokens": None,   # bound to the dp axes for prefill/decode only
        "kv_seq": "model" if seq_shard_kv else None,
        "embed": None,
    }
