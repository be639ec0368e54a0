"""One synchronous WSSL communication round for the transformer stack.

The twin of the flat round of ``repro/core/round.py``: Algorithm 1 and 2
over a fixed client axis and an N-stage split pipeline

  fault plan -> importance -> Gumbel-top-k selection mask (times the
  plan's survivors) -> per-client split forward and chained backward
  (client stage per client, edge and server stages shared) -> global-norm
  clip -> gradient corruption -> masked optimizer step -> update scaling
  and the adaptive attack -> per-client validation -> importance EMA ->
  update compression with error feedback -> registry aggregation and
  client sync.

With a ``scenario`` (``repro_torch.sim``), its fault plan composes with
the selection mask and the round's tensors as in JAX: dropped clients and
clients behind dead hop replicas mask out, label-flip adversaries train on
shifted labels, sign-flip and noisy clients corrupt their client-stage
gradient after the clip, stragglers, slow hops and Byzantine clients scale
their post-optimizer update, and adaptive clients send mean(honest) - z
std(honest).  Every aggregation rule of the registry runs, the robust
ones with their ``AggParams``.

With ``WSSLConfig.compression`` on, the uploaded stage deltas go through
``repro_torch.compress`` (top-k or stochastic int8 / int4, with an fp32
error-feedback residual per client in ``WSSLState.ef_residual``) before
aggregation, and with ``activations=True`` every split-hop crossing is
compressed too: the forward runs on the wire reconstruction and the
backward relays the compressed cotangent (straight-through).

What differs from the JAX round, and why:

* The state is updated **in place** (params, optimizer slots, importance,
  round index and the selection generator), the port's counterpart of
  ``donate=True``: one copy of the state is live.  ``wssl_round`` returns
  the same :class:`WSSLState` object.
* The per-client forward/backward is a loop over clients where JAX vmaps
  it.  Each client's loss enters the objective with the coefficient
  ``agg_w * mask``.  In a stack whose edge and server stages hold no MoE
  layer, a client with mask 0 has coefficient 0, so its gradients are 0
  and AdamW's mask freezes it — the loop skips it, and every output stays
  what the vmapped round computes (its per-client loss is reported as 0
  either way).  Where an MoE layer sits in an edge or the server stage,
  JAX adds that stage's load-balance aux as the mean over **all** N
  clients, so an unselected client still moves the shared stages'
  gradients, and its client-stage gradient (masked out of the step)
  still enters the client stack's global-norm clip: then every client
  runs, selected or not.
* Autograd accumulates every gradient straight into one fp32 buffer per
  leaf: each stacked leaf is bound as per-layer leaf views whose ``.grad``
  is the matching slice of the buffer (:func:`_bind`).  The shared
  stages' gradients sum over clients in client order (JAX sums them in
  one batched backward), which moves fp32 results by rounding only.
* The optimizer steps the client stack in place, so the pre-step rows
  that something reads are copied before the step: the selected rows when
  the compressed upload or an update transform reads them, and every
  adaptive client's.  A masked row is frozen bit for bit, so its delta is
  0, its scaled update is itself, and only the kept rows are rebuilt as
  ``old + sent``.
* An all-dropped round does not step the server and edge stages at all
  (JAX steps them and then keeps the old values): the state is the same,
  and those stages' AdamW launches are skipped.
* The fault plan and the gradient noise draw from streams of their own
  (the selection generator's seed, the round and a tag, as the
  compression draws), or from ``fault_draws`` when given.
* Compression draws come from ``comp_uniform(tag, leaf, shape)`` when
  given (tests feed the JAX draws: ``tag`` is the integer the JAX round
  folds into its selection key, ``leaf`` the integer folded in after it:
  the leaf index for updates, the chunk index for a chunked round's
  activations and None for a flat round's), else from a ``torch.Generator``
  seeded from the selection generator's seed, the round, the tag and the
  leaf.  They never advance the selection stream: every round draws its
  selection from the state it would without compression (the masks then
  match wherever the importance does).  JAX draws one (N*b*s, d)
  activation ``u`` for all clients; the loop takes client i's rows.
* The MoE aux terms enter as JAX sums them: each client's server-stage
  and edge-stage aux at weight 1/N (the cotangent JAX's vmapped mean
  gives each), the objective adding the server aux's mean and each edge
  stage's mean over the clients; the client stage's aux is dropped, as in
  JAX.  A dense stack has none, and its objective is unchanged.
* ``TrainConfig.client_chunk`` reproduces JAX's client-chunked scan
  (``_client_grads_chunked``): the shared stages' gradients and the loss
  sum per chunk, then across chunks in fp32, and the activation
  compression draws one ``(chunk * rows, d)`` tensor per chunk and hop,
  ``comp_uniform(tag, chunk_index, shape)``.  The loop runs one client at
  a time either way, so the chunk changes no memory bound here.

The round is built from pieces that ``core/async_round.py`` shares, as
the JAX async round imports the sync round's: the per-client split
forward/backward (:func:`_client_grads`), the clip and the gradient
corruption, the masked step on kept pre-step rows, the update
transforms, validation and the byte accounting.

Every ported layer kind trains: global and local attention through any
impl of ``models/attention.py::TRAIN_IMPLS`` (the round defaults to
``chunked``, as JAX's does: the flash path, whose backward recomputes the
probability tiles instead of holding an (S, S) matrix a layer), the
Mamba-2 SSD block and the RG-LRU block through their plain scans
(``ssd_chunked``, the doubling scan), as the JAX round trains them.  A
vision frontend's ``batch["embeds"]`` go through each client's stage;
the edge and server stages see text positions over the spliced length
and the loss trims the prefix, as in JAX.

**Client-axis scale-out** (:func:`make_sharded_round_fn`): the round runs
once a shard, on a rank of a ``torch.distributed`` group
(``launch/mesh.py``), with a :class:`ShardCtx`.  The client stack, its
moments, the residuals and the batch hold the shard's N/S clients; every
(N,) decision vector (importance, the fault plan, the mask and the
aggregation weights) is computed whole on every rank from the same
generator, so selection and faults are the flat round's.  The loss and
the shared stages' gradients sum across shards, the client clip's squared
norm and the adaptive attack's honest statistics too, the validation and
per-client losses gather, and the aggregation goes through the two-level
tree (``aggregation.shard_aggregate_clients``).  Each ctx helper is the
identity without a ctx, so the flat round is unchanged; at S = 1 the
sharded round is the flat round bit for bit (the compression and noise
streams fold the shard index in only when S > 1; JAX folds it at any S).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch import compress, sharding
from repro_torch.config import MLP_MOE, ModelConfig, TrainConfig, WSSLConfig
from repro_torch.core import aggregation, wssl
from repro_torch.core.protocol import (hierarchical_sync_bytes,
                                       sync_round_bytes, tree_bytes)
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import resolve_device, torch_dtype
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.schedule import make_schedule
from repro_torch.sim import faults as sim_faults
from repro_torch.tree import tree_leaves

Params = Any


@dataclass
class WSSLState:
    client_stack: Params              # client stages, leaves (N, ...)
    server_params: Params
    edge_stages: Tuple[Params, ...]   # shared intermediate hops (may be ())
    opt_client: Any
    opt_server: Any
    opt_edge: Tuple[Any, ...]
    importance: torch.Tensor          # (N,) normalized, on the params' device
    round_index: torch.Tensor         # 0-d int32 on the host
    rng: torch.Generator              # the selection draws, on the host
    # per-client fp32 error-feedback residuals, leaves (N, ...); () when
    # compression or its error feedback is off
    ef_residual: Params = ()


class RoundMetrics(NamedTuple):
    loss: torch.Tensor
    per_client_loss: torch.Tensor     # (N,) train loss (unselected -> 0)
    val_loss: torch.Tensor            # (N,) validation loss per client
    mask: torch.Tensor                # (N,) participation
    importance: torch.Tensor          # (N,) after the update
    bytes_up: torch.Tensor            # activation bytes over all hops
    bytes_down: torch.Tensor          # returned-gradient bytes
    bytes_per_hop: torch.Tensor       # (num_hops,)
    bytes_sync: torch.Tensor          # client-stage aggregation + broadcast
    bytes_update_raw: Any = 0.0
    bytes_update_comp: Any = 0.0
    # sharded rounds only (0.0 when flat): cross-shard tree traffic and
    # on-shard client uploads
    bytes_cross_shard: Any = 0.0
    bytes_intra_shard: Any = 0.0
    # activation-path compression: raw vs wire bytes (0 when it is off)
    bytes_act_raw: Any = 0.0
    bytes_act_comp: Any = 0.0


def init_state(gen: torch.Generator, model_cfg: ModelConfig,
               wssl_cfg: WSSLConfig, train_cfg: TrainConfig, *,
               device="cuda") -> WSSLState:
    """N identical client stages plus the edge and server stages, from
    random params drawn with ``gen`` (a generator on ``device``) and stored
    in ``model_cfg.param_dtype``; fresh optimizer state; uniform
    importance; zero error-feedback residuals when compression with error
    feedback is on.  The selection generator is seeded from ``gen``.  On
    the meta device ``gen`` is None and nothing is drawn
    (:func:`abstract_state`); the round index, the optimizer steps and the
    selection generator are host values, as on the card."""
    device = resolve_device(device)
    cuts = wssl_cfg.resolve_cuts(model_cfg)
    params = tf.init_params(model_cfg, gen, device=device,
                            dtype=torch_dtype(model_cfg.param_dtype))
    stages = tf.partition_params(params, model_cfg, cuts)
    del params
    n = wssl_cfg.num_clients
    client_stack = tree_map(
        lambda a: a[None].expand((n,) + a.shape).clone(), stages[0])
    stages[0] = None
    opt_init, _ = make_optimizer(train_cfg.optimizer)
    edges = tuple(stages[1:-1])
    comp = wssl_cfg.compression
    ef = comp.enabled and comp.error_feedback
    seed = 0 if gen is None else int(torch.randint(
        0, 2 ** 62, (1,), generator=gen, device=gen.device))
    return WSSLState(
        client_stack=client_stack, server_params=stages[-1],
        edge_stages=edges, opt_client=opt_init(client_stack),
        opt_server=opt_init(stages[-1]),
        opt_edge=tuple(opt_init(e) for e in edges),
        importance=torch.full((n,), 1.0 / n, dtype=torch.float32,
                              device=device),
        round_index=torch.zeros((), dtype=torch.int32),
        rng=torch.Generator().manual_seed(seed),
        ef_residual=compress.init_ef_residual(client_stack) if ef else ())


def state_axes(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
               train_cfg: TrainConfig) -> WSSLState:
    """The logical-axes tree of :func:`init_state`'s state, leaf for leaf
    the ``state_axes`` JAX's ``init_state`` returns: client-stage leaves
    lead with ``"client"``, the optimizer moments follow their params,
    the step and the round index are scalars; ``rng`` maps to ``()``."""
    from repro_torch.optim.optimizers import AdamState, SgdState
    cuts = wssl_cfg.resolve_cuts(model_cfg)
    stages = tf.partition_axes(tf.param_axes_tree(model_cfg), model_cfg,
                               cuts)
    stacked = tree_map(lambda t: ("client",) + t, stages[0],
                       is_leaf=sharding.is_axes_leaf)

    def opt_axes(p_axes):
        if train_cfg.optimizer == "adamw":
            return AdamState(step=(), m=p_axes, v=p_axes)
        return SgdState(step=(), mom=p_axes)

    comp = wssl_cfg.compression
    ef = comp.enabled and comp.error_feedback
    edges = tuple(stages[1:-1])
    return WSSLState(
        client_stack=stacked, server_params=stages[-1], edge_stages=edges,
        opt_client=opt_axes(stacked), opt_server=opt_axes(stages[-1]),
        opt_edge=tuple(opt_axes(a) for a in edges), importance=(None,),
        round_index=(), rng=(), ef_residual=stacked if ef else ())


def abstract_state(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                   train_cfg: TrainConfig) -> Tuple[WSSLState, WSSLState]:
    """(the state of :func:`init_state` on the meta device, its axes):
    shapes and dtypes without allocating (JAX's ``abstract_state``)."""
    return (init_state(None, model_cfg, wssl_cfg, train_cfg, device="meta"),
            state_axes(model_cfg, wssl_cfg, train_cfg))


def _bind(tree: Params, grads: Params, layered: bool = False) -> Params:
    """Leaves that alias ``tree``'s storage and accumulate their gradients
    into ``grads``' storage.  A stacked leaf under ``"stack"`` becomes a
    list of per-layer leaves, so the backward of one layer adds into that
    layer's slice of the buffer instead of a full-size zero buffer."""
    if isinstance(tree, dict):
        return {k: _bind(v, grads[k], layered or k == "stack")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_bind(t, g, layered) for t, g in zip(tree, grads)]

    def leaf(p, g):
        t = p.detach().requires_grad_(True)
        t.grad = g
        return t

    if layered:
        return [leaf(tree[i], grads[i]) for i in range(tree.shape[0])]
    return leaf(tree, grads)


def _row(tree: Params, i: int) -> Params:
    return tree_map(lambda a: a[i], tree)


class ShardCtx(NamedTuple):
    """The client-axis context of a round run once a shard
    (:func:`make_sharded_round_fn`).  None everywhere a round runs flat:
    every helper below then returns its argument as it is."""

    group: Any           # the torch.distributed process group of the axis
    num_shards: int      # S
    index: int           # this rank's shard


def _loc(vec: Optional[torch.Tensor], ctx: Optional[ShardCtx],
         n_loc: int) -> Optional[torch.Tensor]:
    """A whole (N,) per-client vector's rows of this shard, (N/S,)."""
    if ctx is None or vec is None:
        return vec
    return vec[ctx.index * n_loc:(ctx.index + 1) * n_loc]


def _local_plan(plan, ctx: Optional[ShardCtx], n_loc: int):
    """A FaultPlan with every (N,) field cut to this shard's rows."""
    if ctx is None or plan is None:
        return plan
    return type(plan)(*[_loc(v, ctx, n_loc) for v in plan])


def _psum(x, ctx: Optional[ShardCtx]):
    """The cross-shard sum of a tensor or a tree's leaves, in place."""
    if ctx is None:
        return x
    return sharding.all_reduce_tree(x, ctx.group)


def _psum_scalars(ctx: Optional[ShardCtx], *xs: torch.Tensor):
    """0-d tensors summed across shards in one collective."""
    if ctx is None:
        return list(xs)
    return sharding.sum_scalars(ctx.group, *xs)


def _gather(vec: torch.Tensor, ctx: Optional[ShardCtx]) -> torch.Tensor:
    """A shard's (N/S, ...) rows back to the whole (N, ...), flat client
    order."""
    if ctx is None:
        return vec
    return sharding.all_gather_rows(vec, ctx.group)


def _group(ctx: Optional[ShardCtx]):
    return None if ctx is None else ctx.group


def _check_ported(state, batch, shard_ctx, train_cfg: TrainConfig,
                  wssl_cfg: WSSLConfig, impl: str) -> None:
    """Refuse, before any state moves, a client axis that does not divide
    the clients or a state that is not this shard's, a client chunk that
    does not divide the (per-shard) clients (``ValueError``, as the JAX
    round raises at trace time), and an attention impl without a backward
    (``kernel`` / ``pallas``)."""
    n = wssl_cfg.num_clients
    n_loc = n
    if shard_ctx is not None:
        if n % shard_ctx.num_shards:
            raise ValueError(f"num_clients={n} must divide evenly over "
                             f"{shard_ctx.num_shards} client shards")
        n_loc = n // shard_ctx.num_shards
        rows = tree_leaves(state.client_stack)[0].shape[0]
        if rows != n_loc:
            raise ValueError(f"the client stack holds {rows} clients, not "
                             f"this shard's {n_loc} (place_state)")
    chunk = train_cfg.client_chunk
    if chunk is not None and n_loc % chunk:
        if shard_ctx is None:
            raise ValueError(f"client_chunk={chunk} must divide num_clients="
                             f"{n}")
        raise ValueError(f"client_chunk={chunk} must divide the per-shard "
                         f"client count {n_loc} (num_clients/num_shards)")
    attn.check_train_impl(impl)
    aggregation.get_aggregator(wssl_cfg.resolve_aggregation().rule)


# the integers the JAX round folds into its selection key for the
# compression draws: each uploaded leaf (then its index), and each hop
# crossing h (client -> first stage after it is hop 0), up and down; and
# for the fault plan and the gradient noise
TAG_UPDATE = 0xC09
TAG_ACT_UP = 0xAC0
TAG_ACT_DOWN = 0xDC0
TAG_FAULT = 0x0DD
TAG_NOISE = 0xBAD

Uniform = Callable[[int, Optional[int], Tuple[int, ...]], torch.Tensor]


def _stream(state: WSSLState, tag: int, leaf: Optional[int], device,
            ctx: Optional[ShardCtx] = None) -> torch.Generator:
    """The generator of one of the round's own draws: seeded from the
    selection generator's seed, the round, the tag and the leaf, and in a
    round of more than one shard the shard index (each shard draws its
    own rows' values)."""
    shard = (ctx.index,) if ctx is not None and ctx.num_shards > 1 else ()
    return wssl.derived_generator(state.rng.initial_seed(),
                                  int(state.round_index), tag,
                                  -1 if leaf is None else leaf, *shard,
                                  device=device)


def _draws(state: WSSLState, comp_uniform: Optional[Uniform], device,
           ctx: Optional[ShardCtx] = None) -> Uniform:
    """The round's compression draws: ``(tag, leaf, shape) -> U[0, 1)``
    fp32 on ``device``, from ``comp_uniform`` or from a generator of their
    own (see the module docstring).  ``shape`` is this shard's."""
    def draw(tag, leaf, shape):
        if comp_uniform is not None:
            return comp_uniform(tag, leaf, tuple(shape)).to(
                device=device, dtype=torch.float32).contiguous()
        return torch.rand(tuple(shape),
                          generator=_stream(state, tag, leaf, device, ctx),
                          dtype=torch.float32, device=device)
    return draw


def _compress_update(state: WSSLState, old_rows: List[torch.Tensor],
                     saved: List[int], sel: List[int], mask: torch.Tensor,
                     comp_cfg, comp_p: compress.CompressionParams,
                     draw: Uniform) -> None:
    """Send the participating clients' stage deltas through the wire, in
    place: each saved row of the client stack (``old_rows`` holds the
    pre-step rows of the clients ``saved``, the ``mask > 0`` clients
    ``sel`` among them) becomes ``old + sent`` (what the aggregation
    reads; sent is 0 on a masked row) and the residuals carry what the
    wire dropped.  One leaf at a time, so one leaf's transients are live
    at once."""
    res = tree_leaves(state.ef_residual)
    pos = [saved.index(i) for i in sel]
    for i, (leaf, old) in enumerate(zip(tree_leaves(
            state.client_stack), old_rows)):
        n, m = leaf.shape[0], leaf[0].numel()
        delta = torch.zeros(leaf.shape, dtype=torch.float32,
                            device=leaf.device)
        delta[sel] = leaf[sel].float() - old[pos].float()
        u = ([draw(TAG_UPDATE, i, (n, m))]
             if comp_cfg.kind == "quant" and m else None)
        sent, new_r = compress.apply_compression(
            delta, res[i] if res else (), mask, comp_cfg, comp_p, u=u)
        del delta, u
        leaf[saved] = (old.float() + sent[saved]).to(leaf.dtype)
        if res:
            res[i].copy_(new_r)


def _host_values(t: torch.Tensor) -> List[float]:
    """``t``'s values on the host.  A meta tensor (the dry run counts a
    round on the meta device) has none: it reads as all ones, every client
    selected."""
    if t.is_meta:
        return [1.0] * t.numel()
    return t.cpu().tolist()


def _keep_rows(plan: Optional[sim_faults.FaultPlan], sel: List[int],
               compressing: bool) -> List[int]:
    """The clients whose pre-step rows the round keeps: the selected ones
    when an update transform or the compression reads them, and every
    adaptive client (its row is replaced whether selected or not, and the
    compressed upload reads its pre-step row back); [] when nothing
    reads them."""
    if plan is None:
        return list(sel) if compressing else []
    adaptive = set(torch.nonzero(plan.adaptive > 0).flatten().tolist())
    scale = (plan.grad_scale * plan.byz_scale).tolist()
    if not (compressing or adaptive or any(scale[i] != 1.0 for i in sel)):
        return []
    return sorted(set(sel) | adaptive)


# ---------------------------------------------------------------------------
# The pieces of a round, shared with core/async_round.py
# ---------------------------------------------------------------------------


def _fault_plan(state: WSSLState, scenario, wssl_cfg: WSSLConfig,
                fd: sim_faults.FaultDraws, device
                ) -> Optional[sim_faults.FaultPlan]:
    """The round's fault plan, from a stream of its own (or ``fd``), or
    None without a scenario."""
    if scenario is None:
        return None
    return sim_faults.sample_fault_plan(
        scenario, wssl_cfg.num_clients, num_hops=len(state.edge_stages),
        hop_replicas=wssl_cfg.hop_replicas,
        generator=_stream(state, TAG_FAULT, None, device), draws=fd,
        device=device)


def _moe_beyond_client(cfg: ModelConfig, state: WSSLState) -> bool:
    """Whether an edge or the server stage holds an MoE layer, whose aux
    loss enters the objective for every client, selected or not."""
    specs = cfg.layer_specs()
    rem = len(state.server_params.get("rem", []))
    shared = sum(tf._num_blocks(st["stack"])
                 for st in (*state.edge_stages, state.server_params))
    return ((shared > 0 and any(sp.mlp == MLP_MOE
                                for sp in specs[:cfg.period]))
            or any(sp.mlp == MLP_MOE for sp in specs[len(specs) - rem:]))


class _Grads(NamedTuple):
    loss: torch.Tensor                 # the objective: weighted CE + aux
    pcl: torch.Tensor                  # (N,) per-client loss (0 unrun)
    client: Params                     # leaves (N, ...), param dtype
    server: Params
    edges: List[Params]
    hop_bytes: List[int]               # per client, per hop crossing
    rows: int                          # d-vectors per client


def _client_grads(state: WSSLState, tokens: torch.Tensor,
                  labels: torch.Tensor, coef: torch.Tensor,
                  run_rows: List[int], *, model_cfg: ModelConfig,
                  train_cfg: TrainConfig, comp_cfg,
                  comp_p: Optional[compress.CompressionParams],
                  draw: Uniform, impl: str,
                  embeds: Optional[torch.Tensor] = None,
                  ctx: Optional[ShardCtx] = None) -> _Grads:
    """Algorithm 2 steps 2-4 for the clients ``run_rows``: each one's split
    forward and chained backward, its loss weighted by ``coef[i]``.  With
    an MoE layer past the client stage every client runs instead, and each
    one's edge and server aux enters at 1/N (see the module docstring).

    With a ``ctx`` the rows are this shard's (``coef`` is (N/S,)): the aux
    weight is 1/N, the loss terms and the shared stages' gradients are
    summed across shards (JAX's psum of the per-shard sums), and ``pcl``
    stays local.

    With ``train_cfg.client_chunk`` the clients go in chunks of that many,
    as JAX's ``_client_grads_chunked`` scans them: each chunk's
    shared-stage gradients (param dtype) and weighted loss are summed
    over its clients, then added into fp32 accumulators across chunks and
    cast back; the activation-compression draws are one ``(chunk * rows,
    d)`` draw per chunk and hop, ``draw(tag, chunk_index, shape)`` (JAX
    folds the chunk index in after the tag).  Without it the loop is one
    chunk of all N clients, one ``(N * rows, d)`` draw per hop with
    ``leaf=None``.

    ``embeds`` (N, b, F, D): each client's patch embeddings, spliced in
    front of its tokens by its own stage; every hop then carries F + S
    positions per row."""
    cfg = model_cfg
    n = coef.shape[0]
    n_all = n if ctx is None else n * ctx.num_shards
    num_edges = len(state.edge_stages)
    remat, span = train_cfg.remat, train_cfg.remat_span
    compress_acts = comp_cfg.enabled and comp_cfg.activations
    chunk = train_cfg.client_chunk
    k = n if chunk is None else chunk
    # d-vectors per client: the image prefix crosses every hop too
    rows = tokens.shape[1] * (tokens.shape[2] + (
        embeds.shape[2] if embeds is not None else 0))
    hop_u: Dict[int, torch.Tensor] = {}
    with_aux = _moe_beyond_client(cfg, state)
    run = set(range(n)) if with_aux else set(run_rows)
    # each client's server aux and each edge stage's, and the weight 1/N
    # each enters the objective at
    srv_aux = torch.zeros((n,), dtype=torch.float32, device=coef.device)
    edge_aux = torch.zeros((num_edges, n), dtype=torch.float32,
                           device=coef.device)
    aux_w = torch.tensor(1.0 / n_all, dtype=torch.float32,
                         device=coef.device)

    def hop(a: torch.Tensor, tag: int, i: int) -> torch.Tensor:
        """What crosses a hop: ``a`` itself, or its wire reconstruction."""
        if not compress_acts:
            return a
        u = None
        if comp_cfg.kind == "quant":
            if tag not in hop_u:
                hop_u[tag] = draw(tag, None if chunk is None else i // k,
                                  (k * rows, a.shape[-1]))
            j = i % k
            u = hop_u[tag][j * rows:(j + 1) * rows]
        return compress.compress_activations(a, comp_cfg, comp_p, u=u)

    g_client = tree_map(torch.zeros_like, state.client_stack)
    g_server = tree_map(torch.zeros_like, state.server_params)
    g_edges = [tree_map(torch.zeros_like, e) for e in state.edge_stages]
    pcl = torch.zeros((n,), dtype=torch.float32, device=coef.device)

    def client_pass(i: int, server_b, edges_b) -> torch.Tensor:
        """Client i's split forward and chained backward; returns its loss.
        Its graph, and with it the bound leaves whose ``.grad`` views keep
        the gradient buffers alive, dies when it returns."""
        client_b = _bind(_row(state.client_stack, i), _row(g_client, i))
        acts = tf.client_forward(
            client_b, cfg, tokens[i],
            embeds=None if embeds is None else embeds[i], impl=impl,
            remat=remat, remat_span=span)
        x = hop(acts.detach(), TAG_ACT_UP, i).requires_grad_(True)
        relays = []
        for j, edge_b in enumerate(edges_b):
            y, aux_j = tf.stage_forward(edge_b, cfg, x, j + 1, impl=impl,
                                        remat=remat, remat_span=span,
                                        with_aux=True)
            relays.append((x, y, aux_j))
            if with_aux:
                edge_aux[j, i] = aux_j.detach()
            x = hop(y.detach(), TAG_ACT_UP + j + 1, i).requires_grad_(True)
        loss_i, aux_i = tf.server_loss(server_b, cfg, x, labels[i],
                                       impl=impl, remat=remat,
                                       remat_span=span)
        obj = coef[i] * loss_i
        if with_aux:
            srv_aux[i] = aux_i.detach()
            if aux_i.requires_grad:
                obj = obj + aux_i * aux_w
        obj.backward()
        g_x = hop(x.grad, TAG_ACT_DOWN + num_edges, i)
        for j in reversed(range(num_edges)):
            x_in, y, aux_j = relays[j]
            if with_aux and aux_j.requires_grad:
                torch.autograd.backward([y, aux_j], [g_x, aux_w])
            else:
                y.backward(g_x)
            g_x = hop(x_in.grad, TAG_ACT_DOWN + j, i)
        acts.backward(g_x)
        return loss_i.detach()

    def chunk_pass(members: range, gs: Params, ge: List[Params]) -> None:
        server_b = _bind(state.server_params, gs)
        edges_b = [_bind(e, g) for e, g in zip(state.edge_stages, ge)]
        with torch.enable_grad():
            for i in members:
                if i in run:
                    pcl[i] = client_pass(i, server_b, edges_b)

    n_t = torch.tensor(float(n_all), dtype=torch.float32, device=coef.device)
    if chunk is None:
        chunk_pass(range(n), g_server, g_edges)
        _psum((g_server, g_edges), ctx)
        if not with_aux:
            (loss,) = _psum_scalars(ctx, torch.sum(coef * pcl))
        else:
            # JAX: the CE sum plus the server aux's client mean, then each
            # edge stage's client mean (sums across shards, then / N)
            loss, srv_sum, *edge_sums = _psum_scalars(
                ctx, torch.sum(coef * pcl), srv_aux.sum(),
                *(edge_aux[j].sum() for j in range(num_edges)))
            loss = loss + srv_sum / n_t
            edge_total = torch.zeros((), dtype=torch.float32,
                                     device=coef.device)
            for j in range(num_edges):
                edge_total = edge_total + edge_sums[j] / n_t
            loss = loss + edge_total
    else:
        f32 = lambda t: tree_map(lambda a: torch.zeros(
            a.shape, dtype=torch.float32, device=a.device), t)
        acc_s, acc_e = f32(state.server_params), [f32(e) for e in
                                                   state.edge_stages]
        loss = torch.zeros((), dtype=torch.float32, device=coef.device)
        aux_acc = torch.zeros((), dtype=torch.float32, device=coef.device)
        k_t = torch.tensor(float(k), dtype=torch.float32, device=coef.device)
        for c in range(0, n, k):
            members = range(c, c + k)
            if run.isdisjoint(members):
                continue            # its gradients and loss terms are 0
            hop_u.clear()
            chunk_pass(members, g_server, g_edges)
            for acc, g in zip(tree_leaves((acc_s, acc_e)),
                              tree_leaves((g_server, g_edges))):
                acc.add_(g.float())
                g.zero_()
            loss_c = torch.sum(coef[c:c + k] * pcl[c:c + k])
            if with_aux:
                # JAX: the chunk's server-aux mean reweighted by chunk / N;
                # the edge aux summed over the chunk, over all chunks, / N
                loss_c = loss_c + srv_aux[c:c + k].sum() / k_t * (k / n_all)
                aux_sum = torch.zeros((), dtype=torch.float32,
                                      device=coef.device)
                for j in range(num_edges):
                    aux_sum = aux_sum + edge_aux[j, c:c + k].sum()
                aux_acc = aux_acc + aux_sum
            loss = loss + loss_c
        if with_aux:
            loss, aux_acc = _psum_scalars(ctx, loss, aux_acc)
            loss = loss + aux_acc / n_t
        else:
            (loss,) = _psum_scalars(ctx, loss)
        # the fp32 chunk accumulators cast back to the params' dtype, then
        # summed across shards
        cast = lambda acc, p: tree_map(lambda a, b: a.to(b.dtype), acc, p)
        g_server = cast(acc_s, state.server_params)
        g_edges = [cast(a, e) for a, e in zip(acc_e, state.edge_stages)]
        del acc_s, acc_e
        _psum((g_server, g_edges), ctx)
    del hop_u
    hop_bytes = [rows * cfg.d_model * torch_dtype(cfg.dtype).itemsize
                 ] * (num_edges + 1)
    return _Grads(loss, pcl, g_client, g_server, g_edges, hop_bytes, rows)


def _clip_and_corrupt(state: WSSLState, g: _Grads,
                      plan: Optional[sim_faults.FaultPlan],
                      train_cfg: TrainConfig, fd: sim_faults.FaultDraws,
                      device, ctx: Optional[ShardCtx] = None) -> None:
    """The global-norm clip of each stage's gradients, then the plan's
    corruption of the client-stage gradients, in place (adversarial
    corruption models the *sent* update, so it follows the clip).  With a
    ``ctx`` the client stack's squared norm sums across shards, and
    ``plan`` is this shard's rows."""
    if train_cfg.grad_clip:
        clip_by_global_norm(g.client, train_cfg.grad_clip,
                            group=_group(ctx))
        clip_by_global_norm(g.server, train_cfg.grad_clip)
        for ge in g.edges:
            clip_by_global_norm(ge, train_cfg.grad_clip)
    if plan is not None:
        sim_faults.corrupt_client_grads(
            plan, g.client, noise=fd.noise,
            generator=_stream(state, TAG_NOISE, None, device, ctx))


def _saved_rows(state: WSSLState, saved: List[int]) -> List[torch.Tensor]:
    """Copies of the clients ``saved``'s rows of every client leaf."""
    return ([leaf[saved] for leaf in tree_leaves(state.client_stack)]
            if saved else [])


def _step(state: WSSLState, g: _Grads, mask: torch.Tensor,
          train_cfg: TrainConfig, schedule, step_shared: bool) -> None:
    """The optimizer step, in place: the client stack masked to ``mask``
    (a masked row is frozen bit for bit), the server and edge stages only
    when ``step_shared`` (a round without a participant leaves them and
    their optimizer state untouched; JAX steps them and keeps the old
    values)."""
    _, opt_update = make_optimizer(train_cfg.optimizer)
    lr = schedule(int(state.round_index))
    wd = train_cfg.weight_decay
    opt_update(state.client_stack, g.client, state.opt_client, lr=lr,
               weight_decay=wd, mask=mask)
    if step_shared:
        opt_update(state.server_params, g.server, state.opt_server, lr=lr,
                   weight_decay=wd)
        for ep, ge, oe in zip(state.edge_stages, g.edges, state.opt_edge):
            opt_update(ep, ge, oe, lr=lr, weight_decay=wd)


def _transform_updates(plan: sim_faults.FaultPlan, state: WSSLState,
                       old_rows: List[torch.Tensor], saved: List[int],
                       mask: torch.Tensor,
                       ctx: Optional[ShardCtx] = None) -> None:
    """Straggler / slow-hop progress and Byzantine amplification on the
    post-optimizer update, then the adaptive clients' crafted stage from
    the ``mask`` clients' honest updates, in place.  With a ``ctx``,
    ``plan`` and ``mask`` are this shard's rows and the honest statistics
    run over every shard's clients."""
    sim_faults.scale_client_updates(plan, state.client_stack, old_rows,
                                    rows=saved)
    sim_faults.adaptive_scale_updates(plan, state.client_stack, old_rows,
                                      mask, rows=saved, group=_group(ctx))


def _validate(state: WSSLState, val_batch, *, model_cfg: ModelConfig,
              wssl_cfg: WSSLConfig, impl: str,
              ctx: Optional[ShardCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every client's stage (as it stands) through the shared stages on
    the server-held set -> ``(val_losses, importance)``; without a set
    the losses are 0 and the importance carries over.  With a ``ctx``
    each shard validates its own clients and the (N,) losses gather."""
    n = wssl_cfg.num_clients
    dev = state.importance.device
    if val_batch is None:
        return (torch.zeros((n,), dtype=torch.float32, device=dev),
                state.importance.clone())
    rows = tree_leaves(state.client_stack)[0].shape[0]
    val_losses = torch.zeros((rows,), dtype=torch.float32, device=dev)
    vt, vl = val_batch["tokens"], val_batch["labels"]
    with torch.no_grad():
        for i in range(rows):
            a = tf.client_forward(_row(state.client_stack, i), model_cfg,
                                  vt, impl=impl, remat=False)
            for j, ep in enumerate(state.edge_stages):
                a = tf.stage_forward(ep, model_cfg, a, j + 1, impl=impl,
                                     remat=False)
            val_losses[i], _ = tf.server_loss(state.server_params, model_cfg,
                                              a, vl, impl=impl, remat=False)
    val_losses = _gather(val_losses, ctx)
    return val_losses, wssl.compute_importance(val_losses, wssl_cfg,
                                               prev=state.importance)


def client_stage_bytes(state: WSSLState) -> int:
    """Bytes of one client's stage (the sync and resync payload)."""
    return tree_bytes(state.client_stack) // tree_leaves(
        state.client_stack)[0].shape[0]


def _byte_metrics(state: WSSLState, g: _Grads, sel: torch.Tensor,
                  uploads: torch.Tensor, *, model_cfg: ModelConfig,
                  wssl_cfg: WSSLConfig, comp_cfg, comp_p,
                  resync: Optional[torch.Tensor] = None,
                  ctx: Optional[ShardCtx] = None
                  ) -> Dict[str, torch.Tensor]:
    """The round's byte counts as :class:`RoundMetrics` fields: ``sel``
    clients ran the split pipeline, ``uploads`` stage updates went up
    (compressed when compression is on) and the global stage went back
    to all N; ``resync`` (async rounds) is added to ``bytes_sync``.  With
    a ``ctx``, the two-level tree's cross- and intra-shard bytes."""
    n = wssl_cfg.num_clients
    num_hops = len(g.hop_bytes)
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=sel.device)
    bytes_per_hop = sel * f32(g.hop_bytes)
    stage_bytes = f32(client_stage_bytes(state))
    update_raw = uploads * stage_bytes
    if comp_cfg.enabled:
        comp_stage = f32(compress.compressed_stage_bytes(
            state.client_stack, comp_cfg, comp_p))
        update_comp = uploads * comp_stage
        # sync = compressed upload from the uploaders + raw broadcast to all
        bytes_sync = uploads * comp_stage + n * stage_bytes
    else:
        update_comp = update_raw
        bytes_sync = sync_round_bytes(uploads, n, stage_bytes)
    if resync is not None:
        bytes_sync = bytes_sync + resync
    if comp_cfg.enabled and comp_cfg.activations:
        wire = compress.activation_wire_bytes(g.rows, model_cfg.d_model,
                                              comp_cfg, comp_p)
        act_raw = sel * 2.0 * f32(g.hop_bytes).sum()
        act_comp = sel * 2.0 * f32(wire * num_hops)
    else:
        act_raw = act_comp = f32(0.0)
    out = dict(bytes_up=bytes_per_hop.sum(), bytes_down=bytes_per_hop.sum(),
               bytes_per_hop=bytes_per_hop, bytes_sync=bytes_sync,
               bytes_update_raw=update_raw, bytes_update_comp=update_comp,
               bytes_act_raw=act_raw, bytes_act_comp=act_comp)
    if ctx is not None:
        out["bytes_cross_shard"], out["bytes_intra_shard"] = \
            hierarchical_sync_bytes(uploads, n, ctx.num_shards, stage_bytes,
                                    aggregation.rule_decomposes(wssl_cfg))
    return out


# ---------------------------------------------------------------------------
# The synchronous round
# ---------------------------------------------------------------------------


def wssl_round(state: WSSLState, batch: Dict[str, torch.Tensor],
               val_batch: Optional[Dict[str, torch.Tensor]] = None,
               scenario=None, agg_p=None,
               comp_p: Optional[compress.CompressionParams] = None, *,
               model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
               train_cfg: TrainConfig, schedule, impl: str = "chunked",
               shard_ctx: Optional[ShardCtx] = None,
               gumbel: Optional[torch.Tensor] = None,
               comp_uniform: Optional[Uniform] = None,
               fault_draws: Optional[sim_faults.FaultDraws] = None
               ) -> Tuple[WSSLState, RoundMetrics]:
    """One communication round, in place.  batch: tokens/labels (N, b, S),
    and with a vision frontend optionally ``embeds`` (N, b, F, D), each
    client's patch embeddings; val_batch: tokens/labels (bv, S), the
    server-held validation set (None skips validation and keeps the
    importance).

    ``scenario``: a :class:`~repro_torch.sim.faults.ScenarioParams`
    (``sim.scenario_params`` lowers a ``Scenario``): dropped clients and
    clients behind dead hop replicas mask out, adversaries' labels and
    gradients are corrupted, stragglers, slow hops and Byzantine clients
    scale their update, adaptive clients craft theirs.  ``agg_p``: the
    :class:`~repro_torch.core.aggregation.AggParams` of the rule (default:
    lowered from the config).  ``comp_p`` overrides the compression
    block's runtime values.

    ``shard_ctx``: None runs the round flat.  A :class:`ShardCtx` runs it
    as one shard of a client-sharded round (see the module docstring):
    the state's client-axis leaves and the batch hold this shard's N/S
    clients (``sharding.shard_state`` / ``shard_batch``), and the metrics
    come back whole on every rank.

    ``gumbel`` (N,) replaces the selection draw from ``state.rng``,
    ``comp_uniform`` the compression draws and ``fault_draws`` the fault
    plan's and the gradient noise's (tests feed the JAX draws); the
    compression and fault draws never advance ``state.rng``.  In a
    sharded round ``comp_uniform`` and the noise hook are asked for this
    shard's shapes; ``gumbel`` and the plan's draws stay whole."""
    ctx = shard_ctx
    _check_ported(state, batch, ctx, train_cfg, wssl_cfg, impl)
    n = wssl_cfg.num_clients
    n_loc = n // ctx.num_shards if ctx is not None else n
    comp_cfg = wssl_cfg.compression
    if comp_cfg.enabled and comp_p is None:
        comp_p = compress.compression_params(comp_cfg)
    dev = state.importance.device
    draw = _draws(state, comp_uniform, dev, ctx)
    fd = fault_draws if fault_draws is not None else sim_faults.FaultDraws()

    # ---- fault injection: the plan first, so its latencies can reach the
    # selection draw ------------------------------------------------------
    plan = _fault_plan(state, scenario, wssl_cfg, fd, dev)

    # ---- Algorithm 1: selection (round 0 selects every client); with
    # select_staleness_beta > 0 slow clients pay a latency penalty --------
    penalty = None
    if wssl_cfg.select_staleness_beta and plan is not None:
        penalty = sim_faults.client_latencies(plan, n) - 1.0
    mask = wssl.participation_mask(state.importance, wssl_cfg,
                                   state.round_index, generator=state.rng,
                                   gumbel=gumbel, penalty=penalty)
    if plan is not None:
        # dropout: dropped clients compose like unselected ones
        mask = mask * plan.keep
    agg_w = wssl.aggregation_weights(state.importance, mask, wssl_cfg)
    # the shard's views of the whole (N,) decision vectors above (the
    # vectors themselves when flat)
    plan_loc = _local_plan(plan, ctx, n_loc)
    mask_loc = _loc(mask, ctx, n_loc)
    offset = 0 if ctx is None else ctx.index * n_loc
    selected = _host_values(mask)
    sel_rows = [i for i in range(n_loc) if selected[offset + i] > 0]
    any_sel = any(v > 0 for v in selected)

    # ---- Algorithm 2 steps 2-4: split forward, chained backward ---------
    labels = batch["labels"]
    if plan is not None:
        labels = sim_faults.corrupt_labels(plan_loc, labels,
                                           model_cfg.vocab_size)
    g = _client_grads(state, batch["tokens"], labels,
                      _loc(agg_w, ctx, n_loc) * mask_loc, sel_rows,
                      model_cfg=model_cfg, train_cfg=train_cfg,
                      comp_cfg=comp_cfg, comp_p=comp_p, draw=draw, impl=impl,
                      embeds=batch.get("embeds"), ctx=ctx)
    _clip_and_corrupt(state, g, plan_loc, train_cfg, fd, dev, ctx)

    # ---- optimizer (masked for unselected clients), in place ------------
    # the update transforms and the compressed upload read the pre-step
    # rows, which the in-place step overwrites: keep the ones they read
    saved = _keep_rows(plan_loc, sel_rows, comp_cfg.enabled)
    old_rows = _saved_rows(state, saved)
    _step(state, g, mask_loc, train_cfg, schedule,
          step_shared=plan is None or any_sel)
    g = g._replace(client=(), server=(), edges=[])   # free the gradients
    if plan is not None:
        _transform_updates(plan_loc, state, old_rows, saved, mask_loc, ctx)

    # ---- validation on the server-held set -> importance ----------------
    val_losses, importance = _validate(state, val_batch, model_cfg=model_cfg,
                                       wssl_cfg=wssl_cfg, impl=impl, ctx=ctx)

    # ---- update-path compression, then Algorithm 2 step 5: aggregation
    # through the registry + sync (dropout can empty the selection: `safe`
    # falls back to a no-op sync); sharded, through the two-level tree ---
    with torch.no_grad():
        if comp_cfg.enabled:
            _compress_update(state, old_rows, saved, sel_rows, mask_loc,
                             comp_cfg, comp_p, draw)
        del old_rows
        if ctx is None:
            global_client = aggregation.aggregate_clients(
                state.client_stack, importance, mask, wssl_cfg,
                safe=plan is not None, params=agg_p)
        else:
            global_client = aggregation.shard_aggregate_clients(
                state.client_stack, importance, mask, wssl_cfg,
                group=ctx.group, shard_index=ctx.index,
                num_shards=ctx.num_shards, safe=plan is not None,
                params=agg_p)
        wssl.broadcast_global(state.client_stack, global_client)
        del global_client
        state.importance.copy_(importance)
    state.round_index += 1

    # ---- communication accounting --------------------------------------
    sel = mask.sum()
    metrics = RoundMetrics(
        loss=g.loss, per_client_loss=_gather(g.pcl, ctx) * mask,
        val_loss=val_losses, mask=mask, importance=importance,
        **_byte_metrics(state, g, sel, sel, model_cfg=model_cfg,
                        wssl_cfg=wssl_cfg, comp_cfg=comp_cfg, comp_p=comp_p,
                        ctx=ctx))
    return state, metrics


def make_round_fn(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                  train_cfg: TrainConfig, impl: str = "chunked"):
    """The round with its configs and learning-rate schedule closed over:
    ``round_fn(state, batch, val_batch=None, scenario=None, agg_p=None,
    comp_p=None, *, gumbel=None, comp_uniform=None, fault_draws=None)``.
    The state is updated in place (the counterpart of the JAX factory's
    ``donate=True``)."""
    schedule = make_schedule(train_cfg.schedule, train_cfg.learning_rate,
                             train_cfg.warmup_steps, train_cfg.rounds)
    return functools.partial(wssl_round, model_cfg=model_cfg,
                             wssl_cfg=wssl_cfg, train_cfg=train_cfg,
                             schedule=schedule, impl=impl)


def make_sharded_round_fn(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                          train_cfg: TrainConfig, mesh, *,
                          impl: str = "chunked"):
    """Client-axis scale-out: :func:`wssl_round` as one shard of the client
    axis ``mesh`` (a ``launch/mesh.py::ClientGroup``: this rank's process
    group, ``num_shards`` and ``index``), called on every rank of the
    group with the same arguments.

    Each rank holds N/S clients (stack, moments, residuals, batch rows);
    their forward, backward, optimizer step and compression run locally,
    the shared stages' gradients and the aggregation tree sum across the
    group, and the (N,) decision vectors are whole on every rank, so
    selection and faults are the flat round's.  Returns ``round_fn(state,
    batch, val_batch=None, scenario=None, agg_p=None, comp_p=None, *,
    gumbel=None, comp_uniform=None, fault_draws=None)``, updating this
    rank's state in place, with ``place_state`` (a whole state -> this
    rank's copy), ``place_batch`` (a whole batch -> this rank's rows),
    ``num_shards`` and ``mesh``.  Raises ``ValueError`` when the clients do
    not divide evenly over the shards."""
    n = wssl_cfg.num_clients
    if n % mesh.num_shards != 0:
        raise ValueError(f"num_clients={n} must divide evenly over "
                         f"{mesh.num_shards} client shards")
    ctx = ShardCtx(group=mesh.group, num_shards=mesh.num_shards,
                   index=mesh.index)
    schedule = make_schedule(train_cfg.schedule, train_cfg.learning_rate,
                             train_cfg.warmup_steps, train_cfg.rounds)
    round_fn = functools.partial(wssl_round, model_cfg=model_cfg,
                                 wssl_cfg=wssl_cfg, train_cfg=train_cfg,
                                 schedule=schedule, impl=impl, shard_ctx=ctx)
    round_fn.place_state = lambda state: sharding.shard_state(
        state, ctx.num_shards, ctx.index)
    round_fn.place_batch = lambda batch: sharding.shard_batch(
        batch, ctx.num_shards, ctx.index)
    round_fn.num_shards = ctx.num_shards
    round_fn.mesh = mesh
    return round_fn
