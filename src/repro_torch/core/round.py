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
  ``agg_w * mask``; a client with mask 0 has coefficient 0, so its
  gradients are 0 and AdamW's mask freezes it — the loop skips it, and
  every output stays what the vmapped round computes (its per-client
  loss is reported as 0 either way).
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
  folds into its selection key, ``leaf`` the leaf index folded in after it
  for updates and None for activations), else from a ``torch.Generator``
  seeded from the selection generator's seed, the round, the tag and the
  leaf.  They never advance the selection stream: every round draws its
  selection from the state it would without compression (the masks then
  match wherever the importance does).  JAX draws one (N*b*s, d)
  activation ``u`` for all clients; the loop takes client i's rows.
* Dense stacks have no MoE aux loss, so the edge and server aux terms of
  the JAX objective are 0 here (MoE is ROADMAP Queue 1, item 11).

Every ported layer kind trains: global and local attention, the Mamba-2
SSD block and the RG-LRU block, the recurrent ones through their plain
scans (``ssd_chunked``, the doubling scan), as the JAX round trains them
with ``impl="dense"``.  Not ported yet, and raising
``NotImplementedError`` naming the ROADMAP item rather than being
ignored: client-axis sharding (item 13), ``TrainConfig.client_chunk``
(item 7) and frontend embeddings (item 11).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch import compress
from repro_torch.config import ModelConfig, TrainConfig, WSSLConfig
from repro_torch.core import aggregation, wssl
from repro_torch.core.protocol import sync_round_bytes, tree_bytes
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
    # sharded rounds only (not ported): 0.0
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
    feedback is on.  The selection generator is seeded from ``gen``."""
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
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=gen,
                             device=gen.device))
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


def _check_ported(batch, shard_ctx, train_cfg: TrainConfig,
                  wssl_cfg: WSSLConfig, impl: str) -> None:
    """Refuse, before any state moves, what the port does not run yet."""
    if shard_ctx is not None:
        raise NotImplementedError(
            "client-axis sharding is not ported yet (ROADMAP Queue 1, "
            "item 13)")
    if train_cfg.client_chunk is not None:
        raise NotImplementedError(
            "TrainConfig.client_chunk is not ported yet (ROADMAP Queue 1, "
            "item 7: the client-chunked round)")
    if "embeds" in batch:
        raise NotImplementedError(
            "frontend embeddings are not ported yet (ROADMAP Queue 1, "
            "item 11: models/frontend.py)")
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


def _stream(state: WSSLState, tag: int, leaf: Optional[int], device
            ) -> torch.Generator:
    """The generator of one of the round's own draws: seeded from the
    selection generator's seed, the round, the tag and the leaf."""
    return wssl.derived_generator(state.rng.initial_seed(),
                                  int(state.round_index), tag,
                                  -1 if leaf is None else leaf,
                                  device=device)


def _draws(state: WSSLState, comp_uniform: Optional[Uniform], device
           ) -> Uniform:
    """The round's compression draws: ``(tag, leaf, shape) -> U[0, 1)``
    fp32 on ``device``, from ``comp_uniform`` or from a generator of their
    own (see the module docstring)."""
    def draw(tag, leaf, shape):
        if comp_uniform is not None:
            return comp_uniform(tag, leaf, tuple(shape)).to(
                device=device, dtype=torch.float32).contiguous()
        return torch.rand(tuple(shape),
                          generator=_stream(state, tag, leaf, device),
                          dtype=torch.float32, device=device)
    return draw


def _compress_update(state: WSSLState, old_rows: List[torch.Tensor],
                     saved: List[int], sel: List[int], mask: torch.Tensor,
                     comp_cfg, comp_p: compress.CompressionParams,
                     draw: Uniform) -> None:
    """Send the selected clients' stage deltas through the wire, in place:
    each saved row of the client stack (``old_rows`` holds the pre-step
    rows of the clients ``saved``, the selected ones among them) becomes
    ``old + sent`` (what the aggregation reads; sent is 0 on an
    unselected row) and the residuals carry what the wire dropped.  One
    leaf at a time, so one leaf's transients are live at once."""
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


def wssl_round(state: WSSLState, batch: Dict[str, torch.Tensor],
               val_batch: Optional[Dict[str, torch.Tensor]] = None,
               scenario=None, agg_p=None,
               comp_p: Optional[compress.CompressionParams] = None, *,
               model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
               train_cfg: TrainConfig, schedule, impl: str = "dense",
               shard_ctx=None, gumbel: Optional[torch.Tensor] = None,
               comp_uniform: Optional[Uniform] = None,
               fault_draws: Optional[sim_faults.FaultDraws] = None
               ) -> Tuple[WSSLState, RoundMetrics]:
    """One communication round, in place.  batch: tokens/labels (N, b, S);
    val_batch: tokens/labels (bv, S), the server-held validation set (None
    skips validation and keeps the importance).

    ``scenario``: a :class:`~repro_torch.sim.faults.ScenarioParams`
    (``sim.scenario_params`` lowers a ``Scenario``): dropped clients and
    clients behind dead hop replicas mask out, adversaries' labels and
    gradients are corrupted, stragglers, slow hops and Byzantine clients
    scale their update, adaptive clients craft theirs.  ``agg_p``: the
    :class:`~repro_torch.core.aggregation.AggParams` of the rule (default:
    lowered from the config).  ``comp_p`` overrides the compression
    block's runtime values.

    ``gumbel`` (N,) replaces the selection draw from ``state.rng``,
    ``comp_uniform`` the compression draws and ``fault_draws`` the fault
    plan's and the gradient noise's (tests feed the JAX draws); the
    compression and fault draws never advance ``state.rng``."""
    _check_ported(batch, shard_ctx, train_cfg, wssl_cfg, impl)
    cfg = model_cfg
    n = wssl_cfg.num_clients
    num_edges = len(state.edge_stages)
    remat, span = train_cfg.remat, train_cfg.remat_span
    comp_cfg = wssl_cfg.compression
    if comp_cfg.enabled and comp_p is None:
        comp_p = compress.compression_params(comp_cfg)
    compress_acts = comp_cfg.enabled and comp_cfg.activations
    dev = state.importance.device
    draw = _draws(state, comp_uniform, dev)
    fd = fault_draws if fault_draws is not None else sim_faults.FaultDraws()

    # ---- fault injection: the plan first, from a stream of its own, so
    # its latencies can reach the selection draw ---------------------------
    plan = None
    if scenario is not None:
        plan = sim_faults.sample_fault_plan(
            scenario, n, num_hops=num_edges,
            hop_replicas=wssl_cfg.hop_replicas,
            generator=_stream(state, TAG_FAULT, None, dev), draws=fd,
            device=dev)

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
    coef = agg_w * mask
    selected = mask.cpu().tolist()
    sel_rows = [i for i in range(n) if selected[i] > 0]

    # ---- Algorithm 2 steps 2-4: split forward, chained backward ---------
    tokens, labels = batch["tokens"], batch["labels"]
    if plan is not None:
        labels = sim_faults.corrupt_labels(plan, labels, cfg.vocab_size)
    rows = tokens.shape[1] * tokens.shape[2]        # d-vectors per client
    hop_u: Dict[int, torch.Tensor] = {}

    def hop(a: torch.Tensor, tag: int, i: int) -> torch.Tensor:
        """What crosses a hop: ``a`` itself, or its wire reconstruction."""
        if not compress_acts:
            return a
        u = None
        if comp_cfg.kind == "quant":
            if tag not in hop_u:
                hop_u[tag] = draw(tag, None, (n * rows, a.shape[-1]))
            u = hop_u[tag][i * rows:(i + 1) * rows]
        return compress.compress_activations(a, comp_cfg, comp_p, u=u)

    g_client = tree_map(torch.zeros_like, state.client_stack)
    g_server = tree_map(torch.zeros_like, state.server_params)
    g_edges = [tree_map(torch.zeros_like, e) for e in state.edge_stages]
    server_b = _bind(state.server_params, g_server)
    edges_b = [_bind(e, g) for e, g in zip(state.edge_stages, g_edges)]
    pcl = torch.zeros((n,), dtype=torch.float32, device=mask.device)

    def client_pass(i: int) -> torch.Tensor:
        """Client i's split forward and chained backward; returns its loss.
        Its graph, and with it the bound leaves whose ``.grad`` views keep
        the gradient buffers alive, dies when it returns."""
        client_b = _bind(_row(state.client_stack, i), _row(g_client, i))
        acts = tf.client_forward(client_b, cfg, tokens[i], impl=impl,
                                 remat=remat, remat_span=span)
        x = hop(acts.detach(), TAG_ACT_UP, i).requires_grad_(True)
        relays = []
        for j, edge_b in enumerate(edges_b):
            y = tf.stage_forward(edge_b, cfg, x, j + 1, impl=impl,
                                 remat=remat, remat_span=span)
            relays.append((x, y))
            x = hop(y.detach(), TAG_ACT_UP + j + 1, i).requires_grad_(True)
        loss_i, _ = tf.server_loss(server_b, cfg, x, labels[i], impl=impl,
                                   remat=remat, remat_span=span)
        (coef[i] * loss_i).backward()
        g_x = hop(x.grad, TAG_ACT_DOWN + num_edges, i)
        for j in reversed(range(num_edges)):
            x_in, y = relays[j]
            y.backward(g_x)
            g_x = hop(x_in.grad, TAG_ACT_DOWN + j, i)
        acts.backward(g_x)
        return loss_i.detach()

    with torch.enable_grad():
        for i in sel_rows:
            pcl[i] = client_pass(i)
    del server_b, edges_b, hop_u
    loss = torch.sum(coef * pcl)
    hop_bytes = [rows * cfg.d_model * torch_dtype(cfg.dtype).itemsize
                 ] * (num_edges + 1)

    if train_cfg.grad_clip:
        clip_by_global_norm(g_client, train_cfg.grad_clip)
        clip_by_global_norm(g_server, train_cfg.grad_clip)
        for g in g_edges:
            clip_by_global_norm(g, train_cfg.grad_clip)
    if plan is not None:
        # adversarial corruption models the *sent* update, so it follows
        # the shared global-norm clip
        sim_faults.corrupt_client_grads(
            plan, g_client, noise=fd.noise,
            generator=_stream(state, TAG_NOISE, None, dev))

    # ---- optimizer (masked for unselected clients), in place ------------
    # the update transforms and the compressed upload read the pre-step
    # rows, which the in-place step overwrites: keep the ones they read
    saved = _keep_rows(plan, sel_rows, comp_cfg.enabled)
    old_rows = ([leaf[saved] for leaf in
                 tree_leaves(state.client_stack)] if saved else [])
    _, opt_update = make_optimizer(train_cfg.optimizer)
    lr = schedule(int(state.round_index))
    wd = train_cfg.weight_decay
    opt_update(state.client_stack, g_client, state.opt_client, lr=lr,
               weight_decay=wd, mask=mask)
    # an all-dropped round leaves the shared stages and their optimizer
    # state untouched (JAX steps them and keeps the old values)
    if plan is None or sel_rows:
        opt_update(state.server_params, g_server, state.opt_server, lr=lr,
                   weight_decay=wd)
        for ep, ge, oe in zip(state.edge_stages, g_edges, state.opt_edge):
            opt_update(ep, ge, oe, lr=lr, weight_decay=wd)
    del g_client, g_server, g_edges
    if plan is not None:
        # straggler / slow-hop progress and Byzantine amplification on the
        # post-optimizer update, then the adaptive clients' crafted stage
        sim_faults.scale_client_updates(plan, state.client_stack, old_rows,
                                        rows=saved)
        sim_faults.adaptive_scale_updates(plan, state.client_stack,
                                          old_rows, mask, rows=saved)

    # ---- validation on the server-held set -> importance ----------------
    if val_batch is not None:
        vt, vl = val_batch["tokens"], val_batch["labels"]
        val_losses = torch.zeros((n,), dtype=torch.float32, device=mask.device)
        with torch.no_grad():
            for i in range(n):
                a = tf.client_forward(_row(state.client_stack, i), cfg, vt,
                                      impl=impl, remat=False)
                for j, ep in enumerate(state.edge_stages):
                    a = tf.stage_forward(ep, cfg, a, j + 1, impl=impl,
                                         remat=False)
                val_losses[i], _ = tf.server_loss(state.server_params, cfg, a,
                                                  vl, impl=impl, remat=False)
        importance = wssl.compute_importance(val_losses, wssl_cfg,
                                             prev=state.importance)
    else:
        val_losses = torch.zeros((n,), dtype=torch.float32, device=mask.device)
        importance = state.importance.clone()

    # ---- update-path compression, then Algorithm 2 step 5: aggregation
    # through the registry + sync (dropout can empty the selection: `safe`
    # falls back to a no-op sync) ----------------------------------------
    with torch.no_grad():
        if comp_cfg.enabled:
            _compress_update(state, old_rows, saved, sel_rows, mask,
                             comp_cfg, comp_p, draw)
        del old_rows
        global_client = aggregation.aggregate_clients(
            state.client_stack, importance, mask, wssl_cfg,
            safe=plan is not None, params=agg_p)
        wssl.broadcast_global(state.client_stack, global_client)
        del global_client
        state.importance.copy_(importance)
    state.round_index += 1

    # ---- communication accounting --------------------------------------
    sel = mask.sum()
    f32 = lambda v: torch.tensor(v, dtype=torch.float32, device=sel.device)
    bytes_per_hop = sel * f32(hop_bytes)
    stage_bytes = f32(tree_bytes(state.client_stack) // n)
    update_raw = sel * stage_bytes
    if comp_cfg.enabled:
        comp_stage = f32(compress.compressed_stage_bytes(
            state.client_stack, comp_cfg, comp_p))
        update_comp = sel * comp_stage
        # sync = compressed upload from the selected + raw broadcast to all
        bytes_sync = sel * comp_stage + n * stage_bytes
    else:
        update_comp = update_raw
        bytes_sync = sync_round_bytes(sel, n, stage_bytes)
    if compress_acts:
        wire = compress.activation_wire_bytes(rows, cfg.d_model, comp_cfg,
                                              comp_p)
        act_raw = sel * 2.0 * f32(hop_bytes).sum()
        act_comp = sel * 2.0 * f32(wire * (num_edges + 1))
    else:
        act_raw = act_comp = f32(0.0)
    metrics = RoundMetrics(
        loss=loss, per_client_loss=pcl * mask, val_loss=val_losses,
        mask=mask, importance=importance,
        bytes_up=bytes_per_hop.sum(), bytes_down=bytes_per_hop.sum(),
        bytes_per_hop=bytes_per_hop, bytes_sync=bytes_sync,
        bytes_update_raw=update_raw, bytes_update_comp=update_comp,
        bytes_act_raw=act_raw, bytes_act_comp=act_comp)
    return state, metrics


def make_round_fn(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                  train_cfg: TrainConfig, impl: str = "dense"):
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
