"""One synchronous WSSL communication round for the transformer stack.

The twin of the flat, clean round of ``repro/core/round.py``: Algorithm 1
and 2 over a fixed client axis and an N-stage split pipeline

  importance -> Gumbel-top-k selection mask -> per-client split forward and
  chained backward (client stage per client, edge and server stages
  shared) -> global-norm clip -> masked optimizer step -> per-client
  validation -> importance EMA -> weighted aggregation and client sync.

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
* Dense stacks have no MoE aux loss, so the edge and server aux terms of
  the JAX objective are 0 here (MoE is ROADMAP Queue 1, item 11).

Not ported yet, and raising ``NotImplementedError`` naming the ROADMAP
item rather than being ignored: fault scenarios and dynamic ``AggParams``
(item 8), compression (item 9), client-axis sharding (item 13), and
``TrainConfig.client_chunk`` (item 7).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch.config import ModelConfig, TrainConfig, WSSLConfig
from repro_torch.core import aggregation, wssl
from repro_torch.core.protocol import sync_round_bytes, tree_bytes
from repro_torch.models import attention as attn
from repro_torch.models import transformer as tf
from repro_torch.models.layers import resolve_device, torch_dtype
from repro_torch.optim import clip_by_global_norm, make_optimizer
from repro_torch.optim.schedule import make_schedule

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
    ef_residual: Params = ()          # compression is not ported: always ()


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
    # sharded rounds and activation compression only (not ported): 0.0
    bytes_cross_shard: Any = 0.0
    bytes_intra_shard: Any = 0.0
    bytes_act_raw: Any = 0.0
    bytes_act_comp: Any = 0.0


def init_state(gen: torch.Generator, model_cfg: ModelConfig,
               wssl_cfg: WSSLConfig, train_cfg: TrainConfig, *,
               device="cuda") -> WSSLState:
    """N identical client stages plus the edge and server stages, from
    random params drawn with ``gen`` (a generator on ``device``) and stored
    in ``model_cfg.param_dtype``; fresh optimizer state; uniform
    importance.  The selection generator is seeded from ``gen``."""
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
        rng=torch.Generator().manual_seed(seed))


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


def _check_ported(batch, scenario, agg_p, comp_p, shard_ctx,
                  train_cfg: TrainConfig, wssl_cfg: WSSLConfig,
                  impl: str) -> None:
    """Refuse, before any state moves, what the port does not run yet."""
    if scenario is not None:
        raise NotImplementedError(
            "fault scenarios are not ported yet (ROADMAP Queue 1, item 8: "
            "sim/faults.py)")
    if agg_p is not None:
        raise NotImplementedError(
            "dynamic AggParams are not ported yet (ROADMAP Queue 1, item 8: "
            "robust aggregation)")
    if comp_p is not None:
        raise NotImplementedError(
            "compression is not ported yet (ROADMAP Queue 1, item 9: "
            "compress.py)")
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
    aggregation.resolve(wssl_cfg)


def wssl_round(state: WSSLState, batch: Dict[str, torch.Tensor],
               val_batch: Optional[Dict[str, torch.Tensor]] = None,
               scenario=None, agg_p=None, comp_p=None, *,
               model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
               train_cfg: TrainConfig, schedule, impl: str = "dense",
               shard_ctx=None, gumbel: Optional[torch.Tensor] = None
               ) -> Tuple[WSSLState, RoundMetrics]:
    """One communication round, in place.  batch: tokens/labels (N, b, S);
    val_batch: tokens/labels (bv, S), the server-held validation set (None
    skips validation and keeps the importance).  ``gumbel`` (N,) replaces
    the selection draw from ``state.rng`` (tests feed the JAX draw)."""
    _check_ported(batch, scenario, agg_p, comp_p, shard_ctx, train_cfg,
                  wssl_cfg, impl)
    cfg = model_cfg
    n = wssl_cfg.num_clients
    remat, span = train_cfg.remat, train_cfg.remat_span

    # ---- Algorithm 1: selection (round 0 selects every client) ----------
    mask = wssl.participation_mask(state.importance, wssl_cfg,
                                   state.round_index, generator=state.rng,
                                   gumbel=gumbel)
    agg_w = wssl.aggregation_weights(state.importance, mask, wssl_cfg)
    coef = agg_w * mask
    selected = mask.cpu().tolist()

    # ---- Algorithm 2 steps 2-4: split forward, chained backward ---------
    g_client = tree_map(torch.zeros_like, state.client_stack)
    g_server = tree_map(torch.zeros_like, state.server_params)
    g_edges = [tree_map(torch.zeros_like, e) for e in state.edge_stages]
    server_b = _bind(state.server_params, g_server)
    edges_b = [_bind(e, g) for e, g in zip(state.edge_stages, g_edges)]
    tokens, labels = batch["tokens"], batch["labels"]
    pcl = torch.zeros((n,), dtype=torch.float32, device=mask.device)
    with torch.enable_grad():
        for i in range(n):
            if not selected[i]:
                continue
            client_b = _bind(_row(state.client_stack, i), _row(g_client, i))
            acts = tf.client_forward(client_b, cfg, tokens[i], impl=impl,
                                     remat=remat, remat_span=span)
            x = acts.detach().requires_grad_(True)
            relays = []
            for j, edge_b in enumerate(edges_b):
                y = tf.stage_forward(edge_b, cfg, x, j + 1, impl=impl,
                                     remat=remat, remat_span=span)
                relays.append((x, y))
                x = y.detach().requires_grad_(True)
            loss_i, _ = tf.server_loss(server_b, cfg, x, labels[i],
                                       impl=impl, remat=remat,
                                       remat_span=span)
            (coef[i] * loss_i).backward()
            g_x = x.grad
            for x_in, y in reversed(relays):
                y.backward(g_x)
                g_x = x_in.grad
            acts.backward(g_x)
            pcl[i] = loss_i.detach()
    del server_b, edges_b
    loss = torch.sum(coef * pcl)
    hop_bytes = [tokens.shape[1] * tokens.shape[2] * cfg.d_model
                 * torch_dtype(cfg.dtype).itemsize] * (len(state.edge_stages)
                                                       + 1)

    if train_cfg.grad_clip:
        clip_by_global_norm(g_client, train_cfg.grad_clip)
        clip_by_global_norm(g_server, train_cfg.grad_clip)
        for g in g_edges:
            clip_by_global_norm(g, train_cfg.grad_clip)

    # ---- optimizer (masked for unselected clients), in place ------------
    _, opt_update = make_optimizer(train_cfg.optimizer)
    lr = schedule(int(state.round_index))
    wd = train_cfg.weight_decay
    opt_update(state.client_stack, g_client, state.opt_client, lr=lr,
               weight_decay=wd, mask=mask)
    opt_update(state.server_params, g_server, state.opt_server, lr=lr,
               weight_decay=wd)
    for ep, ge, oe in zip(state.edge_stages, g_edges, state.opt_edge):
        opt_update(ep, ge, oe, lr=lr, weight_decay=wd)
    del g_client, g_server, g_edges

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

    # ---- Algorithm 2 step 5: aggregation through the registry + sync ----
    with torch.no_grad():
        global_client = aggregation.aggregate_clients(
            state.client_stack, importance, mask, wssl_cfg)
        wssl.broadcast_global(state.client_stack, global_client)
        del global_client
        state.importance.copy_(importance)
    state.round_index += 1

    # ---- communication accounting --------------------------------------
    sel = mask.sum()
    bytes_per_hop = sel * torch.tensor(hop_bytes, dtype=torch.float32,
                                       device=sel.device)
    stage_bytes = torch.tensor(tree_bytes(state.client_stack) // n,
                               dtype=torch.float32, device=sel.device)
    metrics = RoundMetrics(
        loss=loss, per_client_loss=pcl * mask, val_loss=val_losses,
        mask=mask, importance=importance,
        bytes_up=bytes_per_hop.sum(), bytes_down=bytes_per_hop.sum(),
        bytes_per_hop=bytes_per_hop,
        bytes_sync=sync_round_bytes(sel, n, stage_bytes),
        bytes_update_raw=sel * stage_bytes,
        bytes_update_comp=sel * stage_bytes)
    return state, metrics


def make_round_fn(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                  train_cfg: TrainConfig, impl: str = "dense"):
    """The round with its configs and learning-rate schedule closed over:
    ``round_fn(state, batch, val_batch=None, scenario=None, agg_p=None,
    comp_p=None, *, gumbel=None)``.  The state is updated in place (the
    counterpart of the JAX factory's ``donate=True``)."""
    schedule = make_schedule(train_cfg.schedule, train_cfg.learning_rate,
                             train_cfg.warmup_steps, train_cfg.rounds)
    return functools.partial(wssl_round, model_cfg=model_cfg,
                             wssl_cfg=wssl_cfg, train_cfg=train_cfg,
                             schedule=schedule, impl=impl)
