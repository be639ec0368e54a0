"""Bounded-staleness asynchronous WSSL rounds.

The twin of the flat round of ``repro/core/async_round.py``.  The
synchronous ``core/round.py::wssl_round`` is a barrier; this round has a
**deadline** measured in simulated client latencies
(``sim.faults.client_latencies``: a clean client finishes at t = 1.0, a
4x straggler at t = 4.0).  Per round:

* clients that finish by the deadline contribute as in the sync round;
* a client past it is **buffered**: its post-optimizer update (delta =
  theta_new - theta_old) is parked in :class:`AsyncState` and lands
  ``d = ceil(latency / deadline) - 1`` rounds later, applied to the
  then-current global stage at the staleness discount
  ``wssl.staleness_weights``, fused into the aggregation coefficients;
* an update whose staleness would reach ``max_staleness``, or that would
  overflow ``buffer_size``, is **evicted**: the client contributes
  nothing and is resynced (``bytes_resync``, inside ``bytes_sync``).

At ``deadline = inf`` every async step is an exact identity and the round
equals the port's ``wssl_round`` bit for bit.  With a finite deadline the
latency is *when* an update lands, not how much of it: the stragglers'
partial-progress scale becomes one (Byzantine amplification and the
adaptive attack still apply).

What differs from the JAX round, and why:

* The state and the :class:`AsyncState` are updated **in place**, like
  the sync port's: ``pending`` / ``staleness`` are int32 (N,) tensors and
  ``buffer`` mirrors the client stack in the param dtype.  The in-place
  step overwrites the pre-step rows, so the round keeps those it reads:
  the sync round's, and every admitted client's (its parked delta is
  ``new - old``) and arriving client's (it lands as ``old + buf``).  The
  parked delta is taken right after the step and the update transforms,
  before delivery and compression rewrite rows.
* The round is the sync round's pieces (``core/round.py``) with the
  deadline machinery between them, as the JAX async round imports the
  sync round's.  It draws nothing of its own: ``gumbel=``,
  ``comp_uniform=`` and ``fault_draws=`` inject the draws as for
  ``wssl_round``.
* :class:`AsyncParams` are fp32 0-d tensors, as JAX's traced scalars; the
  round moves them onto the state's device, so ``lat / deadline`` is a
  true fp32 division there (a CUDA division by a host scalar multiplies
  by its reciprocal, and ``ceil`` turns a one-ulp miss at an integer into
  a whole round of delay).
* Which clients run their split forward and backward is the sync
  round's rule (``core/round.py::_client_grads``): the fresh workers, or
  every client where an MoE layer sits past the client stage (its aux is
  a mean over all N in JAX too).
* The shared stages are not stepped at all in a round without a fresh
  participant (JAX steps them and keeps the old values); that guard is
  unconditional here, as in JAX: a tight deadline can empty a round
  without any fault plan.

Client-axis sharding (:func:`make_sharded_async_round_fn`) runs the
round once a shard with a ``core/round.py::ShardCtx``, as the sync round
does: the buffer rides the client axis with the stack, while ``pending``,
``staleness`` and every admission-control vector are whole on every rank
(computed from the same generator and latencies), so who is on time,
parked, arriving or evicted is the flat round's on every shard.  There is
no one-executable invariant to hold: nothing here is compiled per shape.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import torch
from torch.utils._pytree import tree_map

from repro_torch import compress, sharding
from repro_torch.config import (AsyncRoundsConfig, ModelConfig, TrainConfig,
                                WSSLConfig)
from repro_torch.core import aggregation, wssl
from repro_torch.core import round as rnd
from repro_torch.core.round import (RoundMetrics, ShardCtx, Uniform,
                                    WSSLState, _gather, _loc, _local_plan)
from repro_torch.optim.schedule import make_schedule
from repro_torch.sim import faults as sim_faults
from repro_torch.tree import tree_leaves

Params = Any


class AsyncParams(NamedTuple):
    """The runtime scalars of an :class:`AsyncRoundsConfig`, fp32 0-d
    tensors (JAX's traced scalars); only the weighting *kind* is read
    from the config."""

    deadline: torch.Tensor         # round deadline in latency units; inf = sync
    max_staleness: torch.Tensor    # evict + resync at / above it
    buffer_size: torch.Tensor      # max concurrently parked late updates
    staleness_alpha: torch.Tensor  # decay rate of the staleness weighting


def async_params(cfg: AsyncRoundsConfig, num_clients: int) -> AsyncParams:
    """Lower the config block to fp32 0-d tensors on the host (the round
    moves them onto the state's device)."""
    f = lambda v: torch.tensor(float(v), dtype=torch.float32)
    size = num_clients if cfg.buffer_size is None else cfg.buffer_size
    return AsyncParams(deadline=f(cfg.deadline),
                       max_staleness=f(cfg.max_staleness),
                       buffer_size=f(size),
                       staleness_alpha=f(cfg.staleness_alpha))


@dataclass
class AsyncState:
    """Per-client staleness bookkeeping and the stale-update buffer.

    ``pending[i] == 0``: idle (eligible for fresh work); ``pending[i] ==
    k > 0``: a parked update lands k rounds from now (1: this round, and
    the slot frees after it).  ``staleness[i]`` is the age the parked
    update will have when it lands.  ``buffer`` mirrors the client stack
    and holds the parked post-optimizer deltas; a slot is zero whenever
    ``pending == 0``."""

    pending: torch.Tensor       # (N,) int32
    staleness: torch.Tensor     # (N,) int32
    buffer: Params              # client-stack-shaped deltas, leaves (N, ...)


class AsyncRoundMetrics(NamedTuple):
    base: RoundMetrics              # the sync metrics (mask = fresh work)
    on_time: torch.Tensor           # fresh clients that beat the deadline
    buffered: torch.Tensor          # late clients newly parked
    arrived: torch.Tensor           # parked updates applied this round
    evicted: torch.Tensor           # too-stale / overflow clients (resynced)
    mean_staleness: torch.Tensor    # mean staleness of this round's arrivals
    bytes_resync: torch.Tensor      # eviction resync traffic (in bytes_sync)


def init_async_state(state: WSSLState) -> AsyncState:
    """An empty buffer: every client idle, every slot zero, on the state's
    device.  On one shard's state (``sharding.shard_state``) the buffer
    holds its rows and the counters stay whole (N,), as the importance."""
    n = state.importance.shape[0]
    dev = state.importance.device
    return AsyncState(
        pending=torch.zeros((n,), dtype=torch.int32, device=dev),
        staleness=torch.zeros((n,), dtype=torch.int32, device=dev),
        buffer=tree_map(torch.zeros_like, state.client_stack))


def _rows(vec: torch.Tensor) -> List[int]:
    return torch.nonzero(vec > 0).flatten().tolist()


def _shard_rows(vec: torch.Tensor, ctx: Optional[ShardCtx],
                n_loc: int) -> List[int]:
    """This shard's rows (local indices) where the whole (N,) ``vec`` is
    positive."""
    return _rows(_loc(vec, ctx, n_loc))


def async_wssl_round(state: WSSLState, astate: AsyncState,
                     batch: Dict[str, torch.Tensor],
                     val_batch: Optional[Dict[str, torch.Tensor]] = None,
                     scenario=None, async_p: Optional[AsyncParams] = None,
                     agg_p=None,
                     comp_p: Optional[compress.CompressionParams] = None, *,
                     model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                     train_cfg: TrainConfig, schedule, impl: str = "chunked",
                     shard_ctx: Optional[ShardCtx] = None,
                     gumbel: Optional[torch.Tensor] = None,
                     comp_uniform: Optional[Uniform] = None,
                     fault_draws: Optional[sim_faults.FaultDraws] = None
                     ) -> Tuple[WSSLState, AsyncState, AsyncRoundMetrics]:
    """One bounded-staleness round, in place; returns ``(state, astate,
    metrics)``, the same objects it was given.  ``batch``, ``val_batch``,
    ``scenario``, ``agg_p``, ``comp_p``, ``shard_ctx`` and the injected
    draws as for ``wssl_round``; ``async_p`` overrides the config's
    runtime scalars (a :class:`DeadlineController` retunes the deadline
    with it).  With a ``shard_ctx`` the buffer holds this shard's rows and
    ``pending`` / ``staleness`` stay whole."""
    ctx = shard_ctx
    rnd._check_ported(state, batch, ctx, train_cfg, wssl_cfg, impl)
    n = wssl_cfg.num_clients
    n_loc = n // ctx.num_shards if ctx is not None else n
    acfg = wssl_cfg.async_rounds
    comp_cfg = wssl_cfg.compression
    if comp_cfg.enabled and comp_p is None:
        comp_p = compress.compression_params(comp_cfg)
    dev = state.importance.device
    ap = async_params(acfg, n) if async_p is None else async_p
    ap = AsyncParams(*(torch.as_tensor(v, dtype=torch.float32).to(dev)
                       for v in ap))
    draw = rnd._draws(state, comp_uniform, dev, ctx)
    fd = fault_draws if fault_draws is not None else sim_faults.FaultDraws()
    pending, staleness = astate.pending, astate.staleness

    plan = rnd._fault_plan(state, scenario, wssl_cfg, fd, dev)

    # ---- Algorithm 1: selection.  select_staleness_beta > 0 folds a
    # busy / slow penalty into the logits, plan or none: in-flight clients
    # and high-latency clients lose priority at the draw ------------------
    penalty = None
    if wssl_cfg.select_staleness_beta:
        penalty = (sim_faults.client_latencies(plan, n, device=dev) - 1.0
                   + pending.float())
    mask = wssl.participation_mask(state.importance, wssl_cfg,
                                   state.round_index, generator=state.rng,
                                   gumbel=gumbel, penalty=penalty)
    if plan is not None:
        mask = mask * plan.keep

    # ---- deadline admission control: dropout, then busy clients, then
    # on time / late, eviction at max_staleness, buffer overflow in client
    # order against the slots still held ----------------------------------
    lat = sim_faults.client_latencies(plan, n, device=dev)
    delay = torch.clamp(torch.ceil(lat / ap.deadline) - 1.0, min=0.0)
    arriving = (pending == 1).float()
    idle = (pending == 0).float()
    mask = mask * idle
    on_time = mask * (delay == 0).float()
    late = mask * (delay > 0).float()
    evict_late = late * (delay >= ap.max_staleness).float()
    admit = late - evict_late
    slots = (pending > 1).sum().float()
    order = torch.cumsum(admit, 0) - admit      # admitted strictly before i
    overflow = admit * ((slots + order) >= ap.buffer_size).float()
    admit = admit - overflow
    evicted = evict_late + overflow
    part = on_time + admit                      # fresh work this round
    agg_w = wssl.aggregation_weights(state.importance, part, wssl_cfg)
    # the shard's views of the whole (N,) vectors above (the vectors
    # themselves when flat); every rank agrees on who is on time, parked,
    # arriving or evicted
    plan_loc = _local_plan(plan, ctx, n_loc)
    part_loc = _loc(part, ctx, n_loc)
    run_rows = _shard_rows(part, ctx, n_loc)
    admit_rows = _shard_rows(admit, ctx, n_loc)
    arriving_rows = _shard_rows(arriving, ctx, n_loc)

    # ---- split forward / chained backward, clip, corruption -------------
    labels = batch["labels"]
    if plan is not None:
        labels = sim_faults.corrupt_labels(plan_loc, labels,
                                           model_cfg.vocab_size)
    g = rnd._client_grads(state, batch["tokens"], labels,
                          _loc(agg_w, ctx, n_loc) * part_loc, run_rows,
                          model_cfg=model_cfg, train_cfg=train_cfg,
                          comp_cfg=comp_cfg, comp_p=comp_p, draw=draw,
                          impl=impl, embeds=batch.get("embeds"), ctx=ctx)
    rnd._clip_and_corrupt(state, g, plan_loc, train_cfg, fd, dev, ctx)

    # ---- optimizer masked to the fresh workers, in place ----------------
    # under a finite deadline the latency is when the update lands: the
    # straggler partial-progress scale is one
    plan_u = plan_loc
    if plan is not None and math.isfinite(float(ap.deadline)):
        plan_u = plan_loc._replace(
            grad_scale=torch.ones_like(plan_loc.grad_scale))
    saved = sorted(set(rnd._keep_rows(plan_u, run_rows, comp_cfg.enabled))
                   | set(admit_rows) | set(arriving_rows))
    pos = {i: j for j, i in enumerate(saved)}
    old_rows = rnd._saved_rows(state, saved)
    rnd._step(state, g, part_loc, train_cfg, schedule,
              step_shared=bool(_rows(part)))
    if plan_u is not None:
        rnd._transform_updates(plan_u, state, old_rows, saved, part_loc, ctx)
    buf_leaves = tree_leaves(astate.buffer)
    with torch.no_grad():
        if admit_rows:
            # the parked delta: the update the late client computed,
            # before delivery, compression and the sync rewrite its row
            at = [pos[i] for i in admit_rows]
            for leaf, old, buf in zip(tree_leaves(state.client_stack),
                                      old_rows, buf_leaves):
                buf[admit_rows] = (leaf[admit_rows].float()
                                   - old[at].float()).to(buf.dtype)
    g = g._replace(client=(), server=(), edges=[])   # free the gradients

    # ---- validation on the server-held set -> importance ----------------
    val_losses, importance = rnd._validate(state, val_batch,
                                           model_cfg=model_cfg,
                                           wssl_cfg=wssl_cfg, impl=impl,
                                           ctx=ctx)

    # ---- stale-update delivery: an arriving client applies its parked
    # delta to the current global stage, at its staleness discount --------
    contrib = wssl.async_contribution(
        on_time, arriving, staleness, ap.max_staleness,
        kind=acfg.staleness_weighting, alpha=ap.staleness_alpha)
    pend = _loc(pending, ctx, n_loc).tolist()
    admitted = set(admit_rows)
    cleared = [i for i in range(n_loc)
               if not (pend[i] > 1 or i in admitted)]
    with torch.no_grad():
        if arriving_rows:
            at = [pos[i] for i in arriving_rows]
            for leaf, old, buf in zip(tree_leaves(state.client_stack),
                                      old_rows, buf_leaves):
                leaf[arriving_rows] = (old[at].float()
                                       + buf[arriving_rows].float()
                                       ).to(leaf.dtype)
        if cleared:
            for buf in buf_leaves:
                buf[cleared] = 0

        # ---- compression at delivery: a stale arrival's parked delta
        # crosses the wire the round it lands ----------------------------
        if comp_cfg.enabled:
            rnd._compress_update(state, old_rows, saved,
                                 _shard_rows(contrib, ctx, n_loc),
                                 _loc(contrib, ctx, n_loc), comp_cfg, comp_p,
                                 draw)
        del old_rows
        # weighted rules fuse the fractional discount into their
        # coefficients; robust rules binarize membership
        if ctx is None:
            global_client = aggregation.aggregate_clients(
                state.client_stack, importance, contrib, wssl_cfg, safe=True,
                params=agg_p)
        else:
            global_client = aggregation.shard_aggregate_clients(
                state.client_stack, importance, contrib, wssl_cfg,
                group=ctx.group, shard_index=ctx.index,
                num_shards=ctx.num_shards, safe=True, params=agg_p)
        wssl.broadcast_global(state.client_stack, global_client)
        del global_client
        state.importance.copy_(importance)
    state.round_index += 1

    # ---- buffer clock and accounting ------------------------------------
    d_i32 = delay.to(torch.int32)
    n_arrived = arriving.sum()
    n_evicted = evicted.sum()
    mean_staleness = ((arriving * staleness).sum()
                      / torch.clamp(n_arrived, min=1.0))
    new_pending = torch.where(admit > 0, d_i32,
                              torch.clamp(pending - 1, min=0))
    new_staleness = torch.where(admit > 0, d_i32,
                                torch.where(pending > 1, staleness,
                                            torch.zeros_like(staleness)))
    pending.copy_(new_pending)
    staleness.copy_(new_staleness)
    sel = part.sum()
    bytes_resync = n_evicted * torch.tensor(
        float(rnd.client_stage_bytes(state)), dtype=torch.float32,
        device=dev)
    metrics = RoundMetrics(
        loss=g.loss, per_client_loss=_gather(g.pcl, ctx) * part,
        val_loss=val_losses, mask=part, importance=importance,
        **rnd._byte_metrics(state, g, sel, on_time.sum() + n_arrived,
                            model_cfg=model_cfg, wssl_cfg=wssl_cfg,
                            comp_cfg=comp_cfg, comp_p=comp_p,
                            resync=bytes_resync, ctx=ctx))
    return state, astate, AsyncRoundMetrics(
        base=metrics, on_time=on_time.sum(), buffered=admit.sum(),
        arrived=n_arrived, evicted=n_evicted, mean_staleness=mean_staleness,
        bytes_resync=bytes_resync)


def make_async_round_fn(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                        train_cfg: TrainConfig, impl: str = "chunked"):
    """The async round with its configs and learning-rate schedule closed
    over: ``round_fn(state, astate, batch, val_batch=None, scenario=None,
    async_p=None, agg_p=None, comp_p=None, *, gumbel=None,
    comp_uniform=None, fault_draws=None)``, updating both states in place
    (the counterpart of the JAX factory's ``donate=True``)."""
    schedule = make_schedule(train_cfg.schedule, train_cfg.learning_rate,
                             train_cfg.warmup_steps, train_cfg.rounds)
    return functools.partial(async_wssl_round, model_cfg=model_cfg,
                             wssl_cfg=wssl_cfg, train_cfg=train_cfg,
                             schedule=schedule, impl=impl)


def make_sharded_async_round_fn(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                                train_cfg: TrainConfig, mesh, *,
                                impl: str = "chunked"):
    """Client-axis scale-out of :func:`async_wssl_round`, the async twin
    of ``core/round.py::make_sharded_round_fn`` (the same ``mesh``, a
    ``launch/mesh.py::ClientGroup``, and the same collectives).  The
    stale-update buffer shards with the client stack; ``pending`` and
    ``staleness`` stay whole.  Returns ``round_fn(state, astate, batch,
    val_batch=None, scenario=None, async_p=None, agg_p=None, comp_p=None,
    *, gumbel=None, comp_uniform=None, fault_draws=None)``, updating this
    rank's states in place, with ``place_state``, ``place_astate``,
    ``place_batch``, ``num_shards`` and ``mesh``."""
    n = wssl_cfg.num_clients
    if n % mesh.num_shards != 0:
        raise ValueError(f"num_clients={n} must divide evenly over "
                         f"{mesh.num_shards} client shards")
    ctx = ShardCtx(group=mesh.group, num_shards=mesh.num_shards,
                   index=mesh.index)
    schedule = make_schedule(train_cfg.schedule, train_cfg.learning_rate,
                             train_cfg.warmup_steps, train_cfg.rounds)
    round_fn = functools.partial(async_wssl_round, model_cfg=model_cfg,
                                 wssl_cfg=wssl_cfg, train_cfg=train_cfg,
                                 schedule=schedule, impl=impl, shard_ctx=ctx)
    place = lambda st: sharding.shard_state(st, ctx.num_shards, ctx.index)
    round_fn.place_state = place
    round_fn.place_astate = place
    round_fn.place_batch = lambda batch: sharding.shard_batch(
        batch, ctx.num_shards, ctx.index)
    round_fn.num_shards = ctx.num_shards
    round_fn.mesh = mesh
    return round_fn


class DeadlineController:
    """Host-side adaptive round deadline towards a target mean staleness.

    Multiplicative-exponential control on the observed mean staleness of
    each round's arrivals (``AsyncRoundMetrics.mean_staleness``):

        deadline <- clip(deadline * exp(gain * (staleness - target)),
                         min_deadline, max_deadline)

    A larger deadline admits more clients on time, so staleness above the
    target raises the deadline and staleness below it tightens it.
    Rounds with no arrivals carry no observation and leave it alone.  The
    deadline reaches the round only as ``AsyncParams.deadline``."""

    def __init__(self, target_staleness: float, deadline: float = 1.0,
                 gain: float = 0.25, min_deadline: float = 0.25,
                 max_deadline: float = 64.0):
        if target_staleness < 0:
            raise ValueError("target_staleness must be >= 0")
        if not 0 < min_deadline <= max_deadline:
            raise ValueError("need 0 < min_deadline <= max_deadline")
        self.target = float(target_staleness)
        self.gain = float(gain)
        self.min_deadline = float(min_deadline)
        self.max_deadline = float(max_deadline)
        self.deadline = float(min(max(deadline, min_deadline),
                                  max_deadline))

    def update(self, mean_staleness, arrived=1) -> float:
        """Observe one round; returns the deadline for the next round."""
        if float(arrived) > 0:
            err = float(mean_staleness) - self.target
            self.deadline = min(self.max_deadline,
                                max(self.min_deadline,
                                    self.deadline * math.exp(
                                        self.gain * err)))
        return self.deadline

    def params(self, cfg: AsyncRoundsConfig,
               num_clients: int) -> AsyncParams:
        """The current deadline's :class:`AsyncParams` (the other scalars
        from ``cfg``)."""
        return async_params(cfg, num_clients)._replace(
            deadline=torch.tensor(self.deadline, dtype=torch.float32))
