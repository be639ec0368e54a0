"""Fault-aware, SLO-aware replica routing, driven by ``repro_torch.sim``
scenarios.

The PyTorch twin of ``repro/serve/router.py::FaultRoutedServer``.  R
serving replicas hold the same params and share one engine; request
``rid`` homes to replica ``rid % R``.  Each simulation tick samples a
``FaultPlan`` (``sim/faults.py``) **over the replica axis** (the
scenario's "clients" are the replicas):

* ``plan.keep[r] == 0`` — replica r is down this tick: its in-flight and
  queued requests re-route to the next alive replica, where they are
  re-prefilled and their credited tokens replayed (traffic accounted as
  sync bytes).  The replica restarts with an empty cache (paged mode: its
  block pool resets wholesale).
* ``client_latencies(plan, R)[r] > 1`` — replica r is a slow host: every
  chunk (and prefill) it serves takes proportionally longer on the
  simulated clock.

The plan is routing state, drawn on the host: tick t's uniforms come
from a generator of its own, derived from ``(seed, t)``
(``wssl.derived_generator``), so an idle tick shifts no later draw;
``run(plan_draws=...)`` injects them instead (a test feeds JAX's).

The simulated clock runs in clean decode-step units: a chunk of T tokens
costs T x slowdown; prefilling an L-token prompt costs L x
``prefill_unit`` x slowdown; a speculative round of K drafts costs K x
(draft_fraction + prefill_unit) x slowdown.  Request latency =
completion - arrival.

SLOs (``Request.deadline``, absolute sim time): the per-replica queue is
EDF; at admission the router sheds work that is provably late — even the
optimistic lower bound lands past the deadline — into
``ServeReport.rejected``.  Deadline-less requests are never shed.  With
``autoscale_max > 0`` the live replica count grows when queues build past
``scale_up_queue`` per replica and shrinks from the top when spare
replicas idle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch import sim
from repro_torch.config import Scenario
from repro_torch.core.protocol import (ServeLog, reroute_sync_bytes,
                                       serve_hop_bytes)
from repro_torch.core.wssl import derived_generator
from repro_torch.models.layers import torch_dtype
from repro_torch.serve.blocks import BlockAllocator
from repro_torch.serve.engine import BatchState
from repro_torch.serve.metrics import (acceptance_rate, latency_percentiles,
                                       slo_attainment)
from repro_torch.serve.scheduler import PendingWork, Request, SlotScheduler

Params = Any


@dataclasses.dataclass(frozen=True)
class ServeParams:
    """Serving-plane knobs."""

    replicas: int = 2
    slots: int = 4              # decode slots per replica
    chunk: int = 8              # tokens per decode call
    max_len: int = 128          # cache capacity per slot
    prefill_unit: float = 0.25  # decode-step units per prefilled token
    temperature: float = 0.0
    max_ticks: int = 100_000
    seed: int = 0
    # paged KV (0 = contiguous full residency, the classic layout)
    block_size: int = 0         # pool block size in tokens
    pool_blocks: int = 0        # pool size (0 = full residency + scratch)
    # self-drafting speculative decode (greedy only)
    speculate: bool = False
    draft_k: int = 4            # drafts per speculative round
    # SLO-aware autoscaling (0 = fixed fleet)
    autoscale_max: int = 0      # replica ceiling (>= replicas to enable)
    scale_up_queue: int = 8     # queued-per-live-replica trigger
    scale_down_idle: int = 4    # idle ticks before the top replica parks
    # large traces: drop per-request token streams, keep only metrics
    keep_outputs: bool = True


@dataclasses.dataclass
class ServeReport:
    """One scenario's serving trace."""

    scenario: str
    outputs: Dict[int, List[int]]
    latencies: Dict[int, float]
    percentiles: Dict[str, float]
    log: ServeLog
    sim_time: float
    ticks: int
    reroutes: int
    decode_compiles: int
    prefill_compiles: int
    # SLO plane
    completions: Dict[int, float] = dataclasses.field(default_factory=dict)
    rejected: Dict[int, float] = dataclasses.field(default_factory=dict)
    slo: Dict[str, float] = dataclasses.field(default_factory=dict)
    unfinished: int = 0         # still pending/active when max_ticks hit
    # speculative plane
    drafted: int = 0
    accepted: int = 0
    spec_rounds: int = 0
    draft_compiles: int = 0
    verify_compiles: int = 0
    # router internals
    arrival_scans: int = 0      # O(n + ticks), not O(n * ticks)
    peak_replicas: int = 0

    @property
    def tokens_out(self) -> int:
        return sum(len(v) for v in self.outputs.values())

    @property
    def acceptance(self) -> float:
        return acceptance_rate(self.accepted, self.drafted)


class FaultRoutedServer:
    """Serve a request set across R fault-injected replicas."""

    def __init__(self, engine, params: Params,
                 serve: ServeParams = ServeParams(),
                 scenario: Optional[Scenario] = None):
        self.engine = engine
        self.params = params
        self.p = serve
        self.scenario = scenario if scenario is not None else Scenario()

    # -- helpers -----------------------------------------------------------

    def _next_alive(self, home: int, keep, r_live: int) -> int:
        """First alive replica at or after ``home`` (mod the live count);
        if every replica is down this tick, stay home — the work waits."""
        for d in range(r_live):
            r = (home + d) % r_live
            if keep[r] > 0:
                return r
        return home

    def _mk_sched(self) -> SlotScheduler:
        p = self.p
        if not p.block_size:
            return SlotScheduler(p.slots)
        nb = p.max_len // p.block_size
        pool = p.pool_blocks or p.slots * (nb + 1)
        margin = max(p.chunk, p.draft_k if p.speculate else 0)
        return SlotScheduler(
            p.slots,
            allocator=BlockAllocator(pool, p.block_size, reserved=p.slots),
            reserve_margin=margin, max_reserve=p.max_len)

    def _new_state(self) -> BatchState:
        p = self.p
        if not p.block_size:
            return self.engine.new_batch_state(p.slots, p.max_len)
        nb = p.max_len // p.block_size
        return self.engine.new_batch_state(
            p.slots, p.max_len, block_size=p.block_size,
            pool_blocks=p.pool_blocks or p.slots * (nb + 1))

    def _plan(self, sp: sim.ScenarioParams, tick: int, r_max: int,
              plan_draws: Optional[Callable[[int], sim.FaultDraws]]
              ) -> Tuple[Any, Any]:
        """(keep, slowdown) of tick ``tick``, numpy, over the replica
        ceiling ``r_max``."""
        if plan_draws is not None:
            plan = sim.sample_fault_plan(sp, r_max, draws=plan_draws(tick))
        else:
            plan = sim.sample_fault_plan(
                sp, r_max, generator=derived_generator(self.p.seed, tick))
        return (plan.keep.numpy(),
                sim.client_latencies(plan, r_max).numpy())

    # -- main loop ---------------------------------------------------------

    def run(self, requests: Sequence[Request], *,
            preloaded: Optional[Sequence[Tuple[int, PendingWork]]] = None,
            plan_draws: Optional[Callable[[int], sim.FaultDraws]] = None
            ) -> ServeReport:
        """Serve ``requests`` (and ``preloaded`` (home, work) pairs) to the
        end or ``max_ticks``.  ``plan_draws(tick)`` supplies each tick's
        fault draws (``sim.FaultDraws(dropout=(r_max,) uniforms)``) in
        place of the derived generator."""
        p, engine = self.p, self.engine
        r_base = p.replicas
        r_max = max(r_base, p.autoscale_max)
        r_live = r_base
        peak_replicas = r_base
        scheds = [self._mk_sched() for _ in range(r_max)]
        states: List[Optional[BatchState]] = [None] * r_max
        busy_until = [0.0] * r_max
        idle_ticks = [0] * r_max
        outputs: Dict[int, List[int]] = {}
        latencies: Dict[int, float] = {}
        completions: Dict[int, float] = {}
        rejected: Dict[int, float] = {}
        deadlines: Dict[int, float] = {}
        log = ServeLog()
        itemsize = torch.empty((), dtype=torch_dtype(engine.cfg.dtype)
                               ).element_size()
        d_model = engine.cfg.d_model
        num_hops = engine.num_hops
        sp = sim.scenario_params(self.scenario)
        generator = None
        if p.temperature > 0:
            generator = torch.Generator(
                device=getattr(engine, "device", "cpu"))
            generator.manual_seed(p.seed + 1)

        # speculation only below the greedy / temperature fork, and only
        # on engines that implement it
        spec_ok = (p.speculate and p.temperature == 0.0
                   and hasattr(engine, "spec_chunk"))
        margin = max(p.chunk, p.draft_k if spec_ok else 0)
        # optimistic per-token decode cost: the shed predicate must be a
        # true lower bound, so a rejection is provably late
        cost_lb = (min(1.0, engine.draft_fraction + p.prefill_unit)
                   if spec_ok else 1.0)

        for req in requests:
            if req.prompt_len + req.max_new + margin > p.max_len:
                raise ValueError(
                    f"request {req.rid}: prompt_len ({req.prompt_len}) + "
                    f"max_new ({req.max_new}) + chunk margin ({margin}) "
                    f"exceeds max_len ({p.max_len}); global KV entries "
                    f"would wrap and silently overwrite the prompt")
            if math.isfinite(req.deadline):
                deadlines[req.rid] = req.deadline

        # arrivals walk an index into the sorted list: O(n + ticks)
        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        next_arrival = 0
        arrival_scans = 0

        if preloaded:
            for home, work in preloaded:
                scheds[home % r_live].submit(work)
                if math.isfinite(work.req.deadline):
                    deadlines[work.req.rid] = work.req.deadline

        tick = 0
        reroutes = 0
        drafted_total = accepted_total = spec_rounds = 0
        chunk_time = float(p.chunk)
        while tick < p.max_ticks and (
                next_arrival < len(pending)
                or any(s.has_work for s in scheds)):
            now = tick * chunk_time
            while True:
                arrival_scans += 1
                if (next_arrival >= len(pending)
                        or pending[next_arrival].arrival > now):
                    break
                req = pending[next_arrival]
                next_arrival += 1
                scheds[req.rid % r_live].submit(PendingWork(req))
            if not any(s.has_work for s in scheds):
                tick += 1                    # idle until the next arrival
                continue

            # -- autoscale up: queues building past the per-replica trigger
            # wake a parked replica (it fills via arrivals + re-routes) ----
            if r_max > r_base:
                queued = sum(len(s.queue) for s in scheds[:r_live])
                while (r_live < r_max
                       and queued > p.scale_up_queue * r_live):
                    idle_ticks[r_live] = 0
                    r_live += 1
                peak_replicas = max(peak_replicas, r_live)

            # the plan is sampled over the replica *ceiling*, so a fixed
            # fleet (autoscale off) draws the same faults at any ceiling
            keep, slowdown = self._plan(sp, tick, r_max, plan_draws)

            # -- replica drops: dump state, re-route (the re-prefill cost
            # is charged when the work is actually re-admitted) -----------
            for r in range(r_live):
                if keep[r] > 0 or not scheds[r].has_work:
                    if keep[r] <= 0:
                        states[r] = None     # a down replica loses its cache
                    continue
                in_flight = scheds[r].num_active
                moved = scheds[r].drain()    # also resets the block pool
                states[r] = None
                busy_until[r] = now
                for w in moved:
                    scheds[self._next_alive(w.req.rid % r_live, keep,
                                            r_live)].submit(w)
                reroutes += in_flight
                if in_flight:
                    log.record(tick, r, 0, 0, rerouted=in_flight)

            # -- alive replicas: shed provably-late work, admit at slot
            # granularity (EDF), decode a chunk or a speculative round ----
            for r in range(r_live):
                sched = scheds[r]
                if keep[r] <= 0 or now < busy_until[r] or not sched.has_work:
                    continue
                if states[r] is None:
                    states[r] = self._new_state()
                t_cost = 0.0
                admitted = 0
                prefill_tokens = 0
                bytes_sync = 0
                tokens_credited = 0
                tick_drafted = tick_accepted = 0

                def shed(work: PendingWork) -> bool:
                    if not math.isfinite(work.req.deadline):
                        return False
                    already = len(work.done) - 1 if work.done else 0
                    rem = max(work.req.max_new - 1 - already, 0)
                    lb = (now + work.req.prompt_len * p.prefill_unit
                          + rem * cost_lb)
                    return lb > work.req.deadline

                for slot, work in sched.admissions(shed=shed):
                    fresh = not work.done
                    tok0 = engine.admit(states[r], self.params,
                                        work.req.prompt, slot,
                                        blocks=work.blocks)
                    sched.activate(slot, work, tok0)
                    t_cost += work.req.prompt_len * p.prefill_unit
                    prefill_tokens += work.req.prompt_len
                    admitted += 1
                    if fresh:                # the prefill token is credited
                        tokens_credited += 1
                    else:                    # re-prefill after a drop: the
                        # prompt + credited tokens were re-shipped here
                        bytes_sync += reroute_sync_bytes(
                            work.req.prompt_len, len(work.done) - 1)
                tick_rejected = len(sched.shed)
                for w in sched.shed:
                    rejected[w.req.rid] = now
                sched.shed.clear()

                ran_chunk = False
                tokens_stepped = p.chunk
                if sched.num_active:
                    ran_chunk = True
                    replaying = any(s.replay for _, s in sched.active())
                    if spec_ok and not replaying:
                        toks, acc, cnt = engine.spec_chunk(
                            states[r], self.params, p.draft_k)
                        active_rows = [i for i, _ in sched.active()]
                        tick_drafted = p.draft_k * len(active_rows)
                        tick_accepted = int(sum(int(acc[i])
                                                for i in active_rows))
                        spec_rounds += 1
                        tokens_stepped = p.draft_k
                        t_cost += p.draft_k * (engine.draft_fraction
                                               + p.prefill_unit)
                        finished, step_credited = sched.credit_spec(
                            toks, cnt)
                    else:
                        forced, force_len = sched.force_buffers(p.chunk)
                        toks = engine.decode_chunk(states[r], self.params,
                                                   forced, force_len,
                                                   generator, p.temperature)
                        t_cost += chunk_time
                        finished, step_credited = sched.credit_chunk(toks)
                    end = now + t_cost * float(slowdown[r])
                    tokens_credited += step_credited
                    drafted_total += tick_drafted
                    accepted_total += tick_accepted
                    for slot, active in finished:
                        rid = active.req.rid
                        if p.keep_outputs:
                            outputs[rid] = list(active.done)
                        completions[rid] = end
                        latencies[rid] = end - active.req.arrival
                        if (states[r] is not None
                                and states[r].table is not None):
                            # point the released row back at its scratch
                            # block before the allocator reuses the blocks
                            states[r].table[slot, :] = slot
                            states[r].mark_table_dirty()
                        sched.release(slot)
                    busy_until[r] = end
                # every decode step ships the whole batch across each hop
                # (empty slots included: that is the physical crossing);
                # admissions re-cross their prompt activations too.  A
                # chunk that ran crossed the wire even when every slot
                # finished by replay and credited nothing
                hop_tokens = (p.slots * tokens_stepped if ran_chunk
                              else 0) + prefill_tokens
                log.record(tick, r, admitted, tokens_credited,
                           bytes_per_hop=serve_hop_bytes(
                               hop_tokens, d_model, itemsize, num_hops),
                           bytes_sync=bytes_sync, drafted=tick_drafted,
                           accepted=tick_accepted, rejected=tick_rejected)

            # -- autoscale down: park the top replica once it has idled ---
            for r in range(r_live):
                idle_ticks[r] = 0 if scheds[r].has_work else idle_ticks[r] + 1
            while (r_live > r_base and not scheds[r_live - 1].has_work
                   and idle_ticks[r_live - 1] >= p.scale_down_idle):
                states[r_live - 1] = None
                r_live -= 1
            tick += 1

        # a max_ticks exit must not look like a clean drain: report what
        # was left
        unfinished = (len(pending) - next_arrival) + sum(
            len(s.queue) + s.num_active for s in scheds)

        return ServeReport(
            scenario=self.scenario.name,
            outputs=outputs,
            latencies=latencies,
            percentiles=latency_percentiles(list(latencies.values())),
            log=log,
            sim_time=tick * chunk_time,
            ticks=tick,
            reroutes=reroutes,
            decode_compiles=engine.decode_compiles,
            prefill_compiles=engine.prefill_compiles,
            completions=completions,
            rejected=rejected,
            slo=slo_attainment(deadlines, completions),
            unfinished=unfinished,
            drafted=drafted_total,
            accepted=accepted_total,
            spec_rounds=spec_rounds,
            draft_compiles=getattr(engine, "draft_compiles", 0),
            verify_compiles=getattr(engine, "verify_compiles", 0),
            arrival_scans=arrival_scans,
            peak_replicas=peak_replicas,
        )
