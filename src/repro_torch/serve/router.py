"""Replica routing for serving: continuous batching across R replicas.

The PyTorch twin of ``repro/serve/router.py::FaultRoutedServer``.  R
replicas hold the same params and share one engine; request ``rid`` homes
to replica ``rid % R``.  The simulated clock runs in clean decode-step
units: a chunk of T tokens costs T, prefilling an L-token prompt costs
L x ``prefill_unit``; request latency = completion - arrival.

The fault simulator (``sim/faults.py``) is not ported yet, so the router
takes only a clean scenario: every replica is kept every tick, at
slowdown 1 — exactly what the JAX router samples for ``clean``.  Any other
scenario raises.  Speculative decode stays off.  Deadline shedding and
queue-driven autoscaling are not ported yet either: a request with a
finite ``deadline`` raises, and the fleet is fixed at ``replicas``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.config import Scenario
from repro_torch.core.protocol import (ServeLog, reroute_sync_bytes,
                                       serve_hop_bytes)
from repro_torch.models.layers import torch_dtype
from repro_torch.serve.blocks import BlockAllocator
from repro_torch.serve.engine import BatchState
from repro_torch.serve.metrics import latency_percentiles
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
    # paged KV (0 = contiguous full residency, the classic layout); the
    # pool holds every slot's max_len plus one scratch block per slot
    block_size: int = 0         # pool block size in tokens


@dataclasses.dataclass
class ServeReport:
    """One run's serving trace."""

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
    completions: Dict[int, float] = dataclasses.field(default_factory=dict)
    unfinished: int = 0         # still pending/active when max_ticks hit
    arrival_scans: int = 0

    @property
    def tokens_out(self) -> int:
        return sum(len(v) for v in self.outputs.values())


class FaultRoutedServer:
    """Serve a request set across R replicas (clean scenario only)."""

    def __init__(self, engine, params: Params,
                 serve: ServeParams = ServeParams(),
                 scenario: Optional[Scenario] = None):
        scenario = scenario if scenario is not None else Scenario()
        if not scenario.is_clean():
            raise NotImplementedError(
                f"scenario {scenario.name!r} injects faults; the fault "
                f"simulator (sim/faults.py) is not ported yet (ROADMAP "
                f"Queue 1, item 8), so the router serves only clean ones")
        self.engine = engine
        self.params = params
        self.p = serve
        self.scenario = scenario

    def _mk_sched(self) -> SlotScheduler:
        p = self.p
        if not p.block_size:
            return SlotScheduler(p.slots)
        pool = p.slots * (p.max_len // p.block_size + 1)
        return SlotScheduler(
            p.slots,
            allocator=BlockAllocator(pool, p.block_size, reserved=p.slots),
            reserve_margin=p.chunk, max_reserve=p.max_len)

    def _new_state(self) -> BatchState:
        p = self.p
        if not p.block_size:
            return self.engine.new_batch_state(p.slots, p.max_len)
        return self.engine.new_batch_state(p.slots, p.max_len,
                                           block_size=p.block_size)

    def run(self, requests: Sequence[Request]) -> ServeReport:
        p, engine = self.p, self.engine
        replicas = p.replicas
        scheds = [self._mk_sched() for _ in range(replicas)]
        states: List[Optional[BatchState]] = [None] * replicas
        busy_until = [0.0] * replicas
        outputs: Dict[int, List[int]] = {}
        latencies: Dict[int, float] = {}
        completions: Dict[int, float] = {}
        log = ServeLog()
        itemsize = torch.empty((), dtype=torch_dtype(engine.cfg.dtype)
                               ).element_size()
        d_model = engine.cfg.d_model
        num_hops = engine.num_hops
        generator = None
        if p.temperature > 0:
            generator = torch.Generator(device=engine.device)
            generator.manual_seed(p.seed + 1)

        for req in requests:
            if req.prompt_len + req.max_new + p.chunk > p.max_len:
                raise ValueError(
                    f"request {req.rid}: prompt_len ({req.prompt_len}) + "
                    f"max_new ({req.max_new}) + chunk margin ({p.chunk}) "
                    f"exceeds max_len ({p.max_len}); global KV entries "
                    f"would wrap and silently overwrite the prompt")
            if math.isfinite(req.deadline):
                raise NotImplementedError(
                    f"request {req.rid} carries a deadline; SLO shedding "
                    f"and autoscaling are not ported yet (ROADMAP Queue 1, "
                    f"item 12.2)")

        pending = sorted(requests, key=lambda r: (r.arrival, r.rid))
        next_arrival = 0
        arrival_scans = 0
        tick = 0
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
                scheds[req.rid % replicas].submit(PendingWork(req))
            if not any(s.has_work for s in scheds):
                tick += 1                    # idle until the next arrival
                continue

            # -- every replica: admit at slot granularity, decode a chunk --
            for r in range(replicas):
                sched = scheds[r]
                if now < busy_until[r] or not sched.has_work:
                    continue
                if states[r] is None:
                    states[r] = self._new_state()
                t_cost = 0.0
                admitted = 0
                prefill_tokens = 0
                bytes_sync = 0
                tokens_credited = 0
                for slot, work in sched.admissions():
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
                    else:                    # re-admission re-ships the
                        # prompt and the tokens credited so far
                        bytes_sync += reroute_sync_bytes(
                            work.req.prompt_len, len(work.done) - 1)

                ran_chunk = False
                if sched.num_active:
                    ran_chunk = True
                    forced, force_len = sched.force_buffers(p.chunk)
                    toks = engine.decode_chunk(states[r], self.params, forced,
                                               force_len, generator,
                                               p.temperature)
                    t_cost += chunk_time
                    finished, step_credited = sched.credit_chunk(toks)
                    end = now + t_cost
                    tokens_credited += step_credited
                    for slot, active in finished:
                        rid = active.req.rid
                        outputs[rid] = list(active.done)
                        completions[rid] = end
                        latencies[rid] = end - active.req.arrival
                        if states[r].table is not None:
                            # point the released row back at its scratch
                            # block before the allocator reuses the blocks
                            states[r].table[slot, :] = slot
                            states[r].mark_table_dirty()
                        sched.release(slot)
                    busy_until[r] = end
                hop_tokens = (p.slots * p.chunk if ran_chunk else 0
                              ) + prefill_tokens
                log.record(tick, r, admitted, tokens_credited,
                           bytes_per_hop=serve_hop_bytes(
                               hop_tokens, d_model, itemsize, num_hops),
                           bytes_sync=bytes_sync)
            tick += 1

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
            reroutes=0,
            decode_compiles=engine.decode_compiles,
            prefill_compiles=engine.prefill_compiles,
            completions=completions,
            unfinished=unfinished,
            arrival_scans=arrival_scans,
        )
