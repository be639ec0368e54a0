"""The port's fault-aware router against ``repro.serve.FaultRoutedServer``:
replica drops, slow hosts, EDF shedding, autoscaling, speculation and a
smaller paged pool.

The plan's draws are JAX's: the torch router takes each tick's dropout
uniforms from ``plan_draws``, fed ``jax.random.uniform(fold_in(
PRNGKey(seed), tick), (r_max,))`` (``jax.random.bernoulli`` is ``uniform
< p``).  On ``SimEngine`` (a pure integer recurrence) every field of the
``ServeReport`` must then be equal, the log tick by tick.  On the real
engines (reduced Gemma-3-12B, paged, and Mamba-2-370M, fp32, JAX through
its gather path) greedy tokens are equal exactly, as in
test_torch_serve.py, and so is every field.

The last tests are torch twins of the JAX package's router tests
(``tests/test_serve.py``): the shape and outcome checks, run on the
port's own derived-generator plans.
"""

import dataclasses
import functools
import math

import jax
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
import repro.serve as jserve
import repro_torch.serve as torch_serve
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import transformer as jtf
from repro.sim import get_scenario as jax_get_scenario
from repro_torch import sim
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.serve import (DecodeEngine, FaultRoutedServer, PendingWork,
                               Request, ServeParams, SimEngine,
                               acceptance_rate, bursty_trace)
from repro_torch.sim import get_scenario

SCENARIOS = ("clean", "replica-drop", "slow-host", "flash-crowd",
             "degraded-fleet")


def jax_plan_draws(seed: int, r_max: int):
    """The JAX router's per-tick dropout uniforms, as ``plan_draws``."""
    key = jax.random.PRNGKey(seed)

    def draws(tick):
        u = jax.random.uniform(jax.random.fold_in(key, tick), (r_max,))
        return sim.FaultDraws(dropout=torch.tensor(np.asarray(u)))
    return draws


def assert_reports_equal(got, want):
    """Every ServeReport field equal; the log tick by tick."""
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "log":
            assert ([dataclasses.astuple(t) for t in a.ticks]
                    == [dataclasses.astuple(t) for t in b.ticks])
            assert a.summary() == b.summary()
        else:
            assert a == b, f.name


def run_both(sp_kw, scenario, jax_requests, torch_requests, *,
             jax_engine=None, torch_engine=None, jax_params=None,
             torch_params=None):
    jsp = jserve.ServeParams(**sp_kw)
    tsp = ServeParams(**sp_kw)
    want = jserve.FaultRoutedServer(
        jax_engine or jserve.SimEngine(), jax_params, jsp,
        scenario=jax_get_scenario(scenario)).run(jax_requests)
    got = FaultRoutedServer(
        torch_engine or SimEngine(), torch_params, tsp,
        scenario=get_scenario(scenario)).run(
        torch_requests, plan_draws=jax_plan_draws(
            tsp.seed, max(tsp.replicas, tsp.autoscale_max)))
    return got, want


# ---------------------------------------------------------------------------
# SimEngine: every field against the JAX router
# ---------------------------------------------------------------------------

# deadlines everywhere (deadline_frac 0.5, slack 1.2-8); one set with
# speculation and a pool of 30 blocks (full residency would be 36), one
# with autoscaling to 4 replicas
SIM_CASES = {
    "spec-pool": dict(replicas=2, slots=4, chunk=8, max_len=64, seed=3,
                      speculate=True, draft_k=4, block_size=8,
                      pool_blocks=30),
    "autoscale": dict(replicas=2, slots=4, chunk=8, max_len=64, seed=5,
                      autoscale_max=4, scale_up_queue=4),
}


def _trace(mod):
    return mod.bursty_trace(240, seed=9, slack=(1.2, 8.0), burst_every=60,
                            burst_size=24)


@pytest.mark.parametrize("case", sorted(SIM_CASES))
@pytest.mark.parametrize("scenario", SCENARIOS)
def test_sim_router_report_equals_jax(scenario, case):
    got, want = run_both(SIM_CASES[case], scenario, _trace(jserve),
                         _trace(torch_serve))
    assert_reports_equal(got, want)
    assert got.unfinished == 0
    assert set(got.outputs) | set(got.rejected) == set(range(240))
    if scenario in ("replica-drop", "degraded-fleet"):
        assert got.reroutes > 0
    if case == "autoscale" and scenario == "flash-crowd":
        assert got.peak_replicas > 2
    if case == "spec-pool":
        assert 0 < got.accepted < got.drafted


def test_sim_trace_equals_jax():
    """bursty_trace is a copy: prompts, lengths, arrivals, deadlines."""
    for a, b in zip(bursty_trace(300, seed=4), jserve.bursty_trace(
            300, seed=4)):
        np.testing.assert_array_equal(a.prompt, b.prompt)
        assert (a.rid, a.max_new, a.arrival) == (b.rid, b.max_new, b.arrival)
        assert a.deadline == b.deadline or (math.isinf(a.deadline)
                                            and math.isinf(b.deadline))


# ---------------------------------------------------------------------------
# real engines under replica-drop
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg = jax_reduced(jax_get_arch(arch))
    cfg = reduced(get_arch(arch))
    # one jitted init: run eagerly, every op would compile on its own
    jp = jax.jit(lambda key: jtf.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(0))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _requests(cfg, lens, gens, n=6):
    rng = np.random.default_rng(7)
    return [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               size=lens[i % len(lens)]),
                    max_new=gens[i % len(gens)]) for i in range(n)]


# Gemma-3's prompts pass its reduced window of 64, so the local rings wrap;
# a Mamba-2 prompt is at most one reduced SSD chunk (32)
REAL = {"gemma3-12b": (dict(replicas=2, slots=2, chunk=4, max_len=96,
                            seed=3, block_size=16),
                       [70, 76, 66], [6, 8, 5]),
        "mamba2-370m": (dict(replicas=2, slots=2, chunk=4, max_len=32,
                             seed=3), [8, 12, 10], [4, 6, 5])}


@pytest.fixture(scope="module", params=sorted(REAL))
def real_drop(request):
    arch = request.param
    cfg, jcfg, tp, jp = _model(arch)
    sp_kw, lens, gens = REAL[arch]
    reqs = _requests(cfg, lens, gens)
    got, want = run_both(
        sp_kw, "replica-drop", reqs, reqs,
        jax_engine=jserve.DecodeEngine(jcfg, impl="dense"),
        torch_engine=DecodeEngine(cfg, impl="kernel",
                                  paged_kernel=bool(sp_kw.get("block_size")),
                                  device="cpu"),
        jax_params=jp, torch_params=tp)
    clean = FaultRoutedServer(DecodeEngine(cfg, device="cpu"), tp,
                              ServeParams(**sp_kw)).run(reqs)
    return arch, got, want, clean


def test_real_router_under_replica_drop_equals_jax(real_drop):
    _, got, want, _ = real_drop
    assert got.reroutes > 0 and got.log.summary()["sync_MB"] > 0
    assert_reports_equal(got, want)


def test_real_replica_drop_reproduces_clean_tokens(real_drop):
    _, got, _, clean = real_drop
    assert clean.reroutes == 0 and clean.log.summary()["sync_MB"] == 0.0
    assert got.outputs == clean.outputs


# ---------------------------------------------------------------------------
# torch twins of the JAX router tests
# ---------------------------------------------------------------------------

def test_speculative_acceptance_accounting():
    reqs = bursty_trace(200, seed=5, deadline_frac=0.0)
    sp = ServeParams(replicas=2, slots=4, chunk=8, max_len=64,
                     speculate=True, draft_k=4)
    rep = FaultRoutedServer(SimEngine(), None, sp).run(reqs)
    assert rep.spec_rounds > 0
    assert 0 < rep.accepted < rep.drafted
    assert rep.acceptance == acceptance_rate(rep.accepted, rep.drafted)
    assert sum(t.drafted for t in rep.log.ticks) == rep.drafted
    assert sum(t.accepted for t in rep.log.ticks) == rep.accepted
    plain = FaultRoutedServer(
        SimEngine(), None,
        ServeParams(replicas=2, slots=4, chunk=8, max_len=64)).run(reqs)
    assert rep.outputs == plain.outputs


def test_impossible_deadline_is_shed_with_explicit_outcome():
    reqs = bursty_trace(40, seed=7, deadline_frac=0.0)
    reqs[3] = dataclasses.replace(reqs[3], deadline=reqs[3].arrival + .1)
    sp = ServeParams(replicas=2, slots=2, chunk=8, max_len=64)
    rep = FaultRoutedServer(SimEngine(), None, sp).run(reqs)
    assert 3 in rep.rejected and 3 not in rep.outputs
    assert set(rep.outputs) | set(rep.rejected) == {r.rid for r in reqs}
    assert set(rep.outputs) & set(rep.rejected) == set()
    assert rep.slo["missed"] == 1.0
    assert rep.log.summary()["rejected"] == 1.0


@pytest.mark.parametrize("preset", ["slow-host", "replica-drop",
                                    "degraded-fleet"])
def test_slo_shed_vs_serve_under_fault_presets(preset):
    reqs = bursty_trace(400, seed=9, slack=(1.2, 8.0))
    sp = ServeParams(replicas=2, slots=4, chunk=8, max_len=64)
    rep = FaultRoutedServer(SimEngine(), None, sp,
                            scenario=get_scenario(preset)).run(reqs)
    assert rep.unfinished == 0
    assert set(rep.outputs) | set(rep.rejected) == {r.rid for r in reqs}
    assert 0.0 <= rep.slo["attainment"] <= 1.0
    by_rid = {r.rid: r for r in reqs}
    assert rep.rejected
    assert all(math.isfinite(by_rid[rid].deadline) for rid in rep.rejected)


def test_autoscale_absorbs_burst():
    reqs = bursty_trace(600, seed=11, deadline_frac=0.0, burst_every=100,
                        burst_size=80)
    fixed = ServeParams(replicas=2, slots=4, chunk=8, max_len=64)
    auto = ServeParams(replicas=2, slots=4, chunk=8, max_len=64,
                       autoscale_max=6, scale_up_queue=4)
    rf = FaultRoutedServer(SimEngine(), None, fixed).run(reqs)
    ra = FaultRoutedServer(SimEngine(), None, auto).run(reqs)
    assert rf.peak_replicas == 2
    assert ra.peak_replicas > 2
    assert ra.outputs == rf.outputs
    assert ra.sim_time <= rf.sim_time


def test_arrival_admission_is_linear():
    n = 3000
    reqs = bursty_trace(n, seed=13, deadline_frac=0.0)
    sp = ServeParams(replicas=2, slots=8, chunk=8, max_len=64,
                     max_ticks=10 * n)
    rep = FaultRoutedServer(SimEngine(), None, sp).run(reqs)
    assert rep.unfinished == 0
    assert rep.arrival_scans <= n + rep.ticks + 1


def test_max_ticks_truncation_is_reported():
    reqs = bursty_trace(200, seed=15, deadline_frac=0.0)
    truncated = FaultRoutedServer(
        SimEngine(), None,
        ServeParams(replicas=1, slots=2, chunk=8, max_len=64,
                    max_ticks=3)).run(reqs)
    assert truncated.unfinished > 0
    assert truncated.ticks == 3
    assert len(truncated.outputs) + truncated.unfinished >= 200
    drained = FaultRoutedServer(
        SimEngine(), None,
        ServeParams(replicas=2, slots=8, chunk=8, max_len=64)).run(reqs)
    assert drained.unfinished == 0
    assert sorted(drained.outputs) == [r.rid for r in reqs]


def test_plan_draws_come_from_the_tick_alone():
    """Tick t's plan is drawn from a generator of its own: the same
    (seed, tick) gives the same keep vector whatever ran before it."""
    server = FaultRoutedServer(SimEngine(), None, ServeParams(seed=4),
                               scenario=get_scenario("replica-drop"))
    sp = sim.scenario_params(server.scenario)
    first = [server._plan(sp, t, 8, None)[0] for t in (5, 9, 5)]
    np.testing.assert_array_equal(first[0], first[2])
    keeps = np.stack([server._plan(sp, t, 8, None)[0] for t in range(200)])
    assert 0.15 < 1.0 - keeps.mean() < 0.35       # dropout_prob 0.25


def test_preloaded_work_replays_through_the_sim_engine():
    """Preloaded (re-routed) work is re-prefilled, replays its credited
    tokens and finishes with the clean stream."""
    req = bursty_trace(1, seed=2, prompt_len=8, gen=12)[0]
    req = dataclasses.replace(req, arrival=0.0, deadline=math.inf)
    sp = ServeParams(replicas=1, slots=1, chunk=4, max_len=64)
    clean = FaultRoutedServer(SimEngine(), None, sp).run([req])
    done = clean.outputs[req.rid]
    work = PendingWork(req, done=list(done[:5]))
    rep = FaultRoutedServer(SimEngine(), None, sp).run(
        [], preloaded=[(0, work)])
    assert rep.outputs[req.rid] == done
    assert rep.log.ticks[0].bytes_sync > 0


def test_cli_serves_a_scenario_with_speculation_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve
    launch_serve.main(["--arch", "gemma3-12b", "--reduced", "--device", "cpu",
                       "--requests", "6", "--replicas", "2", "--slots", "2",
                       "--prompt-len", "24", "--gen", "8", "--block-size", "8",
                       "--scenario", "replica-drop", "--speculate",
                       "--deadline-slack", "4", "--autoscale-max", "3"])
    out = capsys.readouterr().out
    assert "scenario=replica-drop" in out and "peak_replicas=" in out
    assert "speculative:" in out and "slo:" in out and "WARNING" not in out
    with pytest.raises(SystemExit):
        launch_serve.main(["--arch", "gemma3-12b", "--reduced", "--device",
                           "cpu", "--cuts", "2"])


def test_long_admissions_livelock_replica_drop_at_the_default_clock():
    """chip_smoke phase 19's trace (24 requests of 768-1536 prompt tokens,
    2 replicas x 8 slots) on SimEngine: at the default prefill_unit (0.25
    decode steps a token) a replica's admissions span hundreds of ticks and
    replica-drop (p 0.25 a tick) drops it first, so nothing finishes and
    work is re-routed every tick; at the card's 0.002 all of it is served."""
    reqs = bursty_trace(24, prompt_len=1536, gen=32, vocab_size=262144,
                        burst_every=8, burst_size=8, deadline_frac=0.0)
    kw = dict(replicas=2, slots=8, chunk=8, block_size=16, max_len=1584,
              max_ticks=2000)
    drop = get_scenario("replica-drop")
    stuck = FaultRoutedServer(SimEngine(), None, ServeParams(**kw),
                              scenario=drop).run(reqs)
    assert not stuck.outputs and stuck.unfinished == 24
    assert stuck.reroutes > 2000
    served = FaultRoutedServer(SimEngine(), None,
                               ServeParams(**kw, prefill_unit=0.002),
                               scenario=drop).run(reqs)
    assert served.unfinished == 0 and len(served.outputs) == 24
    assert 0 < served.reroutes < 200
