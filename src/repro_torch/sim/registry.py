"""Named scenario registry — a copy of ``repro/sim/registry.py``.

Presets cover the robustness axes of the paper's §VI claims (and the threat
models in Pasquini et al.'s split-learning inference attacks): transient
client failure, compute heterogeneity, label-flip / noisy-gradient
adversaries, Byzantine and adaptive attacks, per-hop faults, and Dirichlet
data skew.  The presets and their comments are the JAX package's; the
round reads a scenario as fp32 numbers (``faults.scenario_params``).
"""

from __future__ import annotations

from typing import Dict, List

from repro_torch.config import Scenario

SCENARIOS: Dict[str, Scenario] = {}


def register_scenario(sc: Scenario) -> Scenario:
    SCENARIOS[sc.name] = sc
    return sc


register_scenario(Scenario(name="clean"))
register_scenario(Scenario(name="dropout-30", dropout_prob=0.3))
register_scenario(Scenario(name="stragglers", straggler_fraction=0.5,
                           straggler_slowdown=4.0))
register_scenario(Scenario(name="label-flip-adversary",
                           label_flip_fraction=0.25))
register_scenario(Scenario(name="grad-noise-adversary",
                           gradient_noise_fraction=0.25,
                           gradient_noise_scale=0.5))
register_scenario(Scenario(name="sign-flip-adversary",
                           sign_flip_fraction=0.25))
# amplification must be large enough to overshoot: a mildly scaled honest
# update is just a bigger step and *helps* early training
register_scenario(Scenario(name="scaled-grad-adversary",
                           grad_scale_fraction=0.25,
                           grad_scale_factor=32.0))
# the model-poisoning variant that actually breaks the importance-weighted
# mean: a non-IID adversary amplifying 64× drags the global toward its own
# skewed distribution (an amplified *honest* update on shared data is just
# a bigger step and can even help at small scale) — krum/median discard it
# (benchmarks/robustness.py --aggregator all)
register_scenario(Scenario(name="scaled-grad-noniid",
                           grad_scale_fraction=0.25,
                           grad_scale_factor=64.0, skew_alpha=0.5))
# adaptive adversaries (ALIE-style) send mean(honest) − z·std(honest):
# inside the honest spread, so validation-loss importance never
# down-weights them — only geometry-aware aggregators (krum/median) help.
# skew_alpha gives every client its own data stream; with identical client
# data the honest updates coincide (σ = 0) and the attack is inert.
register_scenario(Scenario(name="adaptive-scaled", adaptive_fraction=0.25,
                           adaptive_margin=1.5, skew_alpha=0.5))
register_scenario(Scenario(name="adaptive-scaled-aggressive",
                           adaptive_fraction=0.25, adaptive_margin=3.0,
                           skew_alpha=0.5))
register_scenario(Scenario(name="noniid-dirichlet", skew_alpha=0.1))
# the scale-out regime (client-axis shard_map, docs/scaling.md): Dirichlet
# skew at a 1024-client population.  Same dynamic lowering as every other
# preset — only the partition (and the benchmark's default --clients) read
# the hint, so the round executable is shared with noniid-dirichlet at
# equal shapes.  Fleet-scale faults ride along: mild dropout + stragglers
# make the selection/latency path representative of a real 1k fleet.
register_scenario(Scenario(name="noniid-1k", skew_alpha=0.3,
                           dropout_prob=0.05, straggler_fraction=0.2,
                           straggler_slowdown=4.0, num_clients_hint=1024))
# multi-hop faults: no-ops on single-cut pipelines (num_hops == 0)
register_scenario(Scenario(name="edge-dropout", hop_dropout_prob=0.3))
register_scenario(Scenario(name="edge-latency", hop_latency_prob=0.5,
                           hop_latency_slowdown=4.0))
# latency-dominated populations for bounded-staleness async rounds
# (core/async_round.py): under a finite deadline the slowdown becomes an
# *arrival time* — 8× stragglers land rounds late (or are evicted), instead
# of dragging the synchronous aggregate with 1/8-progress updates.  Both
# presets run under the synchronous round too (same shapes, one executable).
register_scenario(Scenario(name="async-stragglers", straggler_fraction=0.5,
                           straggler_slowdown=8.0))
register_scenario(Scenario(name="async-byzantine", sign_flip_fraction=0.25,
                           straggler_fraction=0.25,
                           straggler_slowdown=8.0))
# serving-plane presets (repro.serve.router): the fault plan is sampled
# over the REPLICA axis — dropout_prob is a per-tick replica crash
# (requests re-routed + re-prefilled on the next alive replica), and the
# straggler knobs mark slow serving hosts whose chunks take
# straggler_slowdown× longer on the simulated clock.  Same Scenario
# dataclass, same dynamic lowering, so the training rounds accept these
# presets too (where they read as client faults).
register_scenario(Scenario(name="replica-drop", dropout_prob=0.25))
register_scenario(Scenario(name="slow-host", straggler_fraction=0.5,
                           straggler_slowdown=4.0))
# SLO / autoscaling load presets (router ``autoscale_max`` + bursty
# traces, see serve/trace.py): flash-crowd pairs burst arrivals with a
# healthy fleet whose slower half makes queueing visible, so autoscaling
# — not fault recovery — is what absorbs the load; degraded-fleet layers
# replica crashes ON TOP of slow hosts, the worst case for deadline
# attainment (shed + reroute + inflate all at once).
register_scenario(Scenario(name="flash-crowd", straggler_fraction=0.25,
                           straggler_slowdown=2.0))
register_scenario(Scenario(name="degraded-fleet", dropout_prob=0.15,
                           straggler_fraction=0.5,
                           straggler_slowdown=4.0))


def get_scenario(name: str) -> Scenario:
    if name not in SCENARIOS:
        raise KeyError(f"unknown scenario {name!r}; known: {sorted(SCENARIOS)}")
    return SCENARIOS[name]


def list_scenarios() -> List[str]:
    return sorted(SCENARIOS)
