"""The port's fault simulator (``repro_torch.sim``, the ``Scenario``
config, ``core/fairness.py``) and the round and paper loop under fault
scenarios, against the JAX package on the same inputs.

* ``config.Scenario``, ``sim/registry.py`` and ``core/fairness.py`` are
  copies: every preset, cohort, flag and report equals JAX's exactly.
* ``sim/faults.py`` against ``repro.sim.faults`` run eagerly, with JAX's
  draws injected (the uniforms behind ``jax.random.bernoulli``, the
  per-leaf normals of the gradient noise): every plan vector, label,
  gradient and update **exact** (eager JAX rounds each op once, as the
  port does; the adaptive attack's honest mean and variance sum over the
  client axis in both, with the same result at these sizes).
* ``core/round.py`` under every training preset (single cut), the hop
  presets and a few client presets on a multi-hop cut (cuts (1, 2), 2 hop
  replicas), against the live jitted JAX round with the Gumbel and fault
  draws injected, 2 rounds: masks and byte counts exact; losses, val
  losses and importance within ``test_torch_round.py``'s rel 1e-5; the
  trained stages within its bands (max |diff| 2 lr per round, mean 1e-7,
  99.9th percentile 1e-6), each scaled by the largest update scale of
  the scenario: the x32 Byzantine update amplifies the rounding of its
  own step (and the +-lr of an AdamW sign) 32 times before it enters the
  mean (measured under scaled-grad-adversary: mean 4.6e-7).
* The clean scenario equals the round and the paper loop without one, bit
  for bit.
* ``core/paper_loop.py`` under scenarios (gait, 4 clients x 3 rounds x 2
  steps) against the live JAX loop, its initial params, Gumbel and noise
  draws injected: selections, drops and byte counts exact; losses,
  importance and accuracy within ``test_torch_paper.py``'s gait bands.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401
from repro import sim as jsim
from repro.config import ModelConfig as JModelConfig
from repro.config import Scenario as JScenario
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.configs import wssl_paper as jcfgs
from repro.core import fairness as jfair
from repro.core import paper_loop as jpl
from repro.core.round import init_state as jax_init_state
from repro.core.round import make_round_fn as jax_make_round_fn
from repro.data import pipeline as jpipe
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro_torch import sim
from repro_torch._bridge import state_from_jax, state_to_numpy
from repro_torch.compress import tree_leaves as jax_order_leaves
from repro_torch.config import (ModelConfig, Scenario, TrainConfig,
                                WSSLConfig)
from repro_torch.configs import wssl_paper as cfgs
from repro_torch.core import fairness
from repro_torch.core import paper_loop as pl
from repro_torch.core.round import init_state, make_round_fn
from repro_torch.data import partition, pipeline, synthetic


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


TRAINING = [name for name in jsim.list_scenarios()
            if name not in ("replica-drop", "slow-host", "flash-crowd",
                            "degraded-fleet")]


# ---------------------------------------------------------------------------
# The Scenario config, the registry, fairness
# ---------------------------------------------------------------------------


def test_registry_equals_jax():
    assert sim.list_scenarios() == jsim.list_scenarios()
    for name in sim.list_scenarios():
        assert (dataclasses.asdict(sim.get_scenario(name))
                == dataclasses.asdict(jsim.get_scenario(name))), name
        assert sim.get_scenario(name).name == name
    with pytest.raises(KeyError):
        sim.get_scenario("no-such-scenario")
    got = sim.register_scenario(Scenario(name="zz-test-only"))
    try:
        assert sim.get_scenario("zz-test-only") is got
    finally:
        del sim.SCENARIOS["zz-test-only"]


@pytest.mark.parametrize("name", sorted(jsim.SCENARIOS))
def test_scenario_helpers_equal_jax(name):
    t, j = sim.get_scenario(name), jsim.get_scenario(name)
    for n in range(1, 13):
        for f in ("label_flip_ids", "noise_ids", "sign_flip_ids",
                  "grad_scale_ids", "adaptive_ids", "adversary_ids",
                  "straggler_ids"):
            assert getattr(t, f)(n) == getattr(j, f)(n), (f, n)
    assert t.is_clean() == j.is_clean()
    assert t.to_json() == j.to_json()
    r = t.replace(dropout_prob=0.5, seed=3)
    assert dataclasses.asdict(r) == dataclasses.asdict(
        j.replace(dropout_prob=0.5, seed=3))
    assert tuple(sim.scenario_params(t)) == tuple(
        float(v) for v in jsim.scenario_params(j))


def test_fairness_equals_jax():
    rng = np.random.default_rng(3)
    for _ in range(5):
        counts = rng.integers(0, 9, size=6).astype(float)
        acc = rng.uniform(0.3, 0.9, size=6)
        imp = rng.dirichlet(np.ones(6))
        bad = sorted(rng.choice(6, size=2, replace=False).tolist())
        assert fairness.fairness_report(counts, acc) == jfair.fairness_report(
            counts, acc)
        for ids in (bad, [], list(range(6))):
            a = fairness.robustness_report(imp, ids, acc)
            b = jfair.robustness_report(imp, ids, acc)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k] == b[k] or (np.isnan(a[k]) and np.isnan(b[k])), k
    assert fairness.jain_index([0, 0]) == jfair.jain_index([0, 0]) == 1.0
    assert fairness.participation_entropy([2, 2, 2]) == pytest.approx(1.0)


# ---------------------------------------------------------------------------
# sim/faults.py against repro.sim.faults, eagerly and exactly
# ---------------------------------------------------------------------------


def _jax_plan_draws(key, n, num_hops, replicas):
    """The uniforms behind JAX's three Bernoullis, from the plan key."""
    dead = slow = None
    if num_hops:
        dead = _t(jax.random.uniform(jax.random.fold_in(key, 0xE06E),
                                     (num_hops, replicas), jnp.float32))
        slow = _t(jax.random.uniform(jax.random.fold_in(key, 0x57A1),
                                     (num_hops, replicas), jnp.float32))
    return sim.FaultDraws(
        dropout=_t(jax.random.uniform(key, (n,), jnp.float32)), dead=dead,
        slow_hop=slow)


def _jax_noise(key):
    """The gradient-noise hook of ``add_gradient_noise(grads, key, ...)``."""
    return lambda i, shape: _t(jax.random.normal(jax.random.fold_in(key, i),
                                                 shape, jnp.float32))


def _plan_equal(tp, jp):
    for f in jsim.FaultPlan._fields:
        np.testing.assert_array_equal(getattr(tp, f).numpy(),
                                      np.asarray(getattr(jp, f)), err_msg=f)


EXTRA = [JScenario(name="mixed", dropout_prob=0.5, straggler_fraction=0.3,
                   straggler_slowdown=3.0, label_flip_fraction=0.4,
                   gradient_noise_fraction=0.2, gradient_noise_scale=0.7,
                   sign_flip_fraction=0.1, grad_scale_fraction=0.3,
                   grad_scale_factor=5.0, adaptive_fraction=0.2,
                   adaptive_margin=2.0, hop_dropout_prob=0.4,
                   hop_latency_prob=0.6, hop_latency_slowdown=2.5),
         JScenario(name="all-dropped", dropout_prob=1.0,
                   hop_dropout_prob=1.0)]


@pytest.mark.parametrize("name", sorted(jsim.SCENARIOS) + ["mixed",
                                                          "all-dropped"])
def test_fault_plan_matches_jax(name):
    jsc = (jsim.get_scenario(name) if name in jsim.SCENARIOS
           else [s for s in EXTRA if s.name == name][0])
    tsc = Scenario(**dataclasses.asdict(jsc))
    for n, hops, reps in ((4, 0, 1), (8, 1, 2), (7, 2, 3), (10, 3, 1)):
        for seed in range(3):
            key = jax.random.PRNGKey(100 * n + seed)
            jp = jsim.sample_fault_plan(key, jsim.scenario_params(jsc), n,
                                        num_hops=hops, hop_replicas=reps)
            tp = sim.sample_fault_plan(
                sim.scenario_params(tsc), n, num_hops=hops,
                hop_replicas=reps, draws=_jax_plan_draws(key, n, hops, reps))
            _plan_equal(tp, jp)
            np.testing.assert_array_equal(
                sim.client_latencies(tp, n).numpy(),
                np.asarray(jsim.client_latencies(jp, n)))
    np.testing.assert_array_equal(sim.client_latencies(None, 3).numpy(),
                                  np.ones(3, np.float32))


def test_fault_plan_draws_from_its_generator():
    """Without injected draws the plan draws from the generator it is
    given: the same seed gives the same plan, and a dropout of 1 drops
    everyone."""
    sp = sim.scenario_params(Scenario(dropout_prob=0.5, hop_dropout_prob=0.5))
    plan = lambda s: sim.sample_fault_plan(
        sp, 16, num_hops=2, hop_replicas=2,
        generator=torch.Generator().manual_seed(s))
    assert torch.equal(plan(1).keep, plan(1).keep)
    assert not torch.equal(plan(1).keep, plan(2).keep)
    full = sim.sample_fault_plan(sim.scenario_params(Scenario(
        dropout_prob=1.0)), 5, generator=torch.Generator().manual_seed(0))
    assert full.keep.sum() == 0
    with pytest.raises(ValueError, match="generator"):
        sim.sample_fault_plan(sp, 4)


def _plan_pair(jsc, n, seed=0):
    key = jax.random.PRNGKey(seed)
    jp = jsim.sample_fault_plan(key, jsim.scenario_params(jsc), n)
    tp = sim.sample_fault_plan(sim.scenario_params(Scenario(
        **dataclasses.asdict(jsc))), n, draws=_jax_plan_draws(key, n, 0, 1))
    return tp, jp


def test_labels_match_jax():
    rng = np.random.default_rng(0)
    for frac, classes in ((0.25, 64), (0.5, 2), (0.75, 10), (0.0, 7)):
        tp, jp = _plan_pair(JScenario(label_flip_fraction=frac), 8)
        labels = rng.integers(0, classes, size=(8, 3, 5)).astype(np.int32)
        got = sim.corrupt_labels(tp, _t(labels), classes)
        want = jsim.corrupt_labels(jp, jnp.asarray(labels), classes)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert sim.label_shift(1) == jsim.label_shift(1) == 1
    assert sim.label_shift(10) == jsim.label_shift(10) == 5


def _grads(rng, n):
    return {"w": rng.normal(size=(n, 5, 3)).astype(np.float32),
            "b": {"z": rng.normal(size=(n, 4)).astype(np.float32),
                  "a": rng.normal(size=(n,)).astype(np.float32)}}


def _torch_tree(tree):
    return jax.tree.map(lambda a: torch.tensor(np.array(a)), tree)


def _tree_equal(got, want):
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_gradient_noise_and_sign_flip_match_jax():
    rng = np.random.default_rng(1)
    jsc = JScenario(sign_flip_fraction=0.25, gradient_noise_fraction=0.5,
                    gradient_noise_scale=0.3)
    tp, jp = _plan_pair(jsc, 8)
    g = _grads(rng, 8)
    key = jax.random.PRNGKey(7)
    want = jsim.corrupt_client_grads(jp, jax.tree.map(jnp.asarray, g), key)
    got = sim.corrupt_client_grads(tp, _torch_tree(g), noise=_jax_noise(key))
    _tree_equal(jax.tree.map(lambda a: a.numpy(), got), want)
    # the scalar noise of the paper loop's split step
    want = jsim.add_gradient_noise(jax.tree.map(jnp.asarray, g), key, 0.5)
    got = sim.add_gradient_noise(_torch_tree(g), 0.5, noise=_jax_noise(key))
    _tree_equal(jax.tree.map(lambda a: a.numpy(), got), want)
    want = jsim.apply_sign_flip(jp, jax.tree.map(jnp.asarray, g))
    got = sim.apply_sign_flip(tp, _torch_tree(g))
    _tree_equal(jax.tree.map(lambda a: a.numpy(), got), want)


def test_clean_transforms_are_identities():
    rng = np.random.default_rng(2)
    tp, _ = _plan_pair(JScenario(), 6)
    g = _torch_tree(_grads(rng, 6))
    before = [x.clone() for x in tree_leaves(g)]
    sim.corrupt_client_grads(tp, g, generator=torch.Generator())
    old = _torch_tree(_grads(rng, 6))
    sim.scale_client_updates(tp, g, old)
    sim.adaptive_scale_updates(tp, g, old, torch.ones(6))
    labels = torch.arange(12).reshape(6, 2)
    assert sim.corrupt_labels(tp, labels, 12) is labels
    for a, b in zip(before, tree_leaves(g)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_update_transforms_match_jax(dtype):
    rng = np.random.default_rng(4)
    jsc = JScenario(straggler_fraction=0.25, straggler_slowdown=4.0,
                    grad_scale_fraction=0.25, grad_scale_factor=32.0,
                    adaptive_fraction=0.25, adaptive_margin=1.5,
                    dropout_prob=0.3)
    tp, jp = _plan_pair(jsc, 8, seed=5)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    old = jax.tree.map(lambda a: jnp.asarray(a, jd), _grads(rng, 8))
    new = jax.tree.map(lambda a, d: (a.astype(jnp.float32) + d).astype(jd),
                       old, jax.tree.map(lambda a: 0.01 * jnp.asarray(a),
                                         _grads(rng, 8)))
    mask = (rng.random(8) > 0.3).astype(np.float32) * np.asarray(jp.keep)
    want = jsim.scale_client_updates(jp, new, old)
    want = jsim.adaptive_scale_updates(jp, want, old, jnp.asarray(mask))
    conv = lambda tree: jax.tree.map(
        lambda a: torch.tensor(np.asarray(a.astype(jnp.float32))).to(
            torch.bfloat16 if dtype == "bfloat16" else torch.float32), tree)
    got = conv(new)
    sim.scale_client_updates(tp, got, conv(old))
    sim.adaptive_scale_updates(tp, got, conv(old), _t(mask))
    _tree_equal(jax.tree.map(lambda a: a.float().numpy(), got),
                jax.tree.map(lambda a: np.asarray(a.astype(jnp.float32)),
                             want))


def test_update_transforms_with_kept_rows():
    """Given only some clients' pre-step rows (the others frozen, new ==
    old), the transforms give what they give with every row."""
    rng = np.random.default_rng(6)
    tp, _ = _plan_pair(JScenario(straggler_fraction=0.5,
                                 straggler_slowdown=2.0,
                                 grad_scale_fraction=0.25,
                                 grad_scale_factor=8.0,
                                 adaptive_fraction=0.25), 8)
    old = _torch_tree(_grads(rng, 8))
    step = _torch_tree(_grads(rng, 8))
    mask = torch.tensor([1, 1, 0, 1, 0, 1, 1, 0], dtype=torch.float32)
    new = jax.tree.map(lambda o, d: o + 0.01 * d * mask.reshape(
        (-1,) + (1,) * (o.dim() - 1)), old, step)
    full = jax.tree.map(torch.clone, new)
    sim.scale_client_updates(tp, full, old)
    sim.adaptive_scale_updates(tp, full, old, mask)
    rows = [0, 1, 3, 5, 6]              # the selected and the adaptive
    kept = [leaf[rows] for leaf in jax_order_leaves(old)]
    part = jax.tree.map(torch.clone, new)
    sim.scale_client_updates(tp, part, kept, rows=rows)
    sim.adaptive_scale_updates(tp, part, kept, mask, rows=rows)
    for a, b in zip(tree_leaves(full), tree_leaves(part)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# core/round.py under scenarios, against the live JAX round
# ---------------------------------------------------------------------------

TINY_KW = dict(name="tiny-sim", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
CONFIGS = {"single": (TINY_KW, {}),
           "multihop": (dict(TINY_KW, name="tiny-sim-3stage", num_layers=3),
                        {"split_layers": (1, 2), "hop_replicas": 2})}
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")
LR = 1e-3
ROUNDS = 2


def _batches(vocab):
    """Per-client token streams (each client its own data) and the
    server-held validation set, as numpy."""
    out = []
    for r in range(ROUNDS):
        d = jax_lm_batch(8, 16, vocab, seed=r)
        out.append({k: v.reshape(4, 2, 16) for k, v in d.items()})
    return out, jax_lm_batch(4, 16, vocab, seed=999)


@functools.lru_cache(maxsize=None)
def _jax_round_fn(name, rule="importance", frac=0.5):
    from repro.config import AggregationConfig as JAgg
    mkw, wkw = CONFIGS[name]
    jm = JModelConfig(**mkw)
    w = JWSSLConfig(num_clients=4, participation_fraction=frac,
                    agg=JAgg(rule=rule, byzantine_f=1), **wkw)
    t = JTrainConfig(**TRAIN_KW)
    return jm, w, t, jax.jit(jax_make_round_fn(jm, w, t, impl="dense"))


@functools.lru_cache(maxsize=None)
def jax_fault_rounds(name, scenario, rule="importance", frac=0.5,
                     spread=0.0):
    """JAX: the initial state (numpy), each round's injected draws and
    metrics, and the final state (numpy).  ``spread`` > 0 offsets each
    client's initial row by seeded N(0, spread^2) noise."""
    jm, w, t, rf = _jax_round_fn(name, rule, frac)
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    if spread:
        rng = np.random.default_rng(1)
        state = state._replace(client_stack=jax.tree.map(
            lambda a: a + jnp.asarray(spread * rng.normal(size=a.shape),
                                      a.dtype), state.client_stack))
    init = jax.tree.map(np.asarray, state)
    batches, val = _batches(jm.vocab_size)
    jsc = jsim.get_scenario(scenario)
    sp = jsim.scenario_params(jsc)
    num_hops = len(state.edge_stages)
    draws, metrics = [], []
    for r in range(ROUNDS):
        _, rng_sel = jax.random.split(state.rng)
        key = jax.random.fold_in(rng_sel, 0x0DD)
        draws.append((np.asarray(jax.random.gumbel(rng_sel, (4,))),
                      _jax_plan_draws(key, 4, num_hops, w.hop_replicas),
                      jax.random.fold_in(rng_sel, 0xBAD)))
        state, m = rf(state, jax.tree.map(jnp.asarray, batches[r]),
                      jax.tree.map(jnp.asarray, val), sp)
        metrics.append(jax.tree.map(np.asarray, m._asdict()))
    return init, draws, metrics, jax.tree.map(np.asarray, state)


def torch_fault_rounds(name, scenario, rule="importance", frac=0.5,
                       init=None, draws=None):
    from repro_torch.config import AggregationConfig
    mkw, wkw = CONFIGS[name]
    cfg = ModelConfig(**mkw)
    w = WSSLConfig(num_clients=4, participation_fraction=frac,
                   agg=AggregationConfig(rule=rule, byzantine_f=1), **wkw)
    t = TrainConfig(**TRAIN_KW)
    state = (state_from_jax(init, cfg, device="cpu") if init is not None
             else init_state(torch.Generator().manual_seed(0), cfg, w, t,
                             device="cpu"))
    rf = make_round_fn(cfg, w, t, impl="dense")
    batches, val = _batches(cfg.vocab_size)
    sc = (None if scenario is None
          else sim.scenario_params(sim.get_scenario(scenario)))
    metrics = []
    for r in range(ROUNDS):
        kw = {}
        if draws is not None:
            gumbel, fd, noise_key = draws[r]
            kw = dict(gumbel=_t(gumbel),
                      fault_draws=fd._replace(noise=_jax_noise(noise_key)))
        _, m = rf(state, {k: torch.as_tensor(v) for k, v in
                          batches[r].items()},
                  {k: torch.as_tensor(v) for k, v in val.items()}, sc, **kw)
        metrics.append(m)
    return state, metrics


def _max_scale(scenario):
    sc = sim.get_scenario(scenario)
    return max(1.0, sc.grad_scale_factor if sc.grad_scale_fraction else 1.0)


def check_against_jax(name, scenario, rule="importance", frac=0.5,
                      spread=0.0):
    init, draws, jmetrics, jstate = jax_fault_rounds(name, scenario, rule,
                                                     frac, spread)
    state, metrics = torch_fault_rounds(name, scenario, rule, frac, init,
                                        draws)
    for jm, m in zip(jmetrics, metrics):
        np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
        for f in ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
                  "bytes_update_raw", "bytes_update_comp"):
            np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                          err_msg=f)
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m, f).numpy(), jm[f],
                                       rtol=1e-5, atol=1e-7, err_msg=f)
    got = state_to_numpy(state)
    diffs = []
    for f in ("client_stack", "server_params", "edge_stages"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        diffs += [np.abs(x - y).ravel() for x, y in zip(a, b)]
    diffs = np.concatenate(diffs)
    scale = _max_scale(scenario)
    assert diffs.max() <= 2 * LR * ROUNDS * scale, diffs.max()
    assert diffs.mean() <= 1e-7 * scale, diffs.mean()
    assert np.quantile(diffs, 0.999) <= 1e-6 * scale
    for f, jf in (("opt_client", jstate.opt_client),
                  ("opt_server", jstate.opt_server)):
        assert int(got[f]["step"]) == int(jf.step)
        for a, b in zip(_np_leaves(got[f]["m"]), _np_leaves(jf.m)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    return metrics, jmetrics


@pytest.mark.parametrize("scenario", TRAINING)
def test_round_under_scenario_matches_live_jax(scenario):
    check_against_jax("single", scenario)


@pytest.mark.parametrize("scenario", ["edge-dropout", "edge-latency",
                                      "dropout-30", "stragglers",
                                      "adaptive-scaled",
                                      "scaled-grad-adversary"])
def test_multihop_round_under_scenario_matches_live_jax(scenario):
    check_against_jax("multihop", scenario, frac=1.0)


@pytest.mark.parametrize("name", ["single", "multihop"])
def test_clean_scenario_equals_plain_round(name):
    a, ma = torch_fault_rounds(name, None)
    b, mb = torch_fault_rounds(name, "clean")
    for x, y in zip(tree_leaves(state_to_numpy(a)),
                    tree_leaves(state_to_numpy(b))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(ma, mb):
        for f in ("loss", "val_loss", "mask", "importance"):
            assert torch.equal(getattr(x, f), getattr(y, f)), f


def test_all_dropped_round_leaves_shared_stages_alone():
    """Every client dropped: the server stage, its moments and step count
    stay as they were, and the clients sync to what they had."""
    from repro_torch.core import round as round_mod
    cfg = ModelConfig(**TINY_KW)
    w = WSSLConfig(num_clients=4)
    t = TrainConfig(**TRAIN_KW)
    state = init_state(torch.Generator().manual_seed(0), cfg, w, t,
                       device="cpu")
    batches, val = _batches(cfg.vocab_size)
    snap = lambda: [x.clone() for x in tree_leaves(
        (state.server_params, state.opt_server.m, state.opt_server.v,
         state.client_stack))]
    before, step = snap(), int(state.opt_server.step)
    rf = round_mod.make_round_fn(cfg, w, t, impl="dense")
    _, m = rf(state, {k: torch.as_tensor(v) for k, v in batches[0].items()},
              {k: torch.as_tensor(v) for k, v in val.items()},
              sim.scenario_params(Scenario(dropout_prob=1.0)))
    assert m.mask.sum() == 0 and float(m.loss) == 0.0
    assert int(state.opt_server.step) == step
    for a, b in zip(before, snap()):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# core/paper_loop.py under scenarios, against the live JAX loop
# ---------------------------------------------------------------------------

PAPER = dict(clients=4, rounds=3, steps=2, n=3000, batch=128, lr=2e-3,
             frac=0.75)


@functools.lru_cache(maxsize=None)
def _gait():
    data = synthetic.make_gait_like(n=PAPER["n"], seed=0)
    n, nc = PAPER["n"], PAPER["clients"]
    n_tr, n_val = int(n * 0.7), int(n * 0.1)
    xy = lambda lo, hi: {k: data[k][lo:hi] for k in ("x", "y")}
    tr, val, test = xy(0, n_tr), xy(n_tr, n_tr + n_val), xy(n_tr + n_val, n)
    parts = partition.partition_by_subject(data["subject"][:n_tr], nc)

    def loaders(mod):
        return [mod.ClientLoader(tr, p, PAPER["batch"], seed=i)
                for i, p in enumerate(parts)]

    return tr, val, test, loaders


def jax_paper_draws(seed, sc_seed=0):
    """The JAX loop's initial params, Gumbel draws and noise hook."""
    jad = jpl.gait_adapter(jcfgs.GaitConfig())
    rng, sub = jax.random.split(jax.random.PRNGKey(seed))
    init = jax.tree.map(np.asarray, jad.init_split(sub))
    gumbels = []
    for _ in range(PAPER["rounds"]):
        rng, sub = jax.random.split(rng)
        gumbels.append(torch.tensor(np.asarray(
            jax.random.gumbel(sub, (PAPER["clients"],)))))
    noise_key = jax.random.PRNGKey(sc_seed + 7919 * seed + 2)

    def noise(fold, leaf, shape):
        k = jax.random.fold_in(jax.random.fold_in(noise_key, fold), leaf)
        return _t(jax.random.normal(k, shape, jnp.float32))

    return jad, init, gumbels, noise


def run_paper_pair(scenario=None, wkw=(), jwkw=(), tkw=(), seed=0):
    """The same gait WSSL run through both loops; ``tkw`` adds keyword
    arguments of the port's loop."""
    tr, val, test, loaders = _gait()
    jad, init, gumbels, noise = jax_paper_draws(seed)
    jsc = None if scenario is None else jsim.get_scenario(scenario)
    tsc = None if scenario is None else sim.get_scenario(scenario)
    common = dict(rounds=PAPER["rounds"], local_steps=PAPER["steps"],
                  lr=PAPER["lr"], seed=seed)
    jh = jpl.train_wssl(jad, loaders(jpipe), val, test, JWSSLConfig(
        num_clients=PAPER["clients"], participation_fraction=PAPER["frac"],
        **dict(jwkw)), scenario=jsc, **common)
    h = pl.train_wssl(pl.gait_adapter(cfgs.GaitConfig()), loaders(pipeline),
                      val, test, WSSLConfig(
                          num_clients=PAPER["clients"],
                          participation_fraction=PAPER["frac"], **dict(wkw)),
                      scenario=tsc, device="cpu", init=init, gumbels=gumbels,
                      noise=noise, **dict(tkw), **common)
    return h, jh, len(test["y"])


def check_paper(h, jh, n_test, loss=1e-5, importance=1e-6, examples=1):
    for k in ("round", "selected", "dropped", "participation", "bytes_up",
              "bytes_sync", "bytes_up_total", "bytes_sync_total", "scenario",
              "comm"):
        assert h[k] == jh[k], k
    for k in ("test_loss", "val_loss"):
        np.testing.assert_allclose(h[k], jh[k], rtol=0, atol=loss, err_msg=k)
    np.testing.assert_allclose(h["importance"], jh["importance"], rtol=0,
                               atol=importance)
    acc = np.abs(np.asarray(h["test_acc"]) - np.asarray(jh["test_acc"]))
    assert np.all(acc * n_test <= examples + 1e-3), acc
    assert all(np.isfinite(h["train_loss"]))


@pytest.mark.parametrize("scenario", [
    "dropout-30", "stragglers", "label-flip-adversary",
    "grad-noise-adversary", "sign-flip-adversary", "scaled-grad-adversary",
    "adaptive-scaled"])
def test_paper_loop_under_scenario_matches_live_jax(scenario):
    h, jh, n_test = run_paper_pair(scenario)
    check_paper(h, jh, n_test)


def test_paper_loop_dropout_replays_numpy():
    """``dropped`` is the numpy replay of the loop's fault generator."""
    h, _, _ = run_paper_pair("dropout-30")
    sc = sim.get_scenario("dropout-30")
    rng = np.random.default_rng(sc.seed + 7919 * 0 + 1)
    for sel, dropped in zip(h["selected"], h["dropped"]):
        picked = sorted(sel + dropped)
        assert dropped == [i for i in picked if rng.random() < 0.3]
    assert any(h["dropped"])


def test_paper_loop_clean_equals_no_scenario():
    tr, val, test, loaders = _gait()
    ad = pl.gait_adapter(cfgs.GaitConfig())
    run = lambda sc: pl.train_wssl(
        ad, loaders(pipeline), val, test,
        WSSLConfig(num_clients=4, participation_fraction=0.75), rounds=2,
        local_steps=2, lr=2e-3, seed=0, device="cpu", scenario=sc)
    a, b = run(None), run(sim.get_scenario("clean"))
    for k in ("test_acc", "test_loss", "val_loss", "importance", "selected",
              "train_loss"):
        assert a[k] == b[k], k
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert torch.equal(x, y)
