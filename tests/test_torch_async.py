"""The port's bounded-staleness async round (``core/async_round.py``), its
``DeadlineController`` and ``wssl.interpolate_to_global`` against the JAX
package on the same inputs.

* The round against the live jitted ``repro.core.async_round`` round on
  the TINY config of ``tests/test_async.py`` (2 layers, width 32, 4
  clients), JAX's initial state, Gumbel, fault, noise and compression
  draws injected, over rounds that fill, drain, evict and overflow the
  buffer: late clients buffer, then arrive discounted; 8x stragglers are
  evicted and resynced; the buffer cap evicts the overflow; Byzantine
  stragglers land late; int8 uploads with error feedback carry the parked
  delta across the wire the round it lands; a busy / slow selection
  penalty with no fault plan; a round emptied by eviction with no plan;
  a deadline at which ``lat * (1 / deadline)`` and ``lat / deadline``
  round to different sides of an integer.  Exact: the masks (fresh work),
  ``pending``, ``staleness``, the on-time / buffered / arrived / evicted
  counts, the mean staleness and every byte count.  Within the bands of
  ``tests/test_torch_round.py`` (the sync round's): losses, validation
  losses and importance rel 1e-5 (rel 1e-3 compressed); the stages and
  the buffer max |diff| 2 lr per round, mean 1e-7, 99.9th percentile
  1e-6 (compressed: mean 1e-5, at most 0.5% of coordinates off by more
  than 1e-4, as ``test_compressed_rounds_match_live_jax_round``);
  moments atol 1e-6.
* ``deadline = inf`` equals the port's ``wssl_round`` bit for bit (state
  and metrics), with no scenario and under ``stragglers`` and
  ``async-byzantine``.
* Twins of ``tests/test_async.py``: the staleness-weight properties, the
  max-staleness zero contribution (bit for bit), the latency clock, the
  config validation, async beating sync under ``async-stragglers``.
  ``test_one_executable_serves_all_latency_and_deadline_scenarios`` has
  no counterpart: the port compiles nothing per shape, so there is no
  executable cache to hold to one entry.  The paper loop's cases are in
  ``tests/test_torch_async_paper.py``, ``client_chunk`` in
  ``tests/test_torch_chunked.py``.
* ``DeadlineController`` against JAX's trajectory, and
  ``interpolate_to_global`` against JAX's, exactly.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves
from _hypothesis_fallback import given, settings, st

from _torch_threads import one_torch_thread  # noqa: F401
from repro import sim as jsim
from repro.config import AsyncRoundsConfig as JAsyncRoundsConfig
from repro.config import CompressionConfig as JCompressionConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import Scenario as JScenario
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.core import async_round as jar
from repro.core import wssl as jwssl
from repro.core.round import init_state as jax_init_state
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch import sim
from repro_torch._bridge import (async_state_from_jax, async_state_to_numpy,
                                 state_from_jax, state_to_numpy)
from repro_torch.config import (AsyncRoundsConfig, CompressionConfig,
                                ModelConfig, Scenario, TrainConfig,
                                WSSLConfig)
from repro_torch.core import wssl
from repro_torch.core.async_round import (AsyncParams, DeadlineController,
                                          async_params, init_async_state,
                                          make_async_round_fn)
from repro_torch.core.round import make_round_fn

TINY_KW = dict(name="tiny-async", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")
LR = 1e-3
N = 4
KINDS = ("constant", "polynomial", "exponential")

# a 6x straggler at this fp32 deadline: lat / d rounds to 5.0000005 (delay
# 5, evicted at max_staleness 5) where lat * (1 / d) rounds to 5.0 (delay
# 4, buffered)
DIVISION_DEADLINE = 1.1999999284744263
DIVISION_SCENARIO = dict(straggler_fraction=0.5, straggler_slowdown=6.0)

# name -> (scenario, rounds, static wssl keywords, async config keywords)
CASES = {
    "buffer-arrive": ("stragglers", 3, {}, dict(deadline=2.0)),
    "evict": ("async-stragglers", 2, {}, dict(deadline=1.0)),
    "overflow": ("stragglers", 3, {}, dict(deadline=2.0, buffer_size=1)),
    "byzantine": ("async-byzantine", 3, {}, dict(deadline=4.0)),
    "int8": ("async-stragglers", 3, dict(scheme="int8"),
             dict(deadline=4.0)),
    "beta-no-plan": (None, 3, dict(frac=0.5, beta=1.0),
                     dict(deadline=0.5, buffer_size=2)),
    "emptied": (None, 2, {}, dict(deadline=0.5, max_staleness=1)),
    "division": (DIVISION_SCENARIO, 2, {},
                 dict(deadline=DIVISION_DEADLINE, max_staleness=5)),
}


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _scenarios(scenario):
    """(JAX ScenarioParams, the port's) of a preset name, a keyword dict,
    or None."""
    if scenario is None:
        return None, None
    if isinstance(scenario, dict):
        return (jsim.scenario_params(JScenario(**scenario)),
                sim.scenario_params(Scenario(**scenario)))
    return (jsim.scenario_params(jsim.get_scenario(scenario)),
            sim.scenario_params(sim.get_scenario(scenario)))


def _batches(rounds):
    """Per-client token streams, one set a round, and the validation set
    (numpy)."""
    out = []
    for r in range(rounds):
        d = lm_batch(2 * N, 16, 64, seed=r)
        out.append({k: v.reshape(N, 2, 16) for k, v in d.items()})
    return out, lm_batch(4, 16, 64, seed=999)


@functools.lru_cache(maxsize=None)
def _jax_round_fn(frac=1.0, beta=0.0, scheme="none"):
    jm = JModelConfig(**TINY_KW)
    w = JWSSLConfig(num_clients=N, participation_fraction=frac,
                    select_staleness_beta=beta,
                    compression=JCompressionConfig(scheme=scheme))
    t = JTrainConfig(**TRAIN_KW)
    return jm, w, t, jax.jit(jar.make_async_round_fn(jm, w, t, impl="dense"))


def _jax_uniform(key):
    """The round's compression draws as the JAX round makes them."""
    def draw(tag, leaf, shape):
        k = jax.random.fold_in(key, tag)
        if leaf is not None:
            k = jax.random.fold_in(k, leaf)
        return _t(jax.random.uniform(k, shape, jnp.float32))
    return draw


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """JAX: the initial state, each round's draws, metrics and async state
    (numpy), and the final state."""
    scenario, rounds, wkw, akw = CASES[name]
    jm, w, t, rf = _jax_round_fn(**wkw)
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    astate = jar.init_async_state(state)
    ap = jar.async_params(JAsyncRoundsConfig(**akw), N)
    sp, _ = _scenarios(scenario)
    batches, val = _batches(rounds)
    draws, metrics, astates = [], [], []
    with mock.patch.multiple(jax_ops,
                             quantize_stochastic=jax_ref.quantize_stochastic_2d,
                             dequantize=jax_ref.dequantize_2d,
                             topk_mask=jax_ref.topk_mask_2d):
        for r in range(rounds):
            _, rng_sel = jax.random.split(state.rng)
            key = jax.random.fold_in(rng_sel, 0x0DD)
            draws.append((np.asarray(jax.random.gumbel(rng_sel, (N,))),
                          np.asarray(jax.random.uniform(key, (N,),
                                                        jnp.float32)),
                          jax.random.fold_in(rng_sel, 0xBAD), rng_sel))
            state, astate, m = rf(state, astate,
                                  jax.tree.map(jnp.asarray, batches[r]),
                                  jax.tree.map(jnp.asarray, val), sp, ap)
            metrics.append(jax.tree.map(np.asarray, dict(
                m._asdict(), base=m.base._asdict())))
            astates.append(jax.tree.map(np.asarray, astate))
    return init, draws, metrics, astates, jax.tree.map(np.asarray, state)


def _torch_config(name):
    _, _, wkw, akw = CASES[name]
    return ModelConfig(**TINY_KW), WSSLConfig(
        num_clients=N, participation_fraction=wkw.get("frac", 1.0),
        select_staleness_beta=wkw.get("beta", 0.0),
        compression=CompressionConfig(scheme=wkw.get("scheme", "none")),
        async_rounds=AsyncRoundsConfig(**akw)), TrainConfig(**TRAIN_KW)


@functools.lru_cache(maxsize=None)
def torch_case(name):
    """The port on JAX's initial state and draws: each round's metrics
    and async state (numpy), the final state, and the shared stages and
    their moments before each round."""
    scenario, rounds, _, _ = CASES[name]
    init, draws, _, _, _ = jax_case(name)
    cfg, w, t = _torch_config(name)
    state = state_from_jax(init, cfg, device="cpu")
    astate = init_async_state(state)
    rf = make_async_round_fn(cfg, w, t, impl="dense")
    _, sp = _scenarios(scenario)
    batches, val = _batches(rounds)
    tval = {k: torch.as_tensor(v) for k, v in val.items()}
    metrics, astates, shared = [], [], []
    noise = lambda key: (lambda i, shape: _t(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32)))
    for r, (gumbel, dropout, noise_key, rng_sel) in enumerate(draws):
        shared.append([x.clone() for x in tree_leaves(
            (state.server_params, state.opt_server.m, state.opt_server.v))])
        out_s, out_a, m = rf(
            state, astate, {k: torch.as_tensor(v)
                            for k, v in batches[r].items()}, tval, sp,
            gumbel=_t(gumbel), comp_uniform=_jax_uniform(rng_sel),
            fault_draws=sim.FaultDraws(dropout=_t(dropout),
                                       noise=noise(noise_key)))
        assert out_s is state and out_a is astate
        metrics.append(m)
        astates.append(async_state_to_numpy(astate))
    return metrics, astates, state_to_numpy(state), shared


def _check_stages(a, b, rounds, compressed, what):
    diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
    assert diffs.max() <= 2 * LR * rounds, (what, diffs.max())
    if compressed:
        assert diffs.mean() <= 1e-5, (what, diffs.mean())
        assert (diffs > 1e-4).mean() <= 5e-3, what
    else:
        assert diffs.mean() <= 1e-7, (what, diffs.mean())
        assert np.quantile(diffs, 0.999) <= 1e-6, what


EXACT = ("on_time", "buffered", "arrived", "evicted", "mean_staleness",
         "bytes_resync")
BYTES = ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
         "bytes_update_raw", "bytes_update_comp", "bytes_act_raw",
         "bytes_act_comp")


@pytest.mark.parametrize("name", list(CASES))
def test_async_rounds_match_live_jax(name):
    _, _, jmetrics, jastates, jstate = jax_case(name)
    metrics, astates, got, _ = torch_case(name)
    compressed = "scheme" in CASES[name][2]
    rtol = 1e-3 if compressed else 1e-5
    for r, (jm, m, ja, a) in enumerate(zip(jmetrics, metrics, jastates,
                                           astates)):
        np.testing.assert_array_equal(m.base.mask.numpy(), jm["base"]["mask"])
        np.testing.assert_array_equal(a["pending"], ja.pending)
        np.testing.assert_array_equal(a["staleness"], ja.staleness)
        for f in EXACT:
            assert float(getattr(m, f)) == float(jm[f]), (r, f)
        for f in BYTES:
            np.testing.assert_array_equal(np.asarray(getattr(m.base, f)),
                                          jm["base"][f], err_msg=f)
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m.base, f).numpy(),
                                       jm["base"][f], rtol=rtol, atol=1e-7,
                                       err_msg=f"round {r} {f}")
        _check_stages(_np_leaves(a["buffer"]), _np_leaves(ja.buffer), r + 1,
                      compressed, f"round {r} buffer")
    rounds = len(jmetrics)
    for f in ("client_stack", "server_params", "edge_stages", "ef_residual"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b]
        if a:
            _check_stages(a, b, rounds, compressed, f)
    for f, jf in (("opt_client", jstate.opt_client),
                  ("opt_server", jstate.opt_server)):
        assert int(got[f]["step"]) == int(jf.step)
        for x, y in zip(_np_leaves(got[f]["m"]) + _np_leaves(got[f]["v"]),
                        _np_leaves(jf.m) + _np_leaves(jf.v)):
            np.testing.assert_allclose(x, y, atol=1e-6)


def _counts(name):
    metrics = torch_case(name)[0]
    return [tuple(float(getattr(m, f)) for f in ("on_time", "buffered",
                                                 "arrived", "evicted"))
            for m in metrics]


def test_late_clients_buffer_then_arrive_discounted():
    """4x stragglers under deadline 2 miss by one round: parked in round
    0, arriving at staleness 1 in round 1 (busy, unselectable, between),
    parked again in round 2."""
    metrics, astates, _, _ = torch_case("buffer-arrive")
    assert _counts("buffer-arrive") == [(2, 2, 0, 0), (2, 0, 2, 0),
                                        (2, 2, 0, 0)]
    np.testing.assert_array_equal(astates[0]["pending"], [0, 0, 1, 1])
    np.testing.assert_array_equal(astates[0]["staleness"], [0, 0, 1, 1])
    assert any(np.abs(l[2:]).max() > 0
               for l in jax.tree.leaves(astates[0]["buffer"]))
    assert float(metrics[1].mean_staleness) == 1.0
    np.testing.assert_array_equal(metrics[1].base.mask.numpy(), [1, 1, 0, 0])
    np.testing.assert_array_equal(astates[1]["pending"], 0)
    for leaf in jax.tree.leaves(astates[1]["buffer"]):
        np.testing.assert_array_equal(leaf, 0.0)


def test_too_stale_clients_evicted_and_resynced():
    """8x stragglers under deadline 1 would land at staleness 7 >= 4:
    evicted at admission, and their resync is in bytes_sync."""
    metrics, astates, got, _ = torch_case("evict")
    assert _counts("evict") == [(2, 0, 0, 2)] * 2
    stage = sum(x[0].nbytes for x in _np_leaves(got["client_stack"]))
    for m, a in zip(metrics, astates):
        np.testing.assert_array_equal(a["pending"], 0)
        assert float(m.bytes_resync) == 2.0 * stage
        assert float(m.base.bytes_sync) == (2 + N) * stage + 2.0 * stage


def test_buffer_size_cap_evicts_overflow():
    """With one slot only client 2 parks; client 3 overflows and is
    evicted, never silently dropped."""
    _, astates, _, _ = torch_case("overflow")
    assert _counts("overflow")[0] == (2, 1, 0, 1)
    np.testing.assert_array_equal(astates[0]["pending"], [0, 0, 1, 0])


def test_deadline_division_is_a_true_fp32_division():
    """At this deadline the reciprocal form would admit the stragglers
    (delay 4); the true division evicts them (delay 5 >= 5), as JAX."""
    lat, d = np.float32(6.0), np.float32(DIVISION_DEADLINE)
    assert np.ceil(lat / d) - 1 == 5
    assert np.ceil(lat * (np.float32(1.0) / d)) - 1 == 4
    assert _counts("division") == [(2, 0, 0, 2)] * 2


def test_selection_penalty_without_a_plan():
    """select_staleness_beta > 0 with no scenario: the busy clients pay
    their pending rounds at the draw (the masks equal JAX's exactly in
    ``test_async_rounds_match_live_jax``)."""
    metrics, astates, _, _ = torch_case("beta-no-plan")
    # round 0 selects all; every client is late at deadline 0.5; two park
    assert _counts("beta-no-plan")[0] == (0, 2, 0, 2)
    np.testing.assert_array_equal(astates[0]["pending"], [1, 1, 0, 0])
    assert _counts("beta-no-plan")[1][2] == 2


def test_round_emptied_by_eviction_leaves_shared_stages_alone():
    """No plan, deadline 0.5, max_staleness 1: every client is evicted.
    The server stage, its moments and its step count stay as they were."""
    metrics, _, got, shared = torch_case("emptied")
    _, _, _, _, jstate = jax_case("emptied")
    for m in metrics:
        assert float(m.base.mask.sum()) == 0 and float(m.base.loss) == 0.0
        assert float(m.evicted) == N
    for before, after in zip(shared, shared[1:]):
        for x, y in zip(before, after):
            assert torch.equal(x, y)
    assert int(got["opt_server"]["step"]) == int(jstate.opt_server.step) == 0


@functools.lru_cache(maxsize=None)
def _inf_pair(scenario, rounds=2):
    """The async round at deadline inf and the sync round, from one JAX
    initial state, frac 0.5, per-client streams."""
    jm, w, t, _ = _jax_round_fn(frac=0.5)
    init = jax.tree.map(np.asarray, jax_init_state(
        jax.random.PRNGKey(0), jm, w, t)[0])
    cfg = ModelConfig(**TINY_KW)
    wc = WSSLConfig(num_clients=N, participation_fraction=0.5)
    tc = TrainConfig(**TRAIN_KW)
    _, sp = _scenarios(scenario)
    batches, val = _batches(rounds)
    tval = {k: torch.as_tensor(v) for k, v in val.items()}
    a, b = state_from_jax(init, cfg, device="cpu"), state_from_jax(
        init, cfg, device="cpu")
    astate = init_async_state(a)
    arf = make_async_round_fn(cfg, wc, tc, impl="dense")
    srf = make_round_fn(cfg, wc, tc, impl="dense")
    out = []
    for r in range(rounds):
        batch = {k: torch.as_tensor(v) for k, v in batches[r].items()}
        _, _, am = arf(a, astate, batch, tval, sp)
        _, sm = srf(b, batch, tval, sp)
        out.append((am, sm))
    return a, b, out


@pytest.mark.parametrize("scenario", [None, "stragglers", "async-byzantine"])
def test_deadline_inf_equals_sync_round(scenario):
    a, b, out = _inf_pair(scenario)
    for x, y in zip(tree_leaves(state_to_numpy(a)),
                    tree_leaves(state_to_numpy(b))):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for am, sm in out:
        for f in sm._fields:
            np.testing.assert_array_equal(
                np.asarray(torch.as_tensor(getattr(am.base, f))),
                np.asarray(torch.as_tensor(getattr(sm, f))), err_msg=f)
        assert float(am.buffered) == float(am.arrived) == 0.0
        assert float(am.evicted) == 0.0


def test_max_staleness_contributes_exactly_zero():
    """A parked update at max_staleness contributes exactly zero: a buffer
    slot poisoned with 1e6 gives the same stack as a zeroed one, bit for
    bit, and the slot frees afterwards."""
    cfg, _, t = _torch_config("buffer-arrive")
    w = WSSLConfig(num_clients=N, participation_fraction=1.0,
                   async_rounds=AsyncRoundsConfig(deadline=2.0,
                                                  max_staleness=3))
    init, _, _, _, _ = jax_case("buffer-arrive")
    batches, val = _batches(1)
    outs = []
    for poison in (True, False):
        state = state_from_jax(init, cfg, device="cpu")
        astate = init_async_state(state)
        astate.pending.copy_(torch.tensor([1, 0, 0, 0]))
        astate.staleness.copy_(torch.tensor([3, 0, 0, 0]))
        if poison:
            for leaf in tree_leaves(astate.buffer):
                leaf[0] = 1e6
        make_async_round_fn(cfg, w, t, impl="dense")(
            state, astate, {k: torch.as_tensor(v)
                            for k, v in batches[0].items()},
            {k: torch.as_tensor(v) for k, v in val.items()})
        outs.append((state, astate))
    for x, y in zip(tree_leaves(outs[0][0].client_stack),
                    tree_leaves(outs[1][0].client_stack)):
        assert torch.equal(x, y) and torch.isfinite(x).all()
    assert int(outs[0][1].pending[0]) == int(outs[0][1].staleness[0]) == 0
    for leaf in tree_leaves(outs[0][1].buffer):
        assert not leaf[0].any()


def test_async_state_bridge_roundtrip():
    """A JAX AsyncState with a non-empty buffer crosses the bridge and
    back unchanged."""
    _, _, _, jastates, _ = jax_case("buffer-arrive")
    ja = jastates[0]
    assert any(np.abs(x).max() > 0 for x in jax.tree.leaves(ja.buffer))
    got = async_state_to_numpy(async_state_from_jax(
        ja, ModelConfig(**TINY_KW), device="cpu"))
    np.testing.assert_array_equal(got["pending"], ja.pending)
    np.testing.assert_array_equal(got["staleness"], ja.staleness)
    for x, y in zip(jax.tree.leaves(got["buffer"]), jax.tree.leaves(
            ja.buffer)):
        np.testing.assert_array_equal(x, y)


def test_async_beats_sync_under_async_stragglers():
    """The acceptance property of ``tests/test_async.py`` in the port:
    under async-stragglers (half the clients at 8x) a bounded-staleness
    deadline reaches a better final validation loss than the synchronous
    round, whose aggregate is dragged by 1/8-progress stragglers."""
    jm, w, t, _ = _jax_round_fn()
    init = jax.tree.map(np.asarray, jax_init_state(
        jax.random.PRNGKey(0), jm, w, t)[0])
    cfg = ModelConfig(**TINY_KW)
    wc = WSSLConfig(num_clients=N, participation_fraction=1.0,
                    importance_temp=0.1, importance_ema=0.8,
                    async_rounds=AsyncRoundsConfig(deadline=1.0,
                                                   max_staleness=2))
    tc = TrainConfig(**dict(TRAIN_KW, learning_rate=3e-3))
    a, s = (state_from_jax(init, cfg, device="cpu") for _ in range(2))
    astate = init_async_state(a)
    arf = make_async_round_fn(cfg, wc, tc, impl="dense")
    srf = make_round_fn(cfg, wc, tc, impl="dense")
    sp = sim.scenario_params(sim.get_scenario("async-stragglers"))
    val = {k: torch.as_tensor(v) for k, v in lm_batch(4, 16, 64,
                                                      seed=999).items()}
    for r in range(8):
        d = lm_batch(2, 16, 64, seed=r)
        batch = {k: torch.as_tensor(v)[None].expand(N, 2, 16)
                 for k, v in d.items()}
        _, _, am = arf(a, astate, batch, val, sp)
        _, sm = srf(s, batch, val, sp)
    async_vl, sync_vl = float(am.base.val_loss.mean()), float(
        sm.val_loss.mean())
    assert async_vl < sync_vl, (async_vl, sync_vl)


# ---------------------------------------------------------------------------
# Twins of tests/test_async.py's unit tests
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(max_staleness=st.integers(1, 12), alpha=st.floats(0.01, 3.0),
       kind=st.sampled_from(KINDS))
def test_staleness_weights_monotone_nonincreasing(max_staleness, alpha, kind):
    s = torch.arange(0, max_staleness + 4, dtype=torch.float32)
    w = wssl.staleness_weights(s, max_staleness, kind=kind,
                               alpha=alpha).numpy()
    assert w[0] == 1.0
    assert (np.diff(w) <= 1e-7).all(), w
    assert (w >= 0.0).all() and (w <= 1.0).all()
    assert (w[max_staleness:] == 0.0).all()
    want = jwssl.staleness_weights(jnp.asarray(s.numpy()), max_staleness,
                                   kind=kind, alpha=alpha)
    np.testing.assert_allclose(w, np.asarray(want), rtol=1e-6)


@settings(max_examples=30, deadline=None)
@given(n=st.integers(2, 12), seed=st.integers(0, 1000),
       kind=st.sampled_from(KINDS), max_staleness=st.integers(1, 6))
def test_async_coefficients_sum_to_one(n, seed, kind, max_staleness):
    rng = np.random.default_rng(seed)
    imp = torch.tensor(rng.dirichlet(np.ones(n)), dtype=torch.float32)
    role = rng.integers(0, 3, size=n)           # 0 idle, 1 fresh, 2 arriving
    fresh = torch.tensor(role == 1, dtype=torch.float32)
    arriving = torch.tensor(role == 2, dtype=torch.float32)
    staleness = torch.tensor(rng.integers(1, max_staleness + 2, size=n),
                             dtype=torch.float32)
    contrib = wssl.async_contribution(fresh, arriving, staleness,
                                      max_staleness, kind=kind)
    coefs = wssl.safe_aggregation_weights(imp, contrib, WSSLConfig(
        num_clients=n)).numpy()
    assert abs(coefs.sum() - 1.0) < 1e-5
    assert (coefs >= 0).all()
    if float(contrib.sum()) > 0:
        assert (coefs[role == 0] == 0).all()
        assert (coefs[(role == 2) & (staleness.numpy() >= max_staleness)]
                == 0).all()


def test_latency_clock_from_fault_plan():
    np.testing.assert_array_equal(sim.client_latencies(None, 5).numpy(),
                                  1.0)
    sp = sim.scenario_params(Scenario(straggler_fraction=0.5,
                                      straggler_slowdown=4.0))
    plan = sim.sample_fault_plan(sp, 4, generator=torch.Generator())
    np.testing.assert_array_equal(sim.client_latencies(plan, 4).numpy(),
                                  [1.0, 1.0, 4.0, 4.0])


def test_async_config_validation():
    for kw in (dict(staleness_weighting="linear"), dict(deadline=0.0),
               dict(max_staleness=0), dict(buffer_size=0)):
        with pytest.raises(ValueError):
            AsyncRoundsConfig(**kw)
        with pytest.raises(ValueError):
            JAsyncRoundsConfig(**kw)
    assert not AsyncRoundsConfig().enabled
    assert AsyncRoundsConfig(deadline=2.0).enabled


def test_async_params_match_jax():
    for kw in (dict(), dict(deadline=2.5, max_staleness=3, buffer_size=2,
                            staleness_alpha=1.5)):
        got = async_params(AsyncRoundsConfig(**kw), 6)
        want = jar.async_params(JAsyncRoundsConfig(**kw), 6)
        for f in AsyncParams._fields:
            x = getattr(got, f)
            assert x.dtype == torch.float32 and x.dim() == 0
            assert float(x) == float(getattr(want, f)), f


# ---------------------------------------------------------------------------
# DeadlineController, interpolate_to_global
# ---------------------------------------------------------------------------


def test_deadline_controller_follows_jax_trajectory():
    rng = np.random.default_rng(3)
    obs = [(float(rng.uniform(0, 4)), int(rng.integers(0, 3)))
           for _ in range(40)]
    for kw in (dict(target_staleness=1.0), dict(
            target_staleness=0.5, deadline=8.0, gain=0.7, min_deadline=0.5,
            max_deadline=16.0)):
        a, b = DeadlineController(**kw), jar.DeadlineController(**kw)
        for mean, arrived in obs:
            assert a.update(mean, arrived) == b.update(mean, arrived)
        acfg = AsyncRoundsConfig(deadline=2.0, buffer_size=3)
        got = a.params(acfg, N)
        want = b.params(JAsyncRoundsConfig(deadline=2.0, buffer_size=3), N)
        for f in AsyncParams._fields:
            assert float(getattr(got, f)) == float(getattr(want, f)), f
    with pytest.raises(ValueError):
        DeadlineController(target_staleness=-1.0)
    with pytest.raises(ValueError):
        DeadlineController(target_staleness=1.0, min_deadline=2.0,
                           max_deadline=1.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("alpha", [0.0, 0.3, 1.0])
def test_interpolate_to_global_matches_jax(dtype, alpha):
    rng = np.random.default_rng(5)
    stack = {"a": rng.normal(size=(4, 3, 5)).astype(np.float32),
             "b": [rng.normal(size=(4, 7)).astype(np.float32)]}
    glob = {"a": rng.normal(size=(3, 5)).astype(np.float32),
            "b": [rng.normal(size=(7,)).astype(np.float32)]}
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = jwssl.interpolate_to_global(
        jax.tree.map(lambda x: jnp.asarray(x, jd), stack),
        jax.tree.map(lambda x: jnp.asarray(x, jd), glob), alpha)
    got = jax.tree.map(lambda x: torch.as_tensor(x).to(td), stack)
    ptrs = [x.data_ptr() for x in tree_leaves(got)]
    out = wssl.interpolate_to_global(
        got, jax.tree.map(lambda x: torch.as_tensor(x).to(td), glob), alpha)
    assert out is got and ptrs == [x.data_ptr() for x in tree_leaves(got)]
    for x, y in zip(tree_leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(x.float().numpy(),
                                      np.asarray(y, np.float32))
