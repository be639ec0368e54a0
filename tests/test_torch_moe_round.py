"""The WSSL rounds under Mixture-of-Experts in the port against the live
JAX rounds: the edge and server stages' router aux loss over every client.

On ``tests/test_system.py``'s tiny MoE config (3 layers, every MLP an
MoE of 4 experts top-2, cuts (1, 2): a client stage, one edge stage and
the server, so both aux terms show), 4 clients, participation 0.5,
``grad_clip`` 1.0, 2 rounds from JAX's initial state with its Gumbel
draws injected (round 0 selects everyone, round 1 two clients):

* the flat round and the ``client_chunk=2`` round: masks and byte counts
  exact; losses, validation losses and importance rel 1e-5; the stages
  max |diff| 2 lr a round, mean 1e-7, 99.9th percentile 1e-6; moments
  atol 1e-6 (``tests/test_torch_round.py``'s bands);
* the flat rounds again with only round 1's unselected clients' tokens
  redrawn.  JAX adds each edge and server stage's aux as the mean over
  all N clients, so their data still moves the loss and the shared
  stages; the port's loss moves by JAX's move within 1%, its stages'
  moves agree within atol 1e-6, and JAX's moves are asserted to exceed
  those bands, so a round that skipped the unselected clients fails;
* the async round at deadline 2 under ``stragglers`` (its fault draws
  injected as in ``tests/test_torch_async.py``, whose bands hold), where
  the late clients park in round 0 and land in round 1.

The layer, the model paths and the serving engine are held in
``tests/test_torch_moe.py``.  The two files are split so that each stays
within the test-time budget of one process: every JAX round here is one
jitted executable, ~8-10 s of tracing and compiling apiece on the CPU.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro import sim as jsim
from repro.config import AsyncRoundsConfig as JAsyncRoundsConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.core import async_round as jar
from repro.core.round import init_state as jax_init_state
from repro.core.round import make_round_fn as jax_make_round_fn
from repro.data.synthetic import lm_batch
from repro_torch import sim
from repro_torch._bridge import (async_state_to_numpy, state_from_jax,
                                 state_to_numpy)
from repro_torch.config import (AsyncRoundsConfig, ModelConfig, TrainConfig,
                                WSSLConfig)
from repro_torch.core.async_round import (init_async_state,
                                          make_async_round_fn)
from repro_torch.core.round import make_round_fn

LR = 1e-3
TRAIN_KW = dict(remat=False, learning_rate=LR, warmup_steps=0,
                schedule="constant", grad_clip=1.0)
# tests/test_system.py's tiny MoE config
TINY_KW = dict(name="tiny-moe", num_layers=3, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, mlp_pattern=("moe",),
               num_experts=4, experts_per_token=2, moe_capacity_factor=4.0,
               dtype="float32", param_dtype="float32")
N = 4
W_KW = dict(num_clients=N, participation_fraction=0.5, split_layers=(1, 2))


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _batches(alt_rows=()):
    """Two rounds of client batches (numpy) and the validation set; with
    ``alt_rows`` those clients' round-1 tokens and labels are redrawn."""
    out = []
    for r in range(2):
        d = lm_batch(2 * N, 16, 64, seed=r)
        out.append({k: v.reshape(N, 2, 16).copy() for k, v in d.items()})
    for i in alt_rows:
        alt = lm_batch(2, 16, 64, seed=100 + i)
        for k in out[1]:
            out[1][k][i] = alt[k]
    return out, lm_batch(4, 16, 64, seed=999)


@functools.lru_cache(maxsize=None)
def _jax_round_fn(chunk):
    jm = JModelConfig(**TINY_KW)
    w = JWSSLConfig(**W_KW)
    t = JTrainConfig(client_chunk=chunk, **TRAIN_KW)
    return jm, w, t, jax_make_round_fn(jm, w, t, impl="dense", donate=True)


@functools.lru_cache(maxsize=None)
def _jax_init():
    """JAX's initial state (numpy), one jitted init for every round case:
    the sync and async rounds start from the same state."""
    jm, w, t = (JModelConfig(**TINY_KW), JWSSLConfig(**W_KW),
                JTrainConfig(**TRAIN_KW))
    state = jax.jit(lambda key: jax_init_state(key, jm, w, t)[0])(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def jax_rounds(chunk=None, alt_rows=()):
    _, _, _, rf = _jax_round_fn(chunk)
    init = _jax_init()
    state = jax.tree.map(jnp.asarray, init)
    batches, val = _batches(alt_rows)
    gumbels, metrics = [], []
    for b in batches:
        _, rng_sel = jax.random.split(state.rng)
        gumbels.append(np.asarray(jax.random.gumbel(rng_sel, (N,))))
        state, m = rf(state, jax.tree.map(jnp.asarray, b),
                      jax.tree.map(jnp.asarray, val))
        metrics.append(jax.tree.map(np.asarray, m._asdict()))
    return init, gumbels, metrics, jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def torch_rounds(chunk=None, alt_rows=()):
    init, gumbels, _, _ = jax_rounds(chunk, alt_rows)
    cfg = ModelConfig(**TINY_KW)
    state = state_from_jax(init, cfg, device="cpu")
    rf = make_round_fn(cfg, WSSLConfig(**W_KW),
                       TrainConfig(client_chunk=chunk, **TRAIN_KW),
                       impl="dense")
    batches, val = _batches(alt_rows)
    tval = {k: _t(v) for k, v in val.items()}
    metrics = []
    for b, g in zip(batches, gumbels):
        _, m = rf(state, {k: _t(v) for k, v in b.items()}, tval,
                  gumbel=_t(g))
        metrics.append(m)
    return metrics, state_to_numpy(state)


def _check_stages(a, b, rounds, what):
    diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
    assert diffs.max() <= 2 * LR * rounds, (what, diffs.max())
    assert diffs.mean() <= 1e-7, (what, diffs.mean())
    assert np.quantile(diffs, 0.999) <= 1e-6, what


def _check_rounds(jmetrics, jstate, metrics, got):
    for jm, m in zip(jmetrics, metrics):
        np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m, f).numpy(), jm[f],
                                       rtol=1e-5, atol=1e-7, err_msg=f)
        for f in ("bytes_up", "bytes_per_hop", "bytes_sync",
                  "bytes_update_raw"):
            np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                          err_msg=f)
    for f in ("client_stack", "server_params", "edge_stages"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b] and a
        _check_stages(a, b, len(jmetrics), f)
    for f in ("opt_client", "opt_server"):
        for k in ("m", "v"):
            for x, y in zip(_np_leaves(got[f][k]),
                            _np_leaves(getattr(getattr(jstate, f), k))):
                np.testing.assert_allclose(x, y, atol=1e-6)
    for o, jo in zip(got["opt_edge"], jstate.opt_edge):
        for x, y in zip(_np_leaves(o["m"]) + _np_leaves(o["v"]),
                        _np_leaves(jo.m) + _np_leaves(jo.v)):
            np.testing.assert_allclose(x, y, atol=1e-6)


@pytest.mark.parametrize("chunk", [None, 2])
def test_rounds_match_live_jax_round(chunk):
    _, _, jmetrics, jstate = jax_rounds(chunk)
    metrics, got = torch_rounds(chunk)
    # round 0 selects everyone; round 1 leaves two clients out
    assert jmetrics[0]["mask"].sum() == N and jmetrics[1]["mask"].sum() < N
    _check_rounds(jmetrics, jstate, metrics, got)


def _unselected():
    return tuple(int(i) for i in np.flatnonzero(
        jax_rounds(None)[2][1]["mask"] == 0))


def test_unselected_clients_data_moves_the_round_as_in_jax():
    """Only round 1's unselected clients' tokens change.  In JAX their
    aux still enters the edge and server stages' objective (mean over all
    N), so the loss and the shared stages move; the port moves by the
    same amounts, which a round that skipped them would not."""
    alt = _unselected()
    assert alt
    _, _, jm0, js0 = jax_rounds(None)
    _, _, jm1, js1 = jax_rounds(None, alt)
    m0, g0 = torch_rounds(None)
    m1, g1 = torch_rounds(None, alt)
    _check_rounds(jm1, js1, m1, g1)
    np.testing.assert_array_equal(jm1[1]["mask"], jm0[1]["mask"])
    jmove = float(jm1[1]["loss"]) - float(jm0[1]["loss"])
    tmove = float(m1[1].loss) - float(m0[1].loss)
    assert abs(jmove) > 1e-5 * abs(float(jm0[1]["loss"]))
    assert tmove == pytest.approx(jmove, rel=1e-2)
    for f in ("server_params", "edge_stages"):
        jd = [a - b for a, b in zip(_np_leaves(getattr(js1, f)),
                                    _np_leaves(getattr(js0, f)))]
        td = [a - b for a, b in zip(_np_leaves(g1[f]), _np_leaves(g0[f]))]
        assert max(np.abs(x).max() for x in jd) > 1e-5, f
        for x, y in zip(td, jd):
            np.testing.assert_allclose(x, y, atol=1e-6, err_msg=f)


# the async round at one finite deadline, under ``stragglers``
DEADLINE = 2.0


@functools.lru_cache(maxsize=None)
def jax_async():
    jm = JModelConfig(**TINY_KW)
    w = JWSSLConfig(**W_KW)
    t = JTrainConfig(**TRAIN_KW)
    rf = jax.jit(jar.make_async_round_fn(jm, w, t, impl="dense"))
    init = _jax_init()
    state = jax.tree.map(jnp.asarray, init)
    astate = jar.init_async_state(state)
    ap = jar.async_params(JAsyncRoundsConfig(deadline=DEADLINE), N)
    sp = jsim.scenario_params(jsim.get_scenario("stragglers"))
    batches, val = _batches()
    draws, metrics = [], []
    for b in batches:
        _, rng_sel = jax.random.split(state.rng)
        key = jax.random.fold_in(rng_sel, 0x0DD)
        draws.append((np.asarray(jax.random.gumbel(rng_sel, (N,))),
                      np.asarray(jax.random.uniform(key, (N,), jnp.float32)),
                      jax.random.fold_in(rng_sel, 0xBAD)))
        state, astate, m = rf(state, astate, jax.tree.map(jnp.asarray, b),
                              jax.tree.map(jnp.asarray, val), sp, ap)
        metrics.append(jax.tree.map(np.asarray, dict(
            m._asdict(), base=m.base._asdict())))
    return (init, draws, metrics, jax.tree.map(np.asarray, state),
            jax.tree.map(np.asarray, astate))


def test_async_round_matches_live_jax_round():
    init, draws, jmetrics, jstate, jastate = jax_async()
    cfg = ModelConfig(**TINY_KW)
    w = WSSLConfig(**W_KW, async_rounds=AsyncRoundsConfig(deadline=DEADLINE))
    state = state_from_jax(init, cfg, device="cpu")
    astate = init_async_state(state)
    rf = make_async_round_fn(cfg, w, TrainConfig(**TRAIN_KW), impl="dense")
    sp = sim.scenario_params(sim.get_scenario("stragglers"))
    batches, val = _batches()
    tval = {k: _t(v) for k, v in val.items()}
    noise = lambda key: (lambda i, shape: _t(jax.random.normal(
        jax.random.fold_in(key, i), shape, jnp.float32)))
    for b, (g, dropout, nkey), jm in zip(batches, draws, jmetrics):
        _, _, m = rf(state, astate, {k: _t(v) for k, v in b.items()}, tval,
                     sp, gumbel=_t(g), fault_draws=sim.FaultDraws(
                         dropout=_t(dropout), noise=noise(nkey)))
        np.testing.assert_array_equal(m.base.mask.numpy(), jm["base"]["mask"])
        for f in ("on_time", "buffered", "arrived", "evicted"):
            assert float(getattr(m, f)) == float(jm[f]), f
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m.base, f).numpy(),
                                       jm["base"][f], rtol=1e-5, atol=1e-7,
                                       err_msg=f)
    # late clients parked and then landed: the buffer path ran
    assert [float(jm["buffered"]) for jm in jmetrics][0] > 0
    got = state_to_numpy(state)
    for f in ("client_stack", "server_params", "edge_stages"):
        _check_stages(_np_leaves(got[f]), _np_leaves(getattr(jstate, f)),
                      len(jmetrics), f)
    a = async_state_to_numpy(astate)
    np.testing.assert_array_equal(a["pending"], jastate.pending)
    _check_stages(_np_leaves(a["buffer"]), _np_leaves(jastate.buffer),
                  len(jmetrics), "buffer")
