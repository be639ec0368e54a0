"""The port's client-sharded async round (``make_sharded_async_round_fn``
over gloo ranks on the CPU) against JAX's async round body under
``vmap`` (``tests/_jax_shards.py``), and at deadline inf against the
port's sharded sync round.

* ``async-stragglers`` (half the clients 8x slow) at S 2 on the TINY
  config of ``tests/test_sharded_round.py`` (8 clients, participation
  0.5, ``impl="chunked"``, ``client_chunk=2``: two chunks a shard) at
  deadline 4 and max staleness 4, 2 rounds: in round 0 every client is
  selected and the slow half, all of shard 1, parks its update (delay 1);
  in round 1 it lands at its staleness discount.  Masks, ``pending``,
  ``staleness`` and the on-time / buffered / arrived / evicted counts
  exact; the client stack 1e-5; the server stage, losses and validation
  losses 5e-3 (``tests/test_sharded_round.py``'s bands); byte counts
  exact.  The buffer holds each parked client's own AdamW step, not an
  average, so it takes the async round's port-vs-JAX bands
  (``tests/test_torch_async.py``): max |diff| 2 lr a round, mean 1e-7,
  99.9th percentile 1e-6 (measured max 1.5e-5 in round 0).
* Deadline inf: the sharded async round equals the sharded sync round bit
  for bit on every rank (state and metrics), both under
  ``async-stragglers``.
* Reduced OLMoE-1B-7B (2 layers, cut 1: the server stage's MLP is an MoE
  of 4 experts top-2, so its router's aux loss enters for every client,
  and the loss sums each shard's aux over its clients / N) at S 2, the
  same scenario and deadline, against JAX under ``vmap``: the counts,
  masks and bytes exact, the server stage and the losses 5e-3, the
  buffer as above.  The client stack: 1e-5 against the port's own flat
  async round (measured 1.0e-6), and against JAX the flat rounds' own
  port-vs-JAX bands (max 2 lr a round, mean 1e-7, 99.9th percentile
  1e-6): the flat rounds already differ by 2.8e-5 there, where AdamW's
  first step divides gradients near its eps (JAX's sharded round differs
  from JAX's flat one by 9.7e-7).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_shards as js
import _torch_shards as ts
from _torch_threads import one_torch_thread  # noqa: F401
from repro import sim as jsim
from repro.config import AsyncRoundsConfig as JAsyncRoundsConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.core import async_round as jar
from repro.core.round import init_state as jax_init_state
from repro.data.synthetic import lm_batch
from repro_torch import sim
from repro_torch.config import (AsyncRoundsConfig, ModelConfig, TrainConfig,
                                WSSLConfig, get_arch, reduced)
from repro_torch._bridge import state_from_jax, state_to_numpy
from repro_torch.core.async_round import (async_params, init_async_state,
                                          make_async_round_fn)
from repro_torch.launch.mesh import spawn_client_shards

TINY_KW = dict(name="tiny-shard", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
N, S, ROUNDS, IMPL = 8, 2, 2, "chunked"
SCENARIO = "async-stragglers"
ASYNC_KW = dict(deadline=4.0, max_staleness=4)
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant", client_chunk=2)
CLIENT_BAND, SHARED_BAND, LR = 1e-5, 5e-3, 1e-3
COUNTS = ("on_time", "buffered", "arrived", "evicted", "mean_staleness",
          "bytes_resync")
BYTES = ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
         "bytes_update_raw", "bytes_update_comp", "bytes_cross_shard",
         "bytes_intra_shard")


def _models(name):
    if name == "tiny":
        return JModelConfig(**TINY_KW), ModelConfig(**TINY_KW), {}
    return (jax_reduced(jax_get_arch("olmoe-1b-7b")),
            reduced(get_arch("olmoe-1b-7b")), {"split_layer": 1})


def _configs(name, deadline=ASYNC_KW["deadline"]):
    jm, cfg, cut = _models(name)
    akw = dict(ASYNC_KW, deadline=deadline)
    wkw = dict(num_clients=N, participation_fraction=0.5,
               importance_temp=0.1, importance_ema=0.8, **cut)
    return ((jm, JWSSLConfig(async_rounds=JAsyncRoundsConfig(**akw), **wkw),
             JTrainConfig(**TRAIN_KW)),
            (cfg, WSSLConfig(async_rounds=AsyncRoundsConfig(**akw), **wkw),
             TrainConfig(**TRAIN_KW)))


def _batches(vocab):
    out = []
    for r in range(ROUNDS):
        d = lm_batch(N * 2, 16, vocab, seed=r)
        out.append({k: v.reshape(N, 2, 16) for k, v in d.items()})
    return out, lm_batch(4, 16, vocab, seed=999)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """JAX's async round body under vmap: the initial state, each round's
    draws, metrics and async state (numpy), and the final states merged."""
    (jm, w, t), _ = _configs(name)
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    axes = js.state_in_axes(jm, w, t)
    a_axes = js.async_in_axes(axes)
    st = js.split(state, axes, S)
    ast = js.split(jar.init_async_state(state), a_axes, S)
    sp = jsim.scenario_params(jsim.get_scenario(SCENARIO))
    ap = jar.async_params(w.async_rounds, N)
    batches, val = _batches(jm.vocab_size)
    jval = {k: jnp.asarray(v) for k, v in val.items()}
    fn = js.sharded_async_round(jm, w, t, S, IMPL)
    rounds, metrics, astates = [], [], []
    for r in range(ROUNDS):
        rounds.append({"batch": batches[r], "gumbel": js.gumbel(st, N)})
        jb = {k: jnp.asarray(v).reshape((S, N // S) + v.shape[1:])
              for k, v in batches[r].items()}
        out, aout, m = fn(st, ast, jb, jval, sp, ap)
        st, ast = js.take(out, axes), js.take(aout, a_axes)
        metrics.append(js.metrics_numpy(m))
        astates.append(js.merge(ast, a_axes))
    return init, rounds, val, metrics, astates, js.merge(st, axes)


def _case(name, deadline=ASYNC_KW["deadline"], sync_too=False):
    init, rounds, val, _, _, _ = jax_case(name)
    _, (cfg, w, t) = _configs(name, deadline)
    return {"cfg": (cfg, w, t), "impl": IMPL, "init": ts.jax_namespace(init),
            "rounds": rounds, "val": val,
            "scenario": sim.scenario_params(sim.get_scenario(SCENARIO)),
            "async_p": async_params(w.async_rounds, N), "sync_too": sync_too}


@functools.lru_cache(maxsize=None)
def port_runs():
    """Every case in one spawn of two gloo ranks: the TINY and OLMoE async
    rounds at deadline 4, and TINY at deadline inf beside the sync
    round."""
    cases = [_case("tiny"), _case("olmoe"),
             _case("tiny", deadline=float("inf"), sync_too=True)]
    ranks = spawn_client_shards(ts.run_cases, S, cases, device="cpu",
                                backend="gloo", timeout=60.0, threads=1)
    return {k: [r[i] for r in ranks]
            for i, k in enumerate(("tiny", "olmoe", "inf"))}


@functools.lru_cache(maxsize=None)
def port_flat_async(name):
    """The port's flat async round on the same initial state and draws:
    its final state (numpy)."""
    init, rounds, val, _, _, _ = jax_case(name)
    _, (cfg, w, t) = _configs(name)
    state = state_from_jax(ts.jax_namespace(init), cfg, device="cpu")
    astate = init_async_state(state)
    rf = make_async_round_fn(cfg, w, t, impl=IMPL)
    sp = sim.scenario_params(sim.get_scenario(SCENARIO))
    tval = {k: torch.as_tensor(v) for k, v in val.items()}
    for rd in rounds:
        rf(state, astate, {k: torch.as_tensor(v)
                           for k, v in rd["batch"].items()}, tval, sp,
           gumbel=torch.as_tensor(rd["gumbel"]))
    return state_to_numpy(state)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _max_diff(a, b):
    return max((float(np.abs(x - y).max()) for x, y in
                zip(_leaves(a), _leaves(b))), default=0.0)


def _cat(trees):
    return jax.tree.map(lambda *xs: np.concatenate(xs, axis=0), *trees)


@pytest.mark.parametrize("name", ["tiny", "olmoe"])
def test_sharded_async_round_matches_jax_under_vmap(name):
    _, _, _, jmetrics, jastates, jstate = jax_case(name)
    ranks = port_runs()[name]
    runs = [r["run"] for r in ranks]
    for r in range(ROUNDS):
        m, jm = runs[0]["metrics"][r], jmetrics[r]
        np.testing.assert_array_equal(m["base"]["mask"], jm["base"]["mask"])
        for f in COUNTS:
            np.testing.assert_array_equal(m[f], jm[f], err_msg=f)
        for f in BYTES:
            np.testing.assert_array_equal(
                np.asarray(m["base"][f], np.float32),
                np.asarray(jm["base"][f], np.float32), err_msg=f)
        for f in ("loss", "val_loss", "per_client_loss", "importance"):
            np.testing.assert_allclose(m["base"][f], jm["base"][f],
                                       atol=SHARED_BAND, rtol=0, err_msg=f)
        # pending / staleness are whole on every rank; the buffer is not
        for run in runs:
            for f in ("pending", "staleness"):
                np.testing.assert_array_equal(run["astates"][r][f],
                                              getattr(jastates[r], f),
                                              err_msg=f)
        buf = _cat([run["astates"][r]["buffer"] for run in runs])
        diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(
            _leaves(buf), _leaves(jastates[r].buffer))])
        # a parked delta is one client's own AdamW step, unaveraged: the
        # async port-vs-JAX bands of tests/test_torch_async.py
        assert diffs.max() <= 2 * LR * (r + 1), ("buffer", r, diffs.max())
        assert diffs.mean() <= 1e-7, ("buffer", r, diffs.mean())
        assert np.quantile(diffs, 0.999) <= 1e-6, ("buffer", r)
    # round 0 parks the slow half (shard 1), round 1 lands it
    assert [float(m["buffered"]) for m in runs[0]["metrics"]] == [4.0, 0.0]
    assert [float(m["arrived"]) for m in runs[0]["metrics"]] == [0.0, 4.0]
    stack = _cat([run["state"]["client_stack"] for run in runs])
    if name == "tiny":
        client = _max_diff(stack, jstate.client_stack)
        assert client <= CLIENT_BAND, client
    else:
        # OLMoE's flat rounds already differ by 2.8e-5 port vs JAX (AdamW's
        # first step on gradients near eps); the sharded rounds hold the
        # client band against their own flat rounds and the flat rounds'
        # port-vs-JAX bands against each other
        flat = port_flat_async(name)
        client = _max_diff(stack, flat["client_stack"])
        assert client <= CLIENT_BAND, client
        diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(
            _leaves(stack), _leaves(jstate.client_stack))])
        assert diffs.max() <= 2 * LR * ROUNDS, diffs.max()
        assert diffs.mean() <= 1e-7, diffs.mean()
        assert np.quantile(diffs, 0.999) <= 1e-6
        assert "router" in jstate.server_params["stack"][0]["mlp"]
    for f in ("server_params", "edge_stages"):
        d = _max_diff(runs[0]["state"][f], getattr(jstate, f))
        assert d <= SHARED_BAND, (f, d)


def test_deadline_inf_equals_the_sharded_sync_round_bit_for_bit():
    for rank in port_runs()["inf"]:
        a, s = rank["run"], rank["sync"]
        for ma, ms in zip(a["metrics"], s["metrics"]):
            for f, v in ms.items():
                np.testing.assert_array_equal(ma["base"][f], v, err_msg=f)
        x, y = jax.tree.leaves(a["state"]), jax.tree.leaves(s["state"])
        assert len(x) == len(y)
        for p, q in zip(x, y):
            np.testing.assert_array_equal(p, q)
        assert all(float(m["buffered"]) == 0.0 for m in a["metrics"])
