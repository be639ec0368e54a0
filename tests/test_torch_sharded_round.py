"""The port's client-sharded synchronous round (``make_sharded_round_fn``
over gloo ranks on the CPU) against JAX's round body under ``vmap`` and
against the port's own flat round.

* Cases, on the TINY config of ``tests/test_sharded_round.py`` (2 layers,
  width 32, 8 clients, participation 0.5, 2 rounds, ``impl="chunked"``):
  importance at S 2 and S 4, trimmed_mean at S 2 (the all_gather
  fallback), int8 at S 2 with JAX's per-shard compression draws injected.
  The port runs on ``spawn_client_shards`` ranks (gloo, one intra-op
  thread, rendezvous and join within 60 s), from JAX's initial state with
  JAX's Gumbel draws.
* JAX's reference is ``wssl_round(..., shard_ctx=ShardCtx(...))`` under
  ``jax.jit(jax.vmap(..., axis_name="d"))`` (``tests/_jax_shards.py``):
  JAX's ``make_sharded_round_fn`` passes ``auto=`` to ``shard_map``, which
  the installed jax rejects.  One executable a case, built once a module.
* Bands, those of ``tests/test_sharded_round.py``: masks exact; the client
  stack 1e-5; the server stage, validation losses, per-client losses and
  the loss 5e-3; ``bytes_cross_shard`` / ``bytes_intra_shard`` and every
  other byte count exact.  The ranks' replicated outputs agree bit for
  bit.  The same bands hold the sharded round against the port's flat
  round on the same draws (int8: the shards' draws, concatenated, are the
  flat round's).
* S = 1 (one gloo rank, in process) equals the flat round bit for bit:
  state, moments and metrics.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _jax_shards as js
import _torch_shards as ts
from _torch_threads import one_torch_thread  # noqa: F401
from repro.compress import compression_params as jax_compression_params
from repro.config import CompressionConfig as JCompressionConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.core.round import init_state as jax_init_state
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch._bridge import state_from_jax, state_to_numpy
from repro_torch.config import (CompressionConfig, ModelConfig, TrainConfig,
                                WSSLConfig)
from repro_torch.core.round import make_round_fn, make_sharded_round_fn
from repro_torch.launch.mesh import client_process_group, spawn_client_shards

TINY_KW = dict(name="tiny-shard", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")
N, ROUNDS, IMPL = 8, 2, "chunked"
# name -> (rule, shards, compression scheme)
CASES = {"importance-2": ("importance", 2, "none"),
         "importance-4": ("importance", 4, "none"),
         "trimmed_mean-2": ("trimmed_mean", 2, "none"),
         "int8-2": ("importance", 2, "int8")}
CLIENT_BAND, SHARED_BAND = 1e-5, 5e-3
BYTES = ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
         "bytes_update_raw", "bytes_update_comp", "bytes_act_raw",
         "bytes_act_comp")


def _wssl_kw(rule, scheme):
    return dict(num_clients=N, participation_fraction=0.5,
                importance_temp=0.1, importance_ema=0.8, aggregation=rule)


def _configs(name):
    rule, _, scheme = CASES[name]
    jax_cfgs = (JModelConfig(**TINY_KW),
                JWSSLConfig(compression=JCompressionConfig(scheme=scheme),
                            **_wssl_kw(rule, scheme)),
                JTrainConfig(**TRAIN_KW))
    port_cfgs = (ModelConfig(**TINY_KW),
                 WSSLConfig(compression=CompressionConfig(scheme=scheme),
                            **_wssl_kw(rule, scheme)),
                 TrainConfig(**TRAIN_KW))
    return jax_cfgs, port_cfgs


def _batches():
    out = []
    for r in range(ROUNDS):
        d = lm_batch(N * 2, 16, TINY_KW["vocab_size"], seed=r)
        out.append({k: v.reshape(N, 2, 16) for k, v in d.items()})
    return out, lm_batch(4, 16, TINY_KW["vocab_size"], seed=999)


@functools.lru_cache(maxsize=None)
def jax_case(name):
    """JAX under vmap: the initial state, each round's injected draws and
    metrics (numpy), and the final state (numpy, merged to (N, ...))."""
    (jm, w, t), _ = _configs(name)
    _, shards, scheme = CASES[name]
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    axes = js.state_in_axes(jm, w, t)
    comp_p = jax_compression_params(w.compression) if scheme != "none" \
        else None
    batches, val = _batches()
    jval = {k: jnp.asarray(v) for k, v in val.items()}
    st = js.split(state, axes, shards)
    rounds, metrics = [], []
    with mock.patch.multiple(jax_ops,
                             quantize_stochastic=jax_ref.quantize_stochastic_2d,
                             dequantize=jax_ref.dequantize_2d,
                             topk_mask=jax_ref.topk_mask_2d):
        fn = js.sharded_round(jm, w, t, shards, IMPL)
        for r in range(ROUNDS):
            rd = {"batch": batches[r], "gumbel": js.gumbel(st, N)}
            if scheme != "none":
                rd["comp"] = js.update_draws(
                    st, jax.tree.leaves(init.client_stack), shards)
            rounds.append(rd)
            jb = {k: jnp.asarray(v).reshape((shards, N // shards)
                                            + v.shape[1:])
                  for k, v in batches[r].items()}
            out, m = fn(st, jb, jval, None, None, comp_p)
            st = js.take(out, axes)
            metrics.append(js.metrics_numpy(m))
    return init, rounds, val, metrics, js.merge(st, axes)


def _case(name):
    init, rounds, val, _, _ = jax_case(name)
    _, cfgs = _configs(name)
    return {"cfg": cfgs, "impl": IMPL, "init": ts.jax_namespace(init),
            "rounds": rounds, "val": val, "scenario": None, "async_p": None}


@functools.lru_cache(maxsize=None)
def _port_runs(shards):
    """Every case of ``shards`` shards in one spawn of gloo ranks (a spawn
    costs seconds of imports): case -> each rank's output."""
    names = [k for k, v in CASES.items() if v[1] == shards]
    ranks = spawn_client_shards(ts.run_cases, shards,
                                [_case(k) for k in names], device="cpu",
                                backend="gloo", timeout=60.0, threads=1)
    return {k: [r[i] for r in ranks] for i, k in enumerate(names)}


def port_case(name):
    """The port's sharded round on gloo ranks: each rank's output."""
    return _port_runs(CASES[name][1])[name]


def _flat_draws(rd):
    """The flat round's draws of a round: the shards' update draws
    concatenated (leaf -> (N, m))."""
    kw = {"gumbel": torch.as_tensor(rd["gumbel"])}
    if "comp" in rd:
        comp = {i: u.reshape((-1,) + u.shape[2:])
                for i, u in rd["comp"].items()}
        kw["comp_uniform"] = lambda tag, leaf, shape: torch.as_tensor(
            comp[leaf])
    return kw


@functools.lru_cache(maxsize=None)
def flat_case(name):
    """The port's flat round on the same initial state and draws."""
    init, rounds, val, _, _ = jax_case(name)
    _, (cfg, w, t) = _configs(name)
    state = state_from_jax(ts.jax_namespace(init), cfg, device="cpu")
    rf = make_round_fn(cfg, w, t, impl=IMPL)
    tval = {k: torch.as_tensor(v) for k, v in val.items()}
    metrics = []
    for rd in rounds:
        batch = {k: torch.as_tensor(v) for k, v in rd["batch"].items()}
        _, m = rf(state, batch, tval, **_flat_draws(rd))
        metrics.append(ts.metrics_numpy(m))
    return metrics, state_to_numpy(state)


def _leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def merged_state(ranks):
    """The ranks' local states as one: client-axis leaves concatenated in
    rank order, the rest from rank 0."""
    states = [r["run"]["state"] for r in ranks]
    cat = lambda *xs: np.concatenate(xs, axis=0)
    out = dict(states[0])
    for f in ("client_stack", "ef_residual"):
        out[f] = jax.tree.map(cat, *[s[f] for s in states])
    out["opt_client"] = dict(states[0]["opt_client"])
    for k in ("m", "v"):
        out["opt_client"][k] = jax.tree.map(
            cat, *[s["opt_client"][k] for s in states])
    return out


def _max_diff(a, b):
    return max((float(np.abs(x - y).max()) for x, y in
                zip(_leaves(a), _leaves(b))), default=0.0)


def check_round(got_metrics, got_state, want_metrics, want_state, *,
                exact_bytes=True):
    """The sharded bands: masks exact, client stack 1e-5, the shared
    stages, val / per-client losses and the loss 5e-3, bytes exact."""
    for r, (m, jm) in enumerate(zip(got_metrics, want_metrics)):
        np.testing.assert_array_equal(m["mask"], jm["mask"], err_msg=r)
        for f in ("loss", "val_loss", "per_client_loss", "importance"):
            np.testing.assert_allclose(m[f], jm[f], atol=SHARED_BAND,
                                       rtol=0, err_msg=f"{f} round {r}")
        if exact_bytes:
            for f in BYTES + ("bytes_cross_shard", "bytes_intra_shard"):
                np.testing.assert_array_equal(np.asarray(m[f], np.float32),
                                              np.asarray(jm[f], np.float32),
                                              err_msg=f)
    client = _max_diff(got_state["client_stack"], want_state.client_stack
                       if hasattr(want_state, "client_stack")
                       else want_state["client_stack"])
    assert client <= CLIENT_BAND, client
    for f in ("server_params", "edge_stages"):
        want = (getattr(want_state, f) if hasattr(want_state, f)
                else want_state[f])
        d = _max_diff(got_state[f], want)
        assert d <= SHARED_BAND, (f, d)
    return client


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_round_matches_jax_under_vmap(name):
    _, _, _, jmetrics, jstate = jax_case(name)
    ranks = port_case(name)
    _, shards, _ = CASES[name]
    assert [r["index"] for r in ranks] == list(range(shards))
    assert {r["backend"] for r in ranks} == {"gloo"}
    # every rank holds the same replicated outputs
    for other in ranks[1:]:
        for m0, m1 in zip(ranks[0]["run"]["metrics"],
                          other["run"]["metrics"]):
            for f in ("loss", "mask", "val_loss", "importance",
                      "per_client_loss", "bytes_cross_shard"):
                np.testing.assert_array_equal(m0[f], m1[f], err_msg=f)
        for f in ("server_params", "importance"):
            for a, b in zip(_leaves(ranks[0]["run"]["state"][f]),
                            _leaves(other["run"]["state"][f])):
                np.testing.assert_array_equal(a, b)
    got = merged_state(ranks)
    check_round(ranks[0]["run"]["metrics"], got, jmetrics, jstate)
    assert float(ranks[0]["run"]["metrics"][-1]["bytes_cross_shard"]) > 0
    if CASES[name][2] != "none":
        for a, b in zip(_leaves(got["ef_residual"]),
                        _leaves(jstate.ef_residual)):
            np.testing.assert_allclose(a, b, atol=CLIENT_BAND, rtol=0)


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_round_matches_port_flat_round(name):
    metrics, state = flat_case(name)
    ranks = port_case(name)
    check_round(ranks[0]["run"]["metrics"], merged_state(ranks), metrics,
                state, exact_bytes=False)
    for m, fm in zip(ranks[0]["run"]["metrics"], metrics):
        for f in BYTES:
            np.testing.assert_array_equal(m[f], fm[f], err_msg=f)


@pytest.mark.parametrize("name", ["importance-2", "int8-2"])
def test_one_shard_is_the_flat_round_bit_for_bit(name):
    metrics, state = flat_case(name)
    case = _case(name)
    # the shards' draws of a two-shard case, concatenated: one shard's
    for rd in case["rounds"]:
        if "comp" in rd:
            rd["comp"] = {i: u.reshape((1, -1) + u.shape[2:])
                          for i, u in rd["comp"].items()}
    with client_process_group(1, 0, backend="gloo") as group:
        out = ts.run_case(group, torch.device("cpu"), case)
    got = out["run"]
    for m, fm in zip(got["metrics"], metrics):
        for f, v in fm.items():
            if f in ("bytes_cross_shard", "bytes_intra_shard"):
                continue                    # 0.0 when flat
            np.testing.assert_array_equal(m[f], v, err_msg=f)
    a, b = jax.tree.leaves(got["state"]), jax.tree.leaves(state)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_uneven_clients_rejected():
    from repro_torch.launch.mesh import ClientGroup
    _, (cfg, w, t) = _configs("importance-2")
    w6 = WSSLConfig(**dict(_wssl_kw("importance", "none"), num_clients=6))
    group = ClientGroup(group=None, num_shards=4, index=0, backend="gloo")
    with pytest.raises(ValueError, match="divide evenly"):
        make_sharded_round_fn(cfg, w6, t, group)
