"""``TrainConfig.client_chunk`` in the port's rounds, the twins of
``tests/test_chunked_round.py`` and against JAX's chunked rounds.

* chunked == flat within the band of ``tests/test_chunked_round.py``
  (atol 1e-4; the chunks re-associate the shared stages' gradient sum and
  the loss, as JAX's scan does), sync and async (deadline 1, every client
  on time), chunks of 1, 2 and 4 of 8 clients, 2 rounds; masks and byte
  counts exact;
* ``client_chunk == N`` is one chunk, the flat reduction order: every
  state tensor and metric bit for bit;
* a chunk that does not divide the clients raises ``ValueError`` before
  any state moves, sync and async; the config rejects chunk 0;
* against JAX's ``_client_grads_chunked`` on the same inputs: a sync round
  with int8 activation compression, fed JAX's per-chunk draws
  (``fold_in(fold_in(key, tag), chunk)``, one ``(chunk * rows, d)`` draw
  per chunk and hop), and an async round at deadline 2 under
  ``stragglers``, 2 rounds each, chunk 2 of 4 clients: masks, counts and
  byte counts exact; losses, stages and moments within the bands of
  ``tests/test_torch_compress.py`` / ``tests/test_torch_async.py``.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_leaves

from _torch_threads import one_torch_thread  # noqa: F401
from repro import sim as jsim
from repro.config import AsyncRoundsConfig as JAsyncRoundsConfig
from repro.config import CompressionConfig as JCompressionConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.core import async_round as jar
from repro.core.round import init_state as jax_init_state
from repro.core.round import make_round_fn as jax_make_round_fn
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro_torch import sim
from repro_torch._bridge import state_from_jax, state_to_numpy
from repro_torch.config import (AsyncRoundsConfig, CompressionConfig,
                                ModelConfig, TrainConfig, WSSLConfig)
from repro_torch.core.async_round import (init_async_state,
                                          make_async_round_fn)
from repro_torch.core.round import init_state, make_round_fn

TINY_KW = dict(name="tiny-chunk", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")
LR = 1e-3
N = 8
W = dict(num_clients=N, participation_fraction=0.5, importance_temp=0.1,
         importance_ema=0.8)


def _t(a):
    return torch.as_tensor(np.array(a))


def _batches(n, rounds=2):
    val = {k: torch.as_tensor(v) for k, v in lm_batch(4, 16, 64,
                                                       seed=999).items()}
    out = []
    for r in range(rounds):
        d = lm_batch(n * 2, 16, 64, seed=r)
        out.append({k: torch.as_tensor(v).reshape(n, 2, 16)
                    for k, v in d.items()})
    return val, out


def _tensors(state):
    return tree_leaves((state.client_stack, state.server_params,
                        state.edge_stages, state.opt_client.m,
                        state.opt_client.v, state.opt_server.m,
                        state.opt_server.v, state.importance))


@functools.lru_cache(maxsize=None)
def run(kind, chunk):
    """Two port rounds, flat (``chunk=None``) or chunked, from one seed."""
    cfg = ModelConfig(**TINY_KW)
    w = WSSLConfig(**W, async_rounds=AsyncRoundsConfig(
        deadline=1.0 if kind == "async" else float("inf")))
    t = TrainConfig(client_chunk=chunk, **TRAIN_KW)
    state = init_state(torch.Generator().manual_seed(0), cfg, w, t,
                       device="cpu")
    val, batches = _batches(N)
    metrics = []
    if kind == "async":
        astate = init_async_state(state)
        rf = make_async_round_fn(cfg, w, t, impl="dense")
        for b in batches:
            _, _, m = rf(state, astate, b, val)
            metrics.append(m.base)
    else:
        rf = make_round_fn(cfg, w, t, impl="dense")
        for b in batches:
            metrics.append(rf(state, b, val)[1])
    return state, metrics


@pytest.mark.parametrize("kind", ["sync", "async"])
@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunked_matches_flat(kind, chunk):
    s_f, m_f = run(kind, None)
    s_c, m_c = run(kind, chunk)
    for a, b in zip(m_c, m_f):
        # decisions are chunk-independent: same selection, same bytes
        assert torch.equal(a.mask, b.mask)
        for f in ("bytes_up", "bytes_sync", "bytes_update_raw"):
            assert float(getattr(a, f)) == float(getattr(b, f)), f
        np.testing.assert_allclose(a.val_loss.numpy(), b.val_loss.numpy(),
                                   atol=1e-4)
        np.testing.assert_allclose(float(a.loss), float(b.loss), atol=1e-4)
    for a, b in zip(_tensors(s_c), _tensors(s_f)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4)


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_single_chunk_is_bit_for_bit(kind):
    """chunk == N: one chunk over every client, the flat reduction order:
    every state tensor and metric equal bit for bit."""
    s_f, m_f = run(kind, None)
    s_c, m_c = run(kind, N)
    for a, b in zip(_tensors(s_c), _tensors(s_f)):
        assert torch.equal(a, b)
    for a, b in zip(m_c, m_f):
        for f in a._fields:
            assert torch.equal(torch.as_tensor(getattr(a, f)),
                               torch.as_tensor(getattr(b, f))), f


@pytest.mark.parametrize("kind", ["sync", "async"])
def test_chunk_must_divide_clients(kind):
    cfg = ModelConfig(**TINY_KW)
    w = WSSLConfig(**W)
    t = TrainConfig(client_chunk=3, **TRAIN_KW)      # 3 does not divide 8
    state = init_state(torch.Generator().manual_seed(0), cfg, w, t,
                       device="cpu")
    before = [x.clone() for x in _tensors(state)]
    val, batches = _batches(N, rounds=1)
    with pytest.raises(ValueError, match="divide"):
        if kind == "async":
            make_async_round_fn(cfg, w, t, impl="dense")(
                state, init_async_state(state), batches[0], val)
        else:
            make_round_fn(cfg, w, t, impl="dense")(state, batches[0], val)
    for a, b in zip(before, _tensors(state)):
        assert torch.equal(a, b)
    assert int(state.round_index) == 0


def test_config_validation():
    with pytest.raises(ValueError):
        TrainConfig(client_chunk=0)
    with pytest.raises(ValueError):
        TrainConfig(fused_adam=True, optimizer="sgd")
    TrainConfig(client_chunk=4, fused_adam=True)


# ---------------------------------------------------------------------------
# Against JAX's chunked rounds
# ---------------------------------------------------------------------------

JN, CHUNK = 4, 2
JAX_CASES = {
    "sync-int8-acts": dict(scheme="int8", activations=True),
    "async-stragglers": dict(deadline=2.0, scenario="stragglers"),
}


def _jax_uniform(key):
    def draw(tag, leaf, shape):
        k = jax.random.fold_in(key, tag)
        if leaf is not None:
            k = jax.random.fold_in(k, leaf)
        return _t(jax.random.uniform(k, shape, jnp.float32))
    return draw


def _configs(mod, case, chunk):
    kw = JAX_CASES[case]
    return (mod["M"](**TINY_KW),
            mod["W"](num_clients=JN, participation_fraction=0.5,
                     compression=mod["C"](
                         scheme=kw.get("scheme", "none"),
                         activations=kw.get("activations", False)),
                     async_rounds=mod["A"](
                         deadline=kw.get("deadline", float("inf")))),
            mod["T"](client_chunk=chunk, **TRAIN_KW))


JMOD = dict(M=JModelConfig, W=JWSSLConfig, C=JCompressionConfig,
            T=JTrainConfig, A=JAsyncRoundsConfig)
TMOD = dict(M=ModelConfig, W=WSSLConfig, C=CompressionConfig, T=TrainConfig,
            A=AsyncRoundsConfig)


@functools.lru_cache(maxsize=None)
def jax_chunked(case):
    kw = JAX_CASES[case]
    jm, w, t = _configs(JMOD, case, CHUNK)
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    is_async = "deadline" in kw
    sp = (jsim.scenario_params(jsim.get_scenario(kw["scenario"]))
          if "scenario" in kw else None)
    val, batches = _batches(JN)
    jval = {k: jnp.asarray(v.numpy()) for k, v in val.items()}
    draws, metrics = [], []
    with mock.patch.multiple(jax_ops,
                             quantize_stochastic=jax_ref.quantize_stochastic_2d,
                             dequantize=jax_ref.dequantize_2d):
        if is_async:
            rf = jax.jit(jar.make_async_round_fn(jm, w, t, impl="dense"))
            astate = jar.init_async_state(state)
            ap = jar.async_params(w.async_rounds, JN)
        else:
            rf = jax.jit(jax_make_round_fn(jm, w, t, impl="dense"))
        for b in batches:
            _, rng_sel = jax.random.split(state.rng)
            key = jax.random.fold_in(rng_sel, 0x0DD)
            draws.append((np.asarray(jax.random.gumbel(rng_sel, (JN,))),
                          np.asarray(jax.random.uniform(key, (JN,),
                                                        jnp.float32)),
                          rng_sel))
            jb = {k: jnp.asarray(v.numpy()) for k, v in b.items()}
            if is_async:
                state, astate, m = rf(state, astate, jb, jval, sp, ap)
                metrics.append(jax.tree.map(np.asarray, dict(
                    m.base._asdict(), pending=astate.pending,
                    buffered=m.buffered)))
            else:
                state, m = rf(state, jb, jval, sp)
                metrics.append(jax.tree.map(np.asarray, m._asdict()))
    return init, draws, metrics, jax.tree.map(np.asarray, state)


@pytest.mark.parametrize("case", list(JAX_CASES))
def test_chunked_round_matches_live_jax(case):
    kw = JAX_CASES[case]
    init, draws, jmetrics, jstate = jax_chunked(case)
    cfg, w, t = _configs(TMOD, case, CHUNK)
    is_async = "deadline" in kw
    sp = (sim.scenario_params(sim.get_scenario(kw["scenario"]))
          if "scenario" in kw else None)
    state = state_from_jax(init, cfg, device="cpu")
    val, batches = _batches(JN)
    if is_async:
        astate = init_async_state(state)
        rf = make_async_round_fn(cfg, w, t, impl="dense")
    else:
        rf = make_round_fn(cfg, w, t, impl="dense")
    calls = []

    def spy(draw):
        def wrapped(tag, leaf, shape):
            calls.append((tag, leaf, shape))
            return draw(tag, leaf, shape)
        return wrapped

    for (gumbel, dropout, rng_sel), b, jm in zip(draws, batches, jmetrics):
        kwargs = dict(gumbel=_t(gumbel), comp_uniform=spy(_jax_uniform(
            rng_sel)), fault_draws=sim.FaultDraws(dropout=_t(dropout)))
        if is_async:
            _, _, am = rf(state, astate, b, val, sp, **kwargs)
            m = am.base
            np.testing.assert_array_equal(astate.pending.numpy(),
                                          jm["pending"])
            assert float(am.buffered) == float(jm["buffered"])
        else:
            _, m = rf(state, b, val, sp, **kwargs)
        np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
        for f in ("bytes_up", "bytes_per_hop", "bytes_sync",
                  "bytes_update_raw", "bytes_act_raw", "bytes_act_comp"):
            np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                          err_msg=f)
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m, f).numpy(), jm[f],
                                       rtol=1e-3, atol=1e-7, err_msg=f)
    if kw.get("activations"):
        # one draw per chunk and hop crossing, the chunk index as `leaf`
        acts = [(tag, leaf, shape) for tag, leaf, shape in calls
                if tag != 0xC09]
        assert {leaf for _, leaf, _ in acts} == {0, 1}
        assert {shape for _, _, shape in acts} == {(CHUNK * 32, 32)}
    got = state_to_numpy(state)
    for f in ("client_stack", "server_params"):
        a = [np.asarray(x, np.float32) for x in jax.tree.leaves(got[f])]
        b = [np.asarray(x, np.float32) for x in jax.tree.leaves(
            getattr(jstate, f))]
        diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
        assert diffs.max() <= 2 * LR * 2, (f, diffs.max())
        assert diffs.mean() <= 1e-5, (f, diffs.mean())
        assert (diffs > 1e-4).mean() <= 5e-3, f
    for x, y in zip(jax.tree.leaves(got["opt_server"]["m"]),
                    jax.tree.leaves(jstate.opt_server.m)):
        np.testing.assert_allclose(x, np.asarray(y), atol=1e-6)
