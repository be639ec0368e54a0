"""The flash training path through the model and the rounds, against the
live JAX package.

* ``loss_fn`` and its gradients with ``chunked``, ``flash``,
  ``triangular`` and ``banded`` on reduced Qwen2.5-32B (two global
  layers) and reduced Gemma-3-12B (a local layer at window 64, then a
  global one: period 2) at S 512, where the flash path walks two 256-key
  blocks and the band eight windows.  JAX's ``chunked``, ``flash`` and
  windowless ``banded`` are one computation (``_attn_flash``), so one JAX
  executable holds all three (``tests/test_torch_flash_train.py`` holds
  the routing).  Bands: the loss rel 1e-5, each gradient leaf within 1e-4
  of its max magnitude (fp32, the same ops in another order).
* Nested remat: with a period above 1, every layer of a super-block runs
  under its own checkpoint inside the span's; the loss and every gradient
  equal ``remat=False`` bit for bit, and the checkpoint regions are
  counted (forward and the span's recompute).
* One sync round (``launch/steps.py::make_train_step``, and
  ``make_round_fn`` without validation, equal to it) and two async rounds
  under ``stragglers`` at deadline 2 with ``impl="chunked"``, and
  ``make_val_step``, against the live jitted JAX functions on the TINY
  config of ``tests/test_torch_round.py``, the JAX draws injected, in that
  file's bands: masks exact, losses and importance rel 1e-5, stages max
  2 lr a round, mean 1e-7, 99.9th percentile 1e-6.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

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
from repro.launch import steps as jsteps
from repro.models import transformer as jtf
from repro_torch import sim
from repro_torch._bridge import params_from_jax, state_from_jax, state_to_numpy
from repro_torch.config import (AsyncRoundsConfig, ModelConfig, TrainConfig,
                                WSSLConfig, get_arch, reduced)
from repro_torch.core.async_round import init_async_state, make_async_round_fn
from repro_torch.core.round import make_round_fn
from repro_torch.launch import steps
from repro_torch.models import transformer as tf

S = 512
ARCHS = ("qwen2.5-32b", "gemma3-12b")
IMPLS = ("chunked", "flash", "triangular", "banded")
# the JAX computation each impl runs on each reduced config
JAX_IMPL = {("qwen2.5-32b", "flash"): "chunked",
            ("qwen2.5-32b", "banded"): "chunked",
            ("gemma3-12b", "flash"): "chunked"}

TINY_KW = dict(name="tiny-flash", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")
LR = 1e-3
N = 4


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# the model: loss_fn and its gradients
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _model(arch):
    jcfg, cfg = jax_reduced(jax_get_arch(arch)), reduced(get_arch(arch))
    jp = jax.jit(lambda key: jtf.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(3))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, cfg.vocab_size, size=(2, S)).astype(np.int32)
             for k in ("tokens", "labels")}
    return jcfg, cfg, jp, batch


@functools.lru_cache(maxsize=None)
def _jax_loss_grads(arch, impl):
    jcfg, _, jp, batch = _model(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jtf.loss_fn(p, jcfg, b, impl=impl, remat=False)))
    loss, grads = fn(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), _np_leaves(grads)


def _torch_loss_grads(arch, impl, remat):
    _, cfg, jp, batch = _model(arch)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                         dtype=torch.float32)
    flat, spec = tree_flatten(tp)
    leaves = [t.requires_grad_(True) for t in flat]
    loss = tf.loss_fn(tree_unflatten(leaves, spec), cfg,
                      {k: torch.as_tensor(v) for k, v in batch.items()},
                      impl=impl, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return loss, tree_unflatten(list(grads), spec)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", IMPLS)
def test_loss_and_grads_match_jax(arch, impl):
    jloss, jgrads = _jax_loss_grads(arch, JAX_IMPL.get((arch, impl), impl))
    loss, grads = _torch_loss_grads(arch, impl, remat=True)
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-5)
    got = [np.asarray(g, np.float32) for g in jax.tree.leaves(
        jax.tree.map(lambda t: t.numpy(), grads))]
    assert len(got) == len(jgrads)
    for g, jg in zip(got, jgrads):
        assert g.shape == jg.shape
        assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_nested_remat_changes_no_number(arch):
    """Gemma-3's super-block of a local and a global layer: the span's
    checkpoint and one a layer inside it (3 regions in the forward, the
    two layers' again in the span's recompute); Qwen's period 1: one
    checkpoint a super-block, none nested."""
    calls = []
    real = tf.checkpoint

    def counted(fn, *a, **kw):
        calls.append(fn.__name__)
        return real(fn, *a, **kw)

    plain, plain_grads = _torch_loss_grads(arch, "chunked", remat=False)
    with mock.patch.object(tf, "checkpoint", counted):
        _, cfg, _, _ = _model(arch)
        loss, grads = _torch_loss_grads(arch, "chunked", remat=True)
    nested = cfg.period > 1
    blocks = cfg.num_layers // cfg.period
    want = ["span_block"] * blocks
    if nested:
        want = ["span_block", "_apply_layer", "_apply_layer"] * blocks
        want += ["_apply_layer", "_apply_layer"] * blocks      # recompute
    assert calls == want, calls
    assert torch.equal(loss, plain)
    for g, p in zip(jax.tree.leaves(jax.tree.map(lambda t: t.numpy(), grads)),
                    jax.tree.leaves(jax.tree.map(lambda t: t.numpy(),
                                                 plain_grads))):
        np.testing.assert_array_equal(g, p)


# ---------------------------------------------------------------------------
# the rounds and the steps
# ---------------------------------------------------------------------------


def _batches(rounds):
    out = []
    for r in range(rounds):
        d = lm_batch(2 * N, 16, 64, seed=r)
        out.append({k: v.reshape(N, 2, 16) for k, v in d.items()})
    return out, lm_batch(4, 16, 64, seed=999)


def _jax_cfgs(deadline=None):
    akw = {} if deadline is None else dict(
        async_rounds=JAsyncRoundsConfig(deadline=deadline))
    return (JModelConfig(**TINY_KW),
            JWSSLConfig(num_clients=N, participation_fraction=0.5, **akw),
            JTrainConfig(**TRAIN_KW))


def _torch_cfgs(deadline=None):
    akw = {} if deadline is None else dict(
        async_rounds=AsyncRoundsConfig(deadline=deadline))
    return (ModelConfig(**TINY_KW),
            WSSLConfig(num_clients=N, participation_fraction=0.5, **akw),
            TrainConfig(**TRAIN_KW))


@functools.lru_cache(maxsize=None)
def _jax_steps():
    """JAX's train step (the sync round without validation) and val step,
    impl ``chunked``, one round from the initial state: the initial and
    final states (numpy), the Gumbel draw, the metrics, and the val
    step's losses and importance on the trained state."""
    jm, w, t = _jax_cfgs()
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    batches, val = _batches(1)
    _, rng_sel = jax.random.split(state.rng)
    gumbel = np.asarray(jax.random.gumbel(rng_sel, (N,)))
    train = jax.jit(jsteps.make_train_step(jm, w, t, impl="chunked"))
    state, m = train(state, jax.tree.map(jnp.asarray, batches[0]))
    val_fn = jax.jit(jsteps.make_val_step(jm, w, t, impl="chunked"))
    vstate, val_losses = val_fn(state, jax.tree.map(jnp.asarray, val))
    return (init, gumbel, jax.tree.map(np.asarray, m._asdict()),
            jax.tree.map(np.asarray, state), np.asarray(val_losses),
            np.asarray(vstate.importance))


def _check_stages(got, jstate, rounds):
    diffs = []
    for f in ("client_stack", "server_params"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b]
        diffs += [np.abs(x - y).ravel() for x, y in zip(a, b)]
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR * rounds, diffs.max()
    assert diffs.mean() <= 1e-7, diffs.mean()
    assert np.quantile(diffs, 0.999) <= 1e-6


def _check_metrics(m, jm):
    np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
    for f in ("loss", "per_client_loss", "val_loss", "importance"):
        np.testing.assert_allclose(getattr(m, f).numpy(), jm[f], rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    for f in ("bytes_up", "bytes_sync"):
        np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f])


def test_train_and_val_steps_match_jax():
    """The sync round with ``impl="chunked"``: the port's train step and
    ``make_round_fn`` (no validation set) against JAX's train step; then
    both val steps, every client, on the trained states."""
    init, gumbel, jm, jstate, jval, jimp = _jax_steps()
    cfg, w, t = _torch_cfgs()
    batches, val = _batches(1)
    batch = {k: torch.as_tensor(v) for k, v in batches[0].items()}
    runs = []
    for fn in (steps.make_train_step(cfg, w, t),
               lambda s, b, gumbel: make_round_fn(cfg, w, t)(
                   s, b, None, gumbel=gumbel)):
        state = state_from_jax(init, cfg, device="cpu")
        out, m = fn(state, batch, gumbel=_t(gumbel))
        assert out is state
        _check_metrics(m, jm)
        runs.append(state_to_numpy(state))
    for a, b in zip(jax.tree.leaves(runs[0]), jax.tree.leaves(runs[1])):
        np.testing.assert_array_equal(a, b)
    _check_stages(runs[0], jstate, rounds=1)
    state = state_from_jax(jstate, cfg, device="cpu")
    out, val_losses = steps.make_val_step(cfg, w, t)(
        state, {k: torch.as_tensor(v) for k, v in val.items()})
    assert out is state
    assert val_losses.shape == (N,)
    np.testing.assert_allclose(val_losses.numpy(), jval, rtol=1e-5)
    np.testing.assert_allclose(state.importance.numpy(), jimp, rtol=1e-5)


@functools.lru_cache(maxsize=None)
def _jax_async(rounds=2):
    jm, w, t = _jax_cfgs(deadline=2.0)
    rf = jax.jit(jar.make_async_round_fn(jm, w, t, impl="chunked"))
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    astate = jar.init_async_state(state)
    ap = jar.async_params(w.async_rounds, N)
    sp = jsim.scenario_params(jsim.get_scenario("stragglers"))
    batches, val = _batches(rounds)
    draws, metrics = [], []
    for r in range(rounds):
        _, rng_sel = jax.random.split(state.rng)
        draws.append((np.asarray(jax.random.gumbel(rng_sel, (N,))),
                      np.asarray(jax.random.uniform(
                          jax.random.fold_in(rng_sel, 0x0DD), (N,),
                          jnp.float32))))
        state, astate, m = rf(state, astate,
                              jax.tree.map(jnp.asarray, batches[r]),
                              jax.tree.map(jnp.asarray, val), sp, ap)
        metrics.append(jax.tree.map(np.asarray, dict(
            m._asdict(), base=m.base._asdict())))
    return init, draws, metrics, jax.tree.map(np.asarray, state)


def test_async_round_chunked_matches_jax():
    init, draws, jmetrics, jstate = _jax_async()
    cfg, w, t = _torch_cfgs(deadline=2.0)
    state = state_from_jax(init, cfg, device="cpu")
    astate = init_async_state(state)
    rf = make_async_round_fn(cfg, w, t)
    sp = sim.scenario_params(sim.get_scenario("stragglers"))
    batches, val = _batches(len(draws))
    tval = {k: torch.as_tensor(v) for k, v in val.items()}
    for r, ((gumbel, dropout), jm) in enumerate(zip(draws, jmetrics)):
        _, _, m = rf(state, astate, {k: torch.as_tensor(v)
                                     for k, v in batches[r].items()}, tval,
                     sp, gumbel=_t(gumbel),
                     fault_draws=sim.FaultDraws(dropout=_t(dropout)))
        _check_metrics(m.base, jm["base"])
        for f in ("on_time", "buffered", "arrived", "evicted"):
            assert float(getattr(m, f)) == float(jm[f]), f
    assert sum(float(jm["buffered"]) for jm in jmetrics) > 0
    _check_stages(state_to_numpy(state), jstate, rounds=len(draws))
