"""The port's split protocol, training forward and synchronous WSSL round
against the JAX package on the same inputs.

* ``core/split.py``: the relayed pipeline grads equal end-to-end autograd
  for 1, 2 and 3 cuts (atol 1e-6, fp32, the same ops in another order).
* ``models/transformer.py``: forward logits, the server loss and its
  grads against JAX on TINY (fp32, atol 1e-5); ``remat`` changes nothing.
* ``core/round.py``: two rounds of ``make_round_fn`` on the TINY and
  TINY3 configs of ``tests/test_round_regression.py`` against the live
  JAX ``make_round_fn(..., impl="dense")``, the JAX Gumbel draws
  injected.  Masks and byte counts are exact; loss, val loss, per-client
  loss and importance within rel 1e-5.  Params: AdamW's first step is
  +-lr wherever a gradient's sign rides on rounding noise, so the max
  band is 2 lr per round (4e-3 at lr 1e-3, two rounds); the bulk is held
  to a mean |diff| of 1e-7 and a 99.9th percentile of 1e-6 (measured: max
  8.1e-6, mean 1.9e-8, 99.9th percentile 1.2e-7 on TINY; max 6.9e-7, mean
  4.4e-9 on TINY3 — no sign flipped).  Moments: atol 1e-6.
* The same two rounds compressed (top-k at rate 0.05, int8, int4; update
  path alone and with the split-hop activations), the JAX compression
  draws injected too and the JAX ops patched to their oracles for the
  test; int8 and int4 run one JAX executable, as the JAX package builds
  them, each with its own levels and bits (``comp_p``).  Masks and every
  byte count are exact.  Rounding differences
  between the client loop and ``vmap`` can flip a code by one step or a
  top-k membership at the threshold, and one flipped activation element
  moves every gradient behind it a little.  Bands: losses, val losses and
  importance rel 1e-3 (measured max 9.8e-5, multihop int8 with
  activations, where a hop's pre-floor value sat 7.6e-6 from an integer;
  1.5e-5 with updates alone); stages and residuals max |diff| 2 lr per
  round, the size of one flip (a top-k coordinate is at most |delta| +
  |e|, a quant step that over the levels), mean |diff| 1e-5 (measured
  max 1.5e-6) and at most 0.5% of coordinates off by more than 1e-4
  (measured max 0.11%).
"""

import functools
import json
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map,
                                tree_unflatten)

from _torch_threads import one_torch_thread  # noqa: F401
from repro.compress import compression_params as jax_compression_params
from repro.config import CompressionConfig as JCompressionConfig
from repro.config import ModelConfig as JModelConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.core.round import abstract_state as jax_abstract_state
from repro.core.round import init_state as jax_init_state
from repro.core.round import make_round_fn as jax_make_round_fn
from repro.core.split import end_to_end_grads_n as jax_e2e_n
from repro.data.synthetic import lm_batch as jax_lm_batch
from repro.kernels import ops as jax_ops
from repro.kernels import ref as jax_ref
from repro.models import transformer as jtf
from repro_torch._bridge import params_from_jax, state_from_jax, state_to_numpy
from repro_torch.config import (CompressionConfig, ModelConfig, TrainConfig,
                                WSSLConfig, get_arch, reduced)
from repro_torch.core.round import ShardCtx, init_state, make_round_fn
from repro_torch.core.split import (end_to_end_grads, end_to_end_grads_n,
                                    pipeline_grads, split_grads)
from repro_torch.data.synthetic import lm_batch
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as tf

TINY_KW = dict(name="tiny-golden", num_layers=2, d_model=32, num_heads=2,
               num_kv_heads=2, d_ff=64, vocab_size=64, dtype="float32",
               param_dtype="float32")
CONFIGS = {"single": (TINY_KW, {}),
           "multihop": (dict(TINY_KW, name="tiny-golden-3stage",
                             num_layers=3),
                        {"split_layers": (1, 2), "hop_replicas": 2})}
TRAIN_KW = dict(remat=False, learning_rate=1e-3, warmup_steps=0,
                schedule="constant")
LR = 1e-3


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


# ---------------------------------------------------------------------------
# core/split.py
# ---------------------------------------------------------------------------


def _mlp_pipeline(num_cuts, seed):
    rng = np.random.default_rng(seed)
    x = torch.tensor(rng.normal(size=(5, 4)), dtype=torch.float32)
    y = torch.tensor(rng.normal(size=(5,)), dtype=torch.float32)
    dims = [4] + [int(d) for d in rng.integers(2, 9, size=num_cuts)]
    params = [{"w": torch.tensor(rng.normal(size=(a, b)) / np.sqrt(a),
                                 dtype=torch.float32)}
              for a, b in zip(dims[:-1], dims[1:])]
    params.append({"w": torch.tensor(rng.normal(size=(dims[-1], 6)),
                                     dtype=torch.float32),
                   "h": torch.tensor(rng.normal(size=(6, 1)),
                                     dtype=torch.float32)})
    fns = [lambda p: torch.tanh(x @ p["w"])]
    fns += [lambda p, a: torch.tanh(a @ p["w"])] * (num_cuts - 1)
    fns.append(lambda p, a: ((torch.tanh(a @ p["w"]) @ p["h"])[:, 0] - y)
               .square().mean())
    return fns, params


@pytest.mark.parametrize("num_cuts", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pipeline_equals_end_to_end_mlp(num_cuts, seed):
    fns, params = _mlp_pipeline(num_cuts, seed)
    res = pipeline_grads(fns, params)
    loss, grads = end_to_end_grads_n(fns, params)
    assert len(res.grads) == num_cuts + 1 == len(res.activations) + 1
    np.testing.assert_allclose(float(res.loss), float(loss), rtol=1e-6)
    for a, b in zip(tree_leaves(res.grads), tree_leaves(grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-5)
    for act, up, down in zip(res.activations, res.bytes_up, res.bytes_down):
        assert up == down == act.numel() * 4
    if num_cuts == 1:
        two = split_grads(fns[0], fns[1], params[0], params[1])
        _, gc, gs = end_to_end_grads(fns[0], fns[1], params[0], params[1])
        np.testing.assert_allclose(two.grads_client["w"].numpy(),
                                   gc["w"].numpy(), atol=1e-6)
        np.testing.assert_allclose(two.grads_server["h"].numpy(),
                                   gs["h"].numpy(), atol=1e-6)


@functools.lru_cache(maxsize=None)
def _tiny(num_layers=4, seed=0):
    kw = dict(TINY_KW, num_layers=num_layers)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = jax.jit(lambda k: jtf.init_params(k, jcfg)[0])(
        jax.random.PRNGKey(seed))
    return jcfg, cfg, jp


def _tokens(b, s, vocab, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, vocab, size=(b, s)).astype(np.int32),
            rng.integers(0, vocab, size=(b, s)).astype(np.int32))


@pytest.mark.parametrize("cuts", [(1,), (1, 2), (1, 2, 3)])
def test_pipeline_equals_end_to_end_transformer(cuts):
    """Relayed stage grads equal end-to-end grads in the port, and equal
    the JAX package's end-to-end grads of the same stages."""
    jcfg, cfg, jp = _tiny()
    toks, labs = _tokens(2, 12, cfg.vocab_size, seed=len(cuts))
    jstages = jtf.partition_params(jp, jcfg, cuts)
    stages = [params_from_jax(jax.tree.map(np.asarray, s), cfg, device="cpu",
                              dtype=torch.float32) for s in jstages]

    def torch_fns(t, y):
        fns = [lambda p: tf.client_forward(p, cfg, t, remat=False)]
        fns += [lambda p, a, j=j: tf.stage_forward(p, cfg, a, j, remat=False)
                for j in range(1, len(cuts))]
        fns.append(lambda p, a: tf.server_loss(p, cfg, a, y, remat=False)[0])
        return fns

    fns = torch_fns(torch.as_tensor(toks), torch.as_tensor(labs))
    res = pipeline_grads(fns, stages)
    loss, grads = end_to_end_grads_n(fns, stages)
    jt, jy = jnp.asarray(toks), jnp.asarray(labs)
    jfns = [lambda p: jtf.client_forward(p, jcfg, jt, impl="dense",
                                         remat=False)]
    jfns += [lambda p, a, j=j: jtf.stage_forward(p, jcfg, a, j, impl="dense",
                                                 remat=False)
             for j in range(1, len(cuts))]
    jfns.append(lambda p, a: jtf.server_loss(p, jcfg, a, jy, impl="dense",
                                             remat=False)[0])
    jloss, jgrads = jax.jit(lambda st: jax_e2e_n(jfns, st))(jstages)
    np.testing.assert_allclose(float(res.loss), float(loss), rtol=1e-6)
    np.testing.assert_allclose(float(res.loss), float(jloss), rtol=1e-5)
    for a, b in zip(tree_leaves(res.grads), tree_leaves(grads)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)
    for a, b in zip(jax.tree.leaves(state_tree(res.grads)),
                    jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)


def state_tree(tree):
    """A port tree as numpy (tuples to lists, to line up with JAX's)."""
    if isinstance(tree, (list, tuple)):
        return [state_tree(t) for t in tree]
    if isinstance(tree, dict):
        return {k: state_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


# ---------------------------------------------------------------------------
# models/transformer.py, the training half
# ---------------------------------------------------------------------------


def test_forward_server_loss_and_grads_match_jax():
    jcfg, cfg, jp = _tiny(num_layers=2)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                         dtype=torch.float32)
    toks, labs = _tokens(2, 16, cfg.vocab_size, seed=0)
    jl, _ = jax.jit(lambda p, t: jtf.forward(p, jcfg, t, impl="dense"))(
        jp, jnp.asarray(toks))
    tl, aux = tf.forward(tp, cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl), atol=1e-5)
    assert float(aux) == 0.0
    jloss = jax.jit(lambda p, b: jtf.loss_fn(p, jcfg, b, impl="dense"))(
        jp, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labs)})
    tloss = tf.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks),
                                 "labels": torch.as_tensor(labs)})
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-6)

    js = jtf.partition_params(jp, jcfg, (1,))
    ts = tf.partition_params(tp, cfg, (1,))
    a = jax.jit(lambda p, t: jtf.client_forward(p, jcfg, t, impl="dense"))(
        js[0], jnp.asarray(toks))
    fn = lambda sp, x: jtf.server_loss(sp, jcfg, x, jnp.asarray(labs),
                                       impl="dense", xent_chunk=4)[0]
    jval, (jgs, jga) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(
        js[1], a)
    ta = tf.client_forward(ts[0], cfg, torch.as_tensor(toks))
    np.testing.assert_allclose(ta.detach().numpy(), np.asarray(a), atol=1e-5)
    x = ta.detach().requires_grad_(True)
    flat, spec = tree_flatten(ts[1])
    leaves = [t.detach().requires_grad_(True) for t in flat]
    tval, _ = tf.server_loss(tree_unflatten(leaves, spec), cfg, x,
                             torch.as_tensor(labs), xent_chunk=4)
    grads = torch.autograd.grad(tval, [x] + leaves)
    np.testing.assert_allclose(float(tval), float(jval), rtol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jga), atol=1e-6)
    gtree = state_tree(tree_unflatten(list(grads[1:]), spec))
    for g, jg in zip(jax.tree.leaves(gtree), jax.tree.leaves(jgs)):
        np.testing.assert_allclose(g, np.asarray(jg), atol=1e-5)


def test_remat_changes_nothing():
    _, cfg, jp = _tiny(num_layers=4)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu",
                         dtype=torch.float32)
    toks, labs = _tokens(2, 8, cfg.vocab_size, seed=3)
    out = []
    for remat, span in ((False, 1), (True, 1), (True, 2), (True, 4)):
        flat, spec = tree_flatten(tp)
        leaves = [t.detach().requires_grad_(True) for t in flat]
        p = tree_unflatten(leaves, spec)
        stages = tf.partition_params(p, cfg, (2,))
        a = tf.client_forward(stages[0], cfg, torch.as_tensor(toks),
                              remat=remat, remat_span=span)
        loss, _ = tf.server_loss(stages[1], cfg, a, torch.as_tensor(labs),
                                 remat=remat, remat_span=span)
        out.append([loss] + list(torch.autograd.grad(loss, leaves)))
    for other in out[1:]:
        for a, b in zip(out[0], other):
            assert torch.equal(a, b)


def test_partition_copies_and_join_roundtrip():
    cfg = reduced(get_arch("gemma-2b")).replace(num_layers=4)
    assert cfg.tie_embeddings
    p = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                       dtype=torch.float32)
    stages = tf.partition_params(p, cfg, (1, 3))
    server_tok, client_tok = stages[-1]["embed"]["tok"], stages[0]["embed"]["tok"]
    assert torch.equal(server_tok, client_tok)
    assert server_tok.data_ptr() != client_tok.data_ptr()
    for st in stages:
        for leaf in tree_leaves(st["stack"]):
            assert leaf._base is None        # a copy, not a view of p
    assert [len(s["stack"][0]["mlp"]["wg"]) for s in stages] == [1, 2, 1]
    joined = tf.join_stages(stages, cfg)
    for a, b in zip(tree_leaves(joined), tree_leaves(
            {k: v for k, v in p.items()})):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="increasing"):
        tf.partition_params(p, cfg, (2, 1))


def test_training_attention_impls():
    _, cfg, _ = _tiny()
    from repro_torch.models import attention
    for impl in ("dense", "chunked", "flash", "banded", "triangular"):
        attention.check_train_impl(impl)
    with pytest.raises(NotImplementedError, match="flash"):
        attention.check_train_impl("kernel")


# ---------------------------------------------------------------------------
# core/round.py against the live JAX round
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_two_rounds(name):
    """JAX: the initial state (numpy), the Gumbel draw and metrics of each
    round, and the final state (numpy)."""
    mkw, wkw = CONFIGS[name]
    jm = JModelConfig(**mkw)
    w = JWSSLConfig(num_clients=4, participation_fraction=0.5, **wkw)
    t = JTrainConfig(**TRAIN_KW)
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    rf = jax_make_round_fn(jm, w, t, impl="dense", donate=True)
    vd = jax_lm_batch(4, 16, jm.vocab_size, seed=999)
    val = {k: jnp.asarray(v) for k, v in vd.items()}
    gumbels, metrics = [], []
    for r in range(2):
        _, rng_sel = jax.random.split(state.rng)
        gumbels.append(np.asarray(jax.random.gumbel(rng_sel, (4,))))
        d = jax_lm_batch(8, 16, jm.vocab_size, seed=r)
        batch = {k: jnp.asarray(v).reshape(4, 2, 16) for k, v in d.items()}
        state, m = rf(state, batch, val)
        metrics.append(jax.tree.map(np.asarray, m._asdict()))
    return init, gumbels, metrics, jax.tree.map(np.asarray, state)


def _torch_rounds(name, fused_adam, rounds=2, check_ptrs=False):
    mkw, wkw = CONFIGS[name]
    init, gumbels, _, _ = _jax_two_rounds(name)
    cfg = ModelConfig(**mkw)
    w = WSSLConfig(num_clients=4, participation_fraction=0.5, **wkw)
    t = TrainConfig(fused_adam=fused_adam, **TRAIN_KW)
    state = state_from_jax(init, cfg, device="cpu")
    rf = make_round_fn(cfg, w, t, impl="dense")
    vd = lm_batch(4, 16, cfg.vocab_size, seed=999)
    val = {k: torch.as_tensor(v) for k, v in vd.items()}
    ptrs = [x.data_ptr() for x in _state_tensors(state)]
    metrics = []
    for r in range(rounds):
        d = lm_batch(8, 16, cfg.vocab_size, seed=r)
        batch = {k: torch.as_tensor(v).reshape(4, 2, 16) for k, v in d.items()}
        out, m = rf(state, batch, val, gumbel=_t(gumbels[r]))
        assert out is state
        metrics.append(m)
        if check_ptrs:
            assert ptrs == [x.data_ptr() for x in _state_tensors(state)]
    return state, metrics


def _state_tensors(state):
    return tree_leaves((state.client_stack, state.server_params,
                        state.edge_stages, state.opt_client.m,
                        state.opt_client.v, state.opt_server.m,
                        state.opt_server.v, [o.m for o in state.opt_edge],
                        [o.v for o in state.opt_edge], state.importance))


@pytest.mark.parametrize("name", ["single", "multihop"])
@pytest.mark.parametrize("fused_adam", [False, True])
def test_two_rounds_match_live_jax_round(name, fused_adam):
    # the JAX round runs its unfused optimizer chain either way (its Pallas
    # kernel cannot run on the CPU); the port's flag is a parity no-op
    _, _, jmetrics, jstate = _jax_two_rounds(name)
    state, metrics = _torch_rounds(name, fused_adam)
    for jm, m in zip(jmetrics, metrics):
        np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m, f).numpy(), jm[f],
                                       rtol=1e-5, atol=1e-7, err_msg=f)
        for f in ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
                  "bytes_update_raw", "bytes_update_comp"):
            np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                          err_msg=f)
        for f in ("bytes_cross_shard", "bytes_intra_shard", "bytes_act_raw",
                  "bytes_act_comp"):
            assert float(getattr(m, f)) == float(jm[f]) == 0.0
    got = state_to_numpy(state)
    assert int(got["round_index"]) == int(jstate.round_index) == 2
    diffs = []
    for f in ("client_stack", "server_params", "edge_stages"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b]
        diffs += [np.abs(x - y).ravel() for x, y in zip(a, b)]
    diffs = np.concatenate(diffs)
    assert diffs.max() <= 2 * LR * 2, diffs.max()
    assert diffs.mean() <= 1e-7, diffs.mean()
    assert np.quantile(diffs, 0.999) <= 1e-6
    for f, jf in (("opt_client", jstate.opt_client),
                  ("opt_server", jstate.opt_server)):
        assert int(got[f]["step"]) == int(jf.step) == 2
        for a, b in zip(_np_leaves(got[f]["m"]), _np_leaves(jf.m)):
            np.testing.assert_allclose(a, b, atol=1e-6)
        for a, b in zip(_np_leaves(got[f]["v"]), _np_leaves(jf.v)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    np.testing.assert_allclose(got["importance"], jstate.importance,
                               rtol=1e-5)


def _jax_wssl_config(name, scheme, acts):
    return JWSSLConfig(num_clients=4, participation_fraction=0.5,
                       compression=JCompressionConfig(scheme=scheme,
                                                      activations=acts),
                       **CONFIGS[name][1])


@functools.lru_cache(maxsize=None)
def _jax_compressed_round_fn(name, kind, acts):
    """The JAX round of one compression *kind*, built once: int8 and int4
    are one executable in the JAX package (``CompressionConfig.kind`` is
    the only static branch; the levels and bits reach the round as the
    traced ``comp_p``), so both cases run it with their own ``comp_p``."""
    w = _jax_wssl_config(name, {"topk": "topk", "quant": "int8"}[kind], acts)
    return jax_make_round_fn(JModelConfig(**CONFIGS[name][0]), w,
                             JTrainConfig(**TRAIN_KW), impl="dense",
                             donate=True)


@functools.lru_cache(maxsize=None)
def _jax_compressed_rounds(name, scheme, acts):
    """``_jax_two_rounds`` with compression on: also each round's
    selection key, from which the test rebuilds the JAX compression
    draws.  The JAX ops run their oracles (the Pallas kernels cannot run
    here)."""
    jm = JModelConfig(**CONFIGS[name][0])
    w = _jax_wssl_config(name, scheme, acts)
    t = JTrainConfig(**TRAIN_KW)
    comp_p = jax_compression_params(w.compression)
    state, _ = jax_init_state(jax.random.PRNGKey(0), jm, w, t)
    init = jax.tree.map(np.asarray, state)
    val = {k: jnp.asarray(v) for k, v in
           jax_lm_batch(4, 16, jm.vocab_size, seed=999).items()}
    keys, gumbels, metrics = [], [], []
    with mock.patch.multiple(jax_ops,
                             quantize_stochastic=jax_ref.quantize_stochastic_2d,
                             dequantize=jax_ref.dequantize_2d,
                             topk_mask=jax_ref.topk_mask_2d):
        rf = _jax_compressed_round_fn(name, w.compression.kind, acts)
        for r in range(2):
            _, rng_sel = jax.random.split(state.rng)
            keys.append(rng_sel)
            gumbels.append(np.asarray(jax.random.gumbel(rng_sel, (4,))))
            d = jax_lm_batch(8, 16, jm.vocab_size, seed=r)
            batch = {k: jnp.asarray(v).reshape(4, 2, 16) for k, v in d.items()}
            state, m = rf(state, batch, val, None, None, comp_p)
            metrics.append(jax.tree.map(np.asarray, m._asdict()))
    return init, keys, gumbels, metrics, jax.tree.map(np.asarray, state)


def _jax_uniform(key):
    """The round's compression draws as the JAX round makes them."""
    def draw(tag, leaf, shape):
        k = jax.random.fold_in(key, tag)
        if leaf is not None:
            k = jax.random.fold_in(k, leaf)
        return _t(jax.random.uniform(k, shape, jnp.float32))
    return draw


@pytest.mark.parametrize("name", ["single", "multihop"])
@pytest.mark.parametrize("scheme", ["topk", "int8", "int4"])
@pytest.mark.parametrize("acts", [False, True])
def test_compressed_rounds_match_live_jax_round(name, scheme, acts):
    init, keys, gumbels, jmetrics, jstate = _jax_compressed_rounds(
        name, scheme, acts)
    mkw, wkw = CONFIGS[name]
    cfg = ModelConfig(**mkw)
    w = WSSLConfig(num_clients=4, participation_fraction=0.5,
                   compression=CompressionConfig(scheme=scheme,
                                                 activations=acts), **wkw)
    state = state_from_jax(init, cfg, device="cpu")
    rf = make_round_fn(cfg, w, TrainConfig(**TRAIN_KW), impl="dense")
    val = {k: torch.as_tensor(v) for k, v in
           lm_batch(4, 16, cfg.vocab_size, seed=999).items()}
    for r, jm in enumerate(jmetrics):
        d = lm_batch(8, 16, cfg.vocab_size, seed=r)
        batch = {k: torch.as_tensor(v).reshape(4, 2, 16) for k, v in d.items()}
        _, m = rf(state, batch, val, gumbel=_t(gumbels[r]),
                  comp_uniform=_jax_uniform(keys[r]))
        np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
        for f in ("bytes_up", "bytes_down", "bytes_per_hop", "bytes_sync",
                  "bytes_update_raw", "bytes_update_comp", "bytes_act_raw",
                  "bytes_act_comp"):
            np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                          err_msg=f)
        assert float(m.bytes_update_comp) < float(m.bytes_update_raw)
        assert (float(m.bytes_act_comp) > 0) == acts
        for f in ("loss", "per_client_loss", "val_loss", "importance"):
            np.testing.assert_allclose(getattr(m, f).numpy(), jm[f],
                                       rtol=1e-3, atol=1e-7, err_msg=f)
    got = state_to_numpy(state)
    for f in ("client_stack", "server_params", "edge_stages", "ef_residual"):
        a, b = _np_leaves(got[f]), _np_leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b]
        if not a:
            continue
        diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
        assert diffs.max() <= 2 * LR * 2, (f, diffs.max())
        assert diffs.mean() <= 1e-5, (f, diffs.mean())
        assert (diffs > 1e-4).mean() <= 5e-3, (f, (diffs > 1e-4).mean())
    assert any(np.abs(x).max() > 0 for x in _np_leaves(got["ef_residual"]))


def test_round_updates_the_state_in_place():
    state, metrics = _torch_rounds("multihop", True, rounds=2,
                                   check_ptrs=True)
    assert int(state.round_index) == 2
    assert metrics[1].mask.sum() == 2
    # clients are synchronized after each round
    for leaf in tree_leaves(state.client_stack):
        assert torch.equal(leaf[0], leaf[3])


def test_fused_and_unfused_rounds_agree_exactly():
    """``TrainConfig.fused_adam``, kept for parity with the JAX config,
    changes nothing: both settings step every leaf through the kernel
    dispatch (its plain version here), bit for bit."""
    a, ma = _torch_rounds("single", True)
    b, mb = _torch_rounds("single", False)
    for x, y in zip(_state_tensors(a), _state_tensors(b)):
        assert torch.equal(x, y)
    assert torch.equal(ma[1].val_loss, mb[1].val_loss)


def test_round_refuses_what_is_not_ported():
    cfg = ModelConfig(**TINY_KW)
    w = WSSLConfig(num_clients=2)
    t = TrainConfig(**TRAIN_KW)
    state = init_state(torch.Generator().manual_seed(0), cfg, w, t,
                       device="cpu")
    d = lm_batch(4, 8, cfg.vocab_size, seed=0)
    batch = {k: torch.as_tensor(v).reshape(2, 2, 8) for k, v in d.items()}
    before = [x.clone() for x in _state_tensors(state)]
    rf = make_round_fn(cfg, w, t)
    with pytest.raises(NotImplementedError, match="no backward"):
        make_round_fn(cfg, w, t, impl="kernel")(state, batch)
    # a client axis the clients do not divide over (n 2 over 4 shards)
    with pytest.raises(ValueError, match="divide evenly"):
        rf(state, batch, shard_ctx=ShardCtx(group=None, num_shards=4,
                                            index=0))
    for x, y in zip(before, _state_tensors(state)):
        assert torch.equal(x, y)
    assert int(state.round_index) == 0


def test_init_state_matches_jax_layout():
    jcfg = jax_reduced(jax_get_arch("gemma-2b")).replace(num_layers=4)
    cfg = reduced(get_arch("gemma-2b")).replace(num_layers=4)
    w, jw = WSSLConfig(num_clients=3), JWSSLConfig(num_clients=3)
    jstate, _ = jax_abstract_state(jcfg, jw, JTrainConfig())
    state = init_state(torch.Generator().manual_seed(0), cfg, w,
                       TrainConfig(), device="cpu")
    got = state_to_numpy(state)
    for f in ("client_stack", "server_params"):
        a, b = jax.tree.leaves(got[f]), jax.tree.leaves(getattr(jstate, f))
        assert [x.shape for x in a] == [x.shape for x in b]
        assert all(x.dtype == np.float32 for x in a)
    assert tree_leaves(state.client_stack)[0].dtype == torch.float32
    assert (state.server_params["embed"]["tok"].data_ptr()
            != state.client_stack["embed"]["tok"].data_ptr())
    np.testing.assert_array_equal(got["importance"], np.full(3, 1 / 3,
                                                             np.float32))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if torch.cuda.is_available():
            raise RuntimeError("no CUDA device (a card is present here)")
        init_state(torch.Generator(), cfg, w, TrainConfig())


def test_state_bridge_roundtrip():
    init, _, _, _ = _jax_two_rounds("multihop")
    cfg = ModelConfig(**CONFIGS["multihop"][0])
    got = state_to_numpy(state_from_jax(init, cfg, device="cpu"))
    for f in ("client_stack", "server_params", "edge_stages", "importance"):
        for a, b in zip(jax.tree.leaves(got[f]),
                        jax.tree.leaves(getattr(init, f))):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(jax.tree.leaves(got["opt_edge"][0]["m"]),
                    jax.tree.leaves(init.opt_edge[0].m)):
        np.testing.assert_array_equal(a, b)


def test_lm_batch_matches_jax():
    a, b = lm_batch(3, 11, 100, seed=5), jax_lm_batch(3, 11, 100, seed=5)
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(a[k], b[k])


# ---------------------------------------------------------------------------
# launch/train.py
# ---------------------------------------------------------------------------


def test_cli_trains_on_cpu(capsys, tmp_path):
    log = tmp_path / "hist.json"
    launch_train.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                       "--clients", "4", "--rounds", "2", "--seq-len", "16",
                       "--batch-per-client", "2", "--fused-adam",
                       "--log", str(log)])
    out = capsys.readouterr().out
    assert "device=cpu" in out and out.count("round ") == 2
    hist = json.loads(log.read_text())
    assert [h["selected"] for h in hist] == [4, 2]
    assert all(np.isfinite(h["loss"]) for h in hist)


def test_cli_trains_client_chunked_on_cpu(capsys):
    """``--client-chunk 2`` runs the chunked round (and a chunk that does
    not divide the clients raises, as in JAX)."""
    base = ["--arch", "gemma-2b", "--reduced", "--device", "cpu",
            "--clients", "4", "--rounds", "2", "--seq-len", "16",
            "--batch-per-client", "2"]
    launch_train.main(base + ["--client-chunk", "2"])
    out = capsys.readouterr().out
    assert out.count("round ") == 2
    with pytest.raises(ValueError, match="divide"):
        launch_train.main(base + ["--client-chunk", "3"])


def test_cli_refuses_unported_flags_and_needs_a_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            launch_train.main(["--arch", "gemma-2b", "--reduced"])


def test_checkpoint_round_trips_with_jax(tmp_path):
    """``checkpoint/io.py``: a file the JAX package saves loads in the
    port, and the reverse, leaf for leaf equal; ``--checkpoint`` saves the
    trained ``{"client_stack", "server"}`` as the JAX launcher does, and
    JAX's loader takes it into the JAX state's structure."""
    from repro.checkpoint import load_checkpoint as jax_load
    from repro.checkpoint import save_checkpoint as jax_save
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.tree import tree_leaves as jax_order_leaves
    init, _, _, _ = _jax_two_rounds("multihop")
    cfg = ModelConfig(**CONFIGS["multihop"][0])
    jtree = {"client_stack": init.client_stack, "server": init.server_params,
             "edges": list(init.edge_stages)}
    jax_save(str(tmp_path / "jax"), jtree, metadata={"arch": "tiny"})
    st = state_from_jax(init, cfg, device="cpu")
    like = {"client_stack": st.client_stack, "server": st.server_params,
            "edges": list(st.edge_stages)}
    got = load_checkpoint(str(tmp_path / "jax.npz"), like)
    for a, b in zip(jax_order_leaves(got), jax.tree.leaves(jtree)):
        np.testing.assert_array_equal(a.numpy(), b)
    moved = jax.tree.map(lambda a: a + 1.0, jtree)
    mine = tree_map(lambda t: t + 1.0, like)
    save_checkpoint(str(tmp_path / "port"), mine, metadata={"arch": "tiny"})
    back = jax_load(str(tmp_path / "port"), jtree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(moved)):
        np.testing.assert_array_equal(np.asarray(a), b)
    with pytest.raises(ValueError, match="keys"):
        load_checkpoint(str(tmp_path / "port"), {"server": like["server"]})

    path = tmp_path / "cli" / "ck"
    launch_train.main(["--arch", "gemma-2b", "--reduced", "--device", "cpu",
                       "--clients", "2", "--rounds", "1", "--seq-len", "8",
                       "--batch-per-client", "1", "--checkpoint", str(path)])
    jstate, _ = jax_abstract_state(jax_reduced(jax_get_arch("gemma-2b")),
                                   JWSSLConfig(num_clients=2), JTrainConfig())
    saved = jax_load(str(path), {"client_stack": jstate.client_stack,
                                 "server": jstate.server_params})
    state = init_state(torch.Generator().manual_seed(0),
                       reduced(get_arch("gemma-2b")),
                       WSSLConfig(num_clients=2), TrainConfig(), device="cpu")
    mine = load_checkpoint(str(path) + ".npz",
                           {"client_stack": state.client_stack,
                            "server": state.server_params})
    for a, b in zip(jax_order_leaves(mine), jax.tree.leaves(saved)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert json.loads((tmp_path / "cli" / "ck.json").read_text())[
        "arch"] == "gemma-2b"
