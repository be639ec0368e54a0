"""Mixture-of-Experts in the port (``models/moe.py``; OLMoE-1B-7B and
Phi-3.5-MoE) against the JAX package on the same inputs.

* The layer (``apply_moe``) against ``repro.models.moe.apply_moe`` on
  ``reduced()`` OLMoE and Phi, fp32 and bf16, at capacity factors 4.0 (no
  drops) and 1.0 (some expert overflows: asserted).  JAX runs it eagerly
  here: under ``jit`` XLA on the CPU forms the bf16 router logits in fp32
  and skips the rounding its source writes (``.astype(float32)`` of a
  bf16 product), so near-tied tokens go to other experts; op by op JAX
  rounds where its source casts, as the port does.  Bands: fp32 output
  atol = rtol = 1e-5 of max |out| (the same ops, other matmul summation
  orders); bf16 two bf16 ulps at max |out| (reduced OLMoE's outputs reach
  ~200, where one ulp is 1.0); the aux loss rel 1e-5.
* Top-k ties: a router with duplicated columns ties experts exactly; the
  port's expert ids equal ``jax.lax.top_k``'s (lower index first) and the
  layer stays in its band; ``moe.top_k`` equals ``lax.top_k`` exactly on
  rows tied at every place.  The combine equals XLA's scatter-add
  (``zeros.at[tok].add``) bit for bit, bf16 and fp32.
* The model paths on both reduced archs, bridged through
  ``params_from_jax`` with every norm scale and bias perturbed first (at
  JAX's init they change nothing): forward logits fp32 1e-4, prefill then
  decode steps 1e-4, and the engines' greedy tokens equal at 16 slots (8
  live, 8 dead) and capacity factor 1.0, where decode drops (asserted).
* Both CLIs on reduced OLMoE (the serving one in
  ``tests/test_torch_package.py``).

The rounds under MoE are held in ``tests/test_torch_moe_round.py``.
"""

import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import moe as jmoe
from repro.models import transformer as jtf
from repro.serve import DecodeEngine as JaxEngine
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.launch import train as launch_train
from repro_torch.models import layers
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.serve import DecodeEngine
from repro_torch.tree import tree_leaves

ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
FP32 = dict(atol=1e-4, rtol=1e-4)
PERTURBED = ("scale", "bias")


def _cfgs(arch, dtype="float32", **over):
    return (reduced(get_arch(arch)).replace(dtype=dtype, **over),
            jax_reduced(jax_get_arch(arch)).replace(dtype=dtype, **over))


def _t(a):
    return torch.as_tensor(np.array(a))


def _ulp_bf16(x):
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


# ---------------------------------------------------------------------------
# configs and init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    norm = 2 * d if cfg.norm == "layernorm" else d
    attn = d * cfg.head_dim * (2 * cfg.num_heads + 2 * cfg.num_kv_heads)
    layer = attn + d * e + 3 * e * d * f + 2 * norm
    n = 2 * cfg.vocab_size * d + cfg.num_layers * layer + norm
    # the bf16 sizes reckoned for one 80 GB card: 13.8 GB (whole) and
    # 83.7 GB (served at a depth cut)
    assert round(2 * n / 1e9, 1) == (13.8 if arch == "olmoe-1b-7b" else 83.7)
    # OLMoE's stacked expert leaves sit exactly at the sliced-draw limit
    # (drawn whole); Phi's are above it (drawn layer by layer)
    leaf = cfg.num_layers * e * d * f
    if arch == "olmoe-1b-7b":
        assert leaf == layers.SLICED_DRAW_ELEMENTS
    else:
        assert leaf > layers.SLICED_DRAW_ELEMENTS


@pytest.mark.parametrize("arch", ARCHS)
def test_init_tree_and_scales_equal_jax(arch):
    """Keys, shapes and dtypes of the port's ``init_params`` are JAX's,
    leaf for leaf; the expert projections' fan-in is ``shape[0]`` = E as
    in JAX's ``dense_param``, the router's 1/sqrt(d), ``wd``'s 1/sqrt(f).
    """
    cfg, jcfg = _cfgs(arch)
    jp = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                jcfg)[0])
    tp = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    jpaths = [jax.tree_util.keystr(p) for p, _ in
              jax.tree_util.tree_leaves_with_path(jp)]
    tleaves = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(lambda t: t.numpy(), tp))
    assert [jax.tree_util.keystr(p) for p, _ in tleaves] == jpaths
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    mlp = tp["stack"][0]["mlp"]
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    assert set(mlp) == {"router", "wg", "wu", "wd"}
    for key, scale in (("router", d ** -0.5), ("wg", e ** -0.5),
                       ("wu", e ** -0.5), ("wd", f ** -0.5)):
        assert abs(mlp[key].std().item() / scale - 1.0) < 0.02, key


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


def _layer_inputs(cfg, jcfg, seed, tokens=128, tie=False):
    jp, _ = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    if tie:
        # a duplicated router column: experts 0 and 1 tie exactly
        r = jp["router"]
        jp = dict(jp, router=r.at[:, 1].set(r[:, 0]))
    x = np.random.default_rng(seed).normal(
        size=(2, tokens // 2, cfg.d_model)).astype(np.float32)
    return jp, {k: _t(v) for k, v in jp.items()}, x


def _run_layer(arch, dtype, cf, seed, tie=False):
    cfg, jcfg = _cfgs(arch, dtype, moe_capacity_factor=cf)
    jp, tp, x = _layer_inputs(cfg, jcfg, seed, tie=tie)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    # eagerly: under jit, XLA on the CPU forms the bf16 router logits in
    # fp32 and skips their rounding to bf16, which moves near-tied tokens
    # to other experts (3 of 128 at seed 5); run op by op, JAX rounds
    # where its source casts, as the port does
    jo, ja = jmoe.apply_moe(jcfg, jp, jnp.asarray(x, jdt))
    to, ta = moe.apply_moe(cfg, tp, _t(x).to(layers.torch_dtype(dtype)))
    assert to.dtype == layers.torch_dtype(dtype) and ta.dtype == torch.float32
    return cfg, jp, x, np.asarray(jo, np.float32), float(ja), \
        to.float().numpy(), float(ta)


def _check_layer(dtype, want, got, jaux, taux):
    top = np.abs(want).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=1e-5 * top, rtol=1e-5)
    else:
        assert np.abs(got - want).max() <= 2 * _ulp_bf16(want)
    assert taux == pytest.approx(jaux, rel=1e-5)


def _router_probs(cfg, jp, x, dtype):
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    xt = jnp.asarray(x, jdt).reshape(-1, cfg.d_model)
    return jax.nn.softmax((xt @ jp["router"].astype(jdt)).astype(
        jnp.float32), axis=-1)


@pytest.mark.parametrize("cf", [4.0, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_jax(arch, dtype, cf):
    cfg, jp, x, want, jaux, got, taux = _run_layer(arch, dtype, cf, seed=3)
    _check_layer(dtype, want, got, jaux, taux)
    # the dispatch at this capacity: drops at 1.0, none at 4.0
    probs = _router_probs(cfg, jp, x, dtype)
    t = probs.shape[0]
    cap = moe._capacity(cfg, t)
    r = moe.route(cfg, _t(probs), cap)
    np.testing.assert_array_equal(r.expert_ids.numpy(),
                                  np.asarray(jax.lax.top_k(
                                      probs, cfg.experts_per_token)[1]))
    assert (int(r.counts.max()) > cap) == (cf == 1.0), (r.counts, cap)
    assert int(r.keep.sum()) == int(np.minimum(r.counts.numpy(), cap).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_planted_router_ties_break_as_lax_top_k(dtype):
    cfg, jp, x, want, jaux, got, taux = _run_layer(
        "olmoe-1b-7b", dtype, 1.0, seed=5, tie=True)
    probs = _router_probs(cfg, jp, x, dtype)
    p = np.asarray(probs)
    assert (p[:, 0] == p[:, 1]).all()
    ids = np.asarray(jax.lax.top_k(probs, cfg.experts_per_token)[1])
    r = moe.route(cfg, _t(probs), moe._capacity(cfg, p.shape[0]))
    np.testing.assert_array_equal(r.expert_ids.numpy(), ids)
    # the tie is broken at the k-th place on some tokens: expert 0 taken,
    # its twin 1 left out
    chose = [set(row) for row in ids.tolist()]
    assert any(0 in c and 1 not in c for c in chose)
    assert not any(1 in c and 0 not in c for c in chose)
    _check_layer(dtype, want, got, jaux, taux)


@pytest.mark.parametrize("k", [1, 2, 8])
def test_top_k_equals_lax_top_k_on_ties(k):
    """Values and indices of ``moe.top_k`` equal ``lax.top_k``'s exactly
    on rows of few distinct values (ties everywhere, at every place)."""
    rng = np.random.default_rng(k)
    probs = rng.integers(0, 4, size=(64, 16)).astype(np.float32) / 4
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
    got_v, got_i = moe.top_k(_t(probs), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_combine_equals_xla_scatter_add_bit_for_bit(dtype):
    rng = np.random.default_rng(0)
    t, k, e, d = 96, 8, 64, 40
    ids = np.stack([rng.choice(e, k, replace=False) for _ in range(t)])
    order = np.argsort(ids.reshape(-1), kind="stable")
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    contrib = jnp.asarray(rng.normal(size=(t * k, d)) * 10, jdt)
    want = jnp.zeros((t, d), jdt).at[jnp.asarray(order // k)].add(contrib)
    got = moe.combine(_t(contrib.astype(jnp.float32)).to(
        layers.torch_dtype(dtype)), _t(order), k)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


# ---------------------------------------------------------------------------
# the model paths
# ---------------------------------------------------------------------------


def perturb(tree, seed, scale=0.3):
    rng = np.random.default_rng(seed)

    def f(path, x):
        if getattr(path[-1], "key", None) in PERTURBED:
            return x + jnp.asarray(rng.normal(0.0, scale, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _setup(arch, cf=4.0):
    cfg, jcfg = _cfgs(arch, moe_capacity_factor=cf)
    jp, _ = jtf.init_params(jax.random.PRNGKey(1), jcfg)
    jp = perturb(jp, seed=len(arch))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_bridge_carries_the_expert_leaves():
    """``router``, ``wg``, ``wu``, ``wd`` come out in the asked dtype (JAX
    casts them at use), norm scales fp32."""
    cfg, jcfg, _, jp = _setup("phi3.5-moe-42b-a6.6b")
    np_params = jax.tree.map(np.asarray, jp)
    bf = params_from_jax(np_params, cfg, device="cpu", dtype=torch.bfloat16)
    mlp, jmlp = bf["stack"][0]["mlp"], np_params["stack"][0]["mlp"]
    for key in ("router", "wg", "wu", "wd"):
        assert mlp[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            mlp[key].float().numpy(),
            np.asarray(jnp.asarray(jmlp[key]).astype(jnp.bfloat16),
                       np.float32))
    assert bf["stack"][0]["norm2"]["scale"].dtype == torch.float32


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_and_aux_match_jax(arch):
    cfg, jcfg, tp, jp = _setup(arch)
    toks = _tokens(cfg, 2, 40, seed=2)
    want, jaux = jtf.forward(jp, jcfg, jnp.asarray(toks), impl="dense",
                             remat=False)
    with torch.no_grad():
        got, aux = tf.forward(tp, cfg, torch.as_tensor(toks), impl="kernel",
                              remat=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(aux) > 0
    # by stage at cuts (0, 1): the client stage (the embedding) drops its
    # aux, the edge stage (layer 0) and the server (layer 1) carry theirs,
    # which add up to the forward's
    stages = tf.partition_params(tp, cfg, (0, 1))
    with torch.no_grad():
        x, a0 = tf.stage_forward(stages[0], cfg, torch.as_tensor(toks), 0,
                                 remat=False, with_aux=True)
        x, a1 = tf.stage_forward(stages[1], cfg, x, 1, remat=False,
                                 with_aux=True)
        _, a2 = tf.server_hidden(stages[2], cfg, x, remat=False)
    assert float(a0) == 0.0 and float(a1) > 0 and float(a2) > 0
    assert float(a1 + a2) == float(aux)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_jax(arch):
    cfg, jcfg, tp, jp = _setup(arch)
    toks = _tokens(cfg, 2, 29, seed=3)
    jl, jc = jtf.prefill(jp, jcfg, jnp.asarray(toks), max_len=36,
                         impl="dense")
    tl, tc = tf.prefill(tp, cfg, torch.as_tensor(toks), max_len=36,
                        impl="kernel")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(3):
        pos = np.full((2,), 29 + t, np.int32)
        jlg, jc = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jc,
                                  jnp.asarray(pos))
        tlg, _ = tf.decode_step(tp, cfg, torch.as_tensor(tok), tc,
                                torch.as_tensor(pos))
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **FP32)
        tok = np.argmax(np.asarray(jlg)[:, 0], -1).astype(np.int32)[:, None]


def test_engines_agree_at_16_slots_with_decode_drops():
    """8 requests in 16 slots (8 dead, decoding garbage in lockstep, as
    both engines do) at capacity factor 1.0: 16 tokens a step over 4
    experts at capacity 8, so decode drops (recorded through ``route``);
    every slot's greedy tokens equal JAX's."""
    cfg, jcfg, tp, jp = _setup("olmoe-1b-7b", cf=1.0)
    seen = []
    real = moe.route

    def spy(c, probs, cap):
        r = real(c, probs, cap)
        seen.append((probs.shape[0], int(r.counts.max()), cap))
        return r

    jeng, teng = JaxEngine(jcfg, impl="dense"), DecodeEngine(
        cfg, impl="kernel", device="cpu")
    js, ts = jeng.new_batch_state(16, 40), teng.new_batch_state(16, 40)
    for slot in range(8):
        prompt = _tokens(cfg, 1, 12, seed=10 + slot)[0]
        a = jeng.admit(js, jp, prompt, 2 * slot)
        b = teng.admit(ts, tp, prompt, 2 * slot)
        assert a == b
    forced = np.zeros((16, 6), np.int32)
    force_len = np.zeros((16,), np.int32)
    want = jeng.decode_chunk(js, jp, forced, force_len,
                             jax.random.PRNGKey(0))
    with mock.patch.object(moe, "route", spy):
        got = teng.decode_chunk(ts, tp, forced, force_len)
    np.testing.assert_array_equal(got, np.asarray(want))
    decode = [(m, cap) for t, m, cap in seen if t == 16]
    assert decode and all(cap == 8 for _, cap in decode)
    assert any(m > cap for m, cap in decode), decode


def test_split_and_speculative_decode_run_moe():
    """Split decode through the stages equals merged decode bit for bit;
    a speculative round's emitted tokens are greedy decoding's."""
    cfg, _, tp, _ = _setup("olmoe-1b-7b")
    prompts = _tokens(cfg, 2, 12, seed=7)
    merged = DecodeEngine(cfg, device="cpu").generate(tp, prompts, 6)
    split = DecodeEngine(cfg, cuts=(1,), device="cpu").generate(tp, prompts,
                                                                6)
    np.testing.assert_array_equal(split, merged)
    eng = DecodeEngine(cfg, spec_cut=1, device="cpu")
    st = eng.new_batch_state(2, 32)
    for row in range(2):
        eng.admit(st, tp, prompts[row], row)
    first = st.tok.clone()
    toks, _, n = eng.spec_chunk(st, tp, 3)
    for row in range(2):
        assert int(first[row, 0]) == merged[row, 0]
        np.testing.assert_array_equal(toks[row, :n[row]],
                                      merged[row, 1:1 + n[row]])


def test_cli_trains_olmoe(capsys):
    launch_train.main(["--arch", "olmoe-1b-7b", "--reduced", "--device",
                       "cpu", "--clients", "2", "--rounds", "1",
                       "--seq-len", "16", "--batch-per-client", "1"])
    out = capsys.readouterr().out
    assert out.count("loss=") == 1 and "nan" not in out
