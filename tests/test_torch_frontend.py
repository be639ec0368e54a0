"""The modality frontend and M-RoPE in the port against the JAX package:
Qwen2-VL-72B (patch embeddings spliced before the text, three-stream
rotary positions) and MusicGen-medium (audio tokens, an ungated GELU MLP
under LayerNorm), on ``reduced()`` configs.

* ``build_positions`` and the three-stream ``text_positions``: exact.
  M-RoPE (``apply_rope``): bit for bit the port's standard RoPE on each
  section's stream, and within the fp32 band of JAX (the libraries' fp32
  pow, cos and sin differ in the last bit, as for the standard branch).
* The two attention paths with image patches in front.  JAX's dense path
  masks by the temporal stream (every patch has t = 0, so the patches see
  each other both ways); its Pallas path is causal by index.  On these
  inputs the two differ by far more than any band, so each port path is
  held against its own JAX counterpart: ``impl="dense"`` against JAX
  dense, ``impl="kernel"`` against JAX ``impl="pallas"`` with the kernels'
  oracles patched in (``tests/test_torch_families.py::_patch_jax_kernels``).
  fp32 atol = rtol = 1e-4.
* Prefill with ``embeds``, ``loss_fn`` with the prefix trimmed, the
  bridge's ``frontend.proj``, the init tree.
* JAX's split pipeline and its merged forward disagree on image inputs:
  stage 0 builds the grid positions, the later stages use text positions
  over the whole length.  The port reproduces the gap to JAX's value
  within 1e-4, and with the grid positions passed to the server both
  agree with the merged forward.
* MusicGen: forward, prefill and the engine's greedy tokens against JAX's
  engine, its LayerNorm scale and bias moved off their init first.
* Two live JAX rounds with ``embeds`` (3 layers, cuts (1, 2), 4 clients,
  16 patches before 16 text tokens): the flat sync round, 2 rounds, and
  the async round at deadline 2 (no scenario: the async round's own
  ``embeds`` wiring) with ``client_chunk=2``, 2 rounds, each within
  ``tests/test_torch_round.py``'s
  bands (masks and byte counts exact; losses, importance rel 1e-5; stages
  max |diff| 2 lr a round, mean 1e-7, 99.9th percentile 1e-6; moments
  atol 1e-6).  The port's own chunked sync round is held against its flat
  one within the same bands.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import AsyncRoundsConfig as JAsyncRoundsConfig
from repro.config import TrainConfig as JTrainConfig
from repro.config import WSSLConfig as JWSSLConfig
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.core import async_round as jar
from repro.core.round import init_state as jax_init_state
from repro.core.round import make_round_fn as jax_make_round_fn
from repro.data.synthetic import lm_batch
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import frontend as jfe
from repro.models import layers as jlayers
from repro.models import transformer as jtf
from repro.serve import DecodeEngine as JaxEngine
from repro_torch import _bridge
from repro_torch._bridge import params_from_jax, state_from_jax, state_to_numpy
from repro_torch.config import (AsyncRoundsConfig, TrainConfig, WSSLConfig,
                                get_arch, reduced)
from repro_torch.core.async_round import (init_async_state,
                                          make_async_round_fn)
from repro_torch.core.round import make_round_fn
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import frontend as fe
from repro_torch.models import layers
from repro_torch.models import transformer as tf
from repro_torch.serve import DecodeEngine
from repro_torch.tree import tree_leaves

FP32 = dict(atol=1e-4, rtol=1e-4)
VL, MG = "qwen2-vl-72b", "musicgen-medium"
F = 16          # reduced Qwen2-VL's patch count
LR = 1e-3
TRAIN_KW = dict(remat=False, learning_rate=LR, warmup_steps=0,
                schedule="constant", grad_clip=1.0)


def _cfgs(arch, **over):
    return (reduced(get_arch(arch)).replace(**over),
            jax_reduced(jax_get_arch(arch)).replace(**over))


def _perturb_norms(tree, seed):
    """``tree`` (JAX arrays) with seeded normal noise on every norm
    ``scale`` and ``bias`` leaf, so LayerNorm runs away from its init."""
    rng = np.random.default_rng(seed)

    def f(path, x):
        if getattr(path[-1], "key", None) in ("scale", "bias"):
            return x + jnp.asarray(rng.normal(0.0, 0.3, x.shape), x.dtype)
        return x

    return jax.tree_util.tree_map_with_path(f, tree)


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg, jcfg = _cfgs(arch)
    jp = jax.jit(lambda key: jtf.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(1))
    jp = _perturb_norms(jp, seed=3)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _embeds(cfg, shape, seed):
    return (0.1 * np.random.default_rng(seed).normal(
        size=shape + (cfg.d_model,))).astype(np.float32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg, impl):
    """JAX's full-sequence forward -> logits, jitted (one compile, where
    run eagerly each op would compile on its own first use)."""
    return jax.jit(lambda p, toks, emb: jtf.forward(
        p, jcfg, toks, embeds=emb, impl=impl, remat=False)[0])


def _patch_jax_kernels(monkeypatch):
    """JAX's flash entry point -> its oracle, in the model layout."""
    def flash(q, k, v, *, causal=True, window=None, scale=None,
              logit_softcap=None, **_):
        t = lambda a: a.transpose(0, 2, 1, 3)
        return t(jref.flash_attention(t(q), t(k), t(v), causal=causal,
                                      window=window, scale=scale,
                                      logit_softcap=logit_softcap))

    monkeypatch.setattr(jops, "flash_attention", flash)


# ---------------------------------------------------------------------------
# configs, init and bridge
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VL, MG])
def test_config_equals_jax(arch):
    cfg, jcfg = get_arch(arch), jax_get_arch(arch)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    d, f, h, kv, hd = (cfg.d_model, cfg.d_ff, cfg.num_heads,
                       cfg.num_kv_heads, cfg.head_dim)
    if arch == VL:
        # 877.7 M a layer, the 2.49 GB embedding and head in bf16; 145.4 GB
        # whole without the projector (JAX's count), 75.3 GB at 40 of its
        # 80 layers with it (reckoned for one card)
        layer = d * hd * (2 * h + 2 * kv) + 3 * d * f + 2 * d + hd * (h + 2 * kv)
        assert round(layer / 1e6, 1) == 877.7
        n = 2 * cfg.vocab_size * d + d * d + cfg.num_layers * layer + d
        assert n - jcfg.param_count() == d * d
        assert round(2 * (n - d * d) / 1e9, 1) == 145.4
        assert round(2 * (n - 40 * layer) / 1e9, 1) == 75.3
        assert (cfg.rope_kind, cfg.frontend, cfg.frontend_tokens) == (
            "mrope", "vision", 1024)
        assert jlayers._mrope_sections(hd // 2) == (16, 24, 24)
    else:
        # 24 over 24 heads (g 1) at hd 64, ungated GELU: 1.366 G, 2.73 GB
        layer = d * hd * (2 * h + 2 * kv) + 2 * d * f + 4 * d
        n = 2 * cfg.vocab_size * d + cfg.num_layers * layer + 2 * d
        assert (h // kv, hd, cfg.activation, cfg.rope_kind) == (
            1, 64, "gelu", "none")
        assert round(n / 1e9, 3) == 1.366 and round(2 * n / 1e9, 2) == 2.73
        # JAX's count leaves out the LayerNorm biases
        assert n - jcfg.param_count() == (2 * cfg.num_layers + 1) * d


def test_init_tree_equals_jax():
    """Keys, shapes and dtypes of the port's init are JAX's, the vision
    projector ``frontend.proj`` among them; it is drawn last, so the rest
    of the tree is what the same seed gives without the frontend."""
    cfg, jcfg = _cfgs(VL)
    jp = jax.eval_shape(lambda: jtf.init_params(jax.random.PRNGKey(0),
                                                jcfg)[0])
    tp = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        dtype=torch.float32)
    paths = lambda t: [jax.tree_util.keystr(p) for p, _ in
                       jax.tree_util.tree_leaves_with_path(t)]
    assert paths(jax.tree.map(lambda t: t.numpy(), tp)) == paths(jp)
    for t, j in zip(tree_leaves(tp), jax.tree.leaves(jp)):
        assert tuple(t.shape) == j.shape and t.dtype == torch.float32
    proj = tp["frontend"]["proj"]
    assert abs(float(proj.std()) * cfg.d_model ** 0.5 - 1.0) < 0.02
    plain = tf.init_params(cfg.replace(frontend="none"),
                           torch.Generator().manual_seed(0), device="cpu",
                           dtype=torch.float32)
    assert "frontend" not in plain
    for a, b in zip(tree_leaves({k: v for k, v in tp.items()
                                 if k != "frontend"}), tree_leaves(plain)):
        assert torch.equal(a, b)


def test_bridge_carries_frontend_proj():
    """``frontend.proj`` is a matrix: it comes out in the dtype asked for,
    rides with the client stage, and a training state round-trips it."""
    cfg, jcfg, _, jp = _setup(VL)
    np_params = jax.tree.map(np.asarray, jp)
    bf = params_from_jax(np_params, cfg, device="cpu", dtype=torch.bfloat16)
    assert "proj" not in _bridge._FP32_LEAVES
    assert bf["frontend"]["proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["frontend"]["proj"].float().numpy(),
        np.asarray(jnp.asarray(np_params["frontend"]["proj"]).astype(
            jnp.bfloat16), np.float32))
    stages = tf.partition_params(params_from_jax(np_params, cfg, device="cpu"),
                                 cfg, (1,))
    assert "frontend" in stages[0] and "frontend" not in stages[1]
    assert "frontend" in tf.join_stages(stages, cfg)
    init = _jax_init()
    back = state_to_numpy(state_from_jax(init, cfg3(), device="cpu"))
    np.testing.assert_array_equal(back["client_stack"]["frontend"]["proj"],
                                  init.client_stack["frontend"]["proj"])


# ---------------------------------------------------------------------------
# M-RoPE and the positions
# ---------------------------------------------------------------------------


def test_mrope_and_positions_match_jax_exactly():
    cfg, jcfg = _cfgs(VL)
    positions = jax.jit(jfe.build_positions, static_argnums=(0, 1, 2, 3))
    rope = jax.jit(jlayers.apply_rope, static_argnums=0)
    for f, s in ((F, 24), (10, 7), (0, 5), (1024, 3)):
        want = np.asarray(positions(jcfg, 2, s, f))
        got = fe.build_positions(cfg, 2, s, f)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    # the 1024-patch grid: 32 x 32, the text from 33 on
    pos = fe.build_positions(cfg, 1, 2, 1024)[0]
    assert pos[1023].tolist() == [0, 31, 31] and pos[1024].tolist() == [33] * 3
    np.testing.assert_array_equal(
        fe.build_positions(cfg.replace(rope_kind="standard"), 2, 5, 3).numpy(),
        np.asarray(positions(jcfg.replace(rope_kind="standard"), 2, 5, 3)))
    np.testing.assert_array_equal(layers.text_positions(2, 9, cfg).numpy(),
                                  np.asarray(jlayers.text_positions(2, 9, jcfg)))
    # apply_rope over grid positions, and at Qwen2-VL's full head dim.
    # Each stream turns its own section of the frequency dims: the port's
    # M-RoPE is bit for bit its standard RoPE on the positions of the
    # stream that owns each dim, and equals it outright on text positions.
    # Against JAX it agrees within the fp32 band, as the standard branch
    # does (tests/test_torch_layers.py): the two libraries' pow, cos and
    # sin differ in the last fp32 bit (5% of cos values at these angles).
    rng = np.random.default_rng(0)
    for c, jc in ((cfg, jcfg), (get_arch(VL), jax_get_arch(VL))):
        x = rng.normal(size=(2, F + 5, 3, c.head_dim)).astype(np.float32)
        p = np.asarray(positions(jc, 2, 5, F)) * 37
        want = np.asarray(rope(jc, jnp.asarray(x), jnp.asarray(p)))
        got = layers.apply_rope(c, torch.as_tensor(x), torch.as_tensor(p))
        np.testing.assert_allclose(got.numpy(), want, **FP32)
        half = c.head_dim // 2
        owner = np.repeat([0, 1, 2], layers._mrope_sections(half))
        std = c.replace(rope_kind="standard")
        per = [layers.apply_rope(std, torch.as_tensor(x),
                                 torch.as_tensor(p[..., i])) for i in range(3)]
        for j in range(half):
            for col in (j, j + half):
                assert torch.equal(got[..., col], per[owner[j]][..., col])
        text = layers.text_positions(2, F + 5, c) * 5
        assert torch.equal(layers.apply_rope(c, torch.as_tensor(x), text),
                           layers.apply_rope(std, torch.as_tensor(x),
                                             text[..., 0]))
    assert layers._mrope_sections(64) == (16, 24, 24)


# ---------------------------------------------------------------------------
# the model paths with image patches
# ---------------------------------------------------------------------------


def _vl_inputs(b=2, s=24, seed=1):
    cfg = _setup(VL)[0]
    return _tokens(cfg, b, s, seed), _embeds(cfg, (b, F), seed + 100)


@functools.lru_cache(maxsize=None)
def _jax_vl_logits(impl):
    """JAX's forward logits on ``_vl_inputs()`` through ``impl`` ("dense",
    or "pallas" with the oracle patched in by the caller), computed once
    per module: every test on these inputs reads them."""
    cfg, jcfg, tp, jp = _setup(VL)
    toks, emb = _vl_inputs()
    return _np(_jax_forward(jcfg, impl)(jp, toks, emb))


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_forward_with_embeds_matches_its_jax_path(impl, monkeypatch):
    cfg, jcfg, tp, jp = _setup(VL)
    toks, emb = _vl_inputs()
    _patch_jax_kernels(monkeypatch)
    jl = {i: _jax_vl_logits(i) for i in ("dense", "pallas")}
    # JAX's two paths part ways once patches are in front
    assert np.abs(jl["dense"] - jl["pallas"]).max() > 0.5
    want = jl["dense" if impl == "dense" else "pallas"]
    with torch.no_grad():
        got, _ = tf.forward(tp, cfg, torch.as_tensor(toks),
                            embeds=torch.as_tensor(emb), impl=impl,
                            remat=False)
    assert got.shape == (2, F + 24, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, **FP32)
    # the prefill step is the last position of the same forward (JAX's
    # make_prefill_step: forward(..., last_only=True))
    step = make_prefill_step(cfg, impl)(tp, {"tokens": torch.as_tensor(toks),
                                             "embeds": torch.as_tensor(emb)})
    np.testing.assert_allclose(step.numpy(), want[:, -1:], **FP32)


def test_prefill_and_loss_with_embeds_match_jax():
    cfg, jcfg, tp, jp = _setup(VL)
    toks, emb = _vl_inputs(seed=2)
    jl, jc = jax.jit(lambda p, t, e: jtf.prefill(
        p, jcfg, t, embeds=e, max_len=F + 24 + 4, impl="dense"))(jp, toks, emb)
    tl, tc = tf.prefill(tp, cfg, torch.as_tensor(toks),
                        embeds=torch.as_tensor(emb), max_len=F + 24 + 4,
                        impl="dense")
    np.testing.assert_allclose(tl.numpy(), _np(jl), **FP32)
    for a, b in zip(tree_leaves(tc), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)
    labels = _tokens(cfg, 2, 24, seed=3)
    want = jax.jit(lambda p, b: jtf.loss_fn(p, jcfg, b, impl="dense",
                                            remat=False))(
        jp, {"tokens": toks, "labels": labels, "embeds": emb})
    got = tf.loss_fn(tp, cfg, {"tokens": torch.as_tensor(toks),
                               "labels": torch.as_tensor(labels),
                               "embeds": torch.as_tensor(emb)}, remat=False)
    assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_split_pipeline_gap_matches_jax():
    """At cut 1 the server sees text positions over F + S, not the grid:
    its logits part from the merged forward's by JAX's gap, which vanishes
    when the grid positions are passed to it, in both packages."""
    cfg, jcfg, tp, jp = _setup(VL)
    toks, emb = _vl_inputs()
    grid = jfe.build_positions(jcfg, 2, 24, F)
    merged = _jax_vl_logits("dense")
    jc, js = jtf.split_params(jp, jcfg, 1)
    act = jax.jit(lambda p, t, e: jtf.client_forward(
        p, jcfg, t, embeds=e, impl="dense", remat=False))(jc, toks, emb)
    server = jax.jit(lambda p, a, pos: jtf.server_forward(
        p, jcfg, a, positions=pos, impl="dense", remat=False)[0])
    jsplit = _np(server(js, act, None))
    jfixed = _np(server(js, act, grid))
    jgap = np.abs(jsplit - merged).max()
    assert jgap > 0.5 and np.abs(jfixed - merged).max() < 1e-4
    stages = tf.partition_params(tp, cfg, (1,))
    with torch.no_grad():
        a = tf.stage_forward(stages[0], cfg, torch.as_tensor(toks), 0,
                             embeds=torch.as_tensor(emb), remat=False)
        x, _ = tf.server_hidden(stages[1], cfg, a, remat=False)
        tsplit = tf._unembed(cfg, stages[1], x).numpy()
        x, _ = tf.server_hidden(stages[1], cfg, a, remat=False,
                                positions=torch.as_tensor(np.asarray(grid)))
        tfixed = tf._unembed(cfg, stages[1], x).numpy()
    np.testing.assert_allclose(tsplit, jsplit, **FP32)
    assert abs(np.abs(tsplit - merged).max() - jgap) <= 1e-4
    assert np.abs(tfixed - merged).max() < 1e-4


def test_text_only_vl_and_mrope_decode_match_jax():
    """Without patches every stream carries the text index: forward,
    prefill and a few decode steps (three-stream positions on the decode
    side too) against JAX, contiguous and paged."""
    cfg, jcfg, tp, jp = _setup(VL)
    toks = _tokens(cfg, 2, 21, seed=5)
    jl, jc = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, max_len=32,
                                              impl="dense"))(jp, toks)
    step = jax.jit(lambda p, t, c, pos: jtf.decode_step(p, jcfg, t, c, pos))
    eng = DecodeEngine(cfg, impl="kernel", paged_kernel=True, device="cpu")
    st = eng.new_batch_state(2, 32, block_size=8)
    for row in range(2):
        eng.admit(st, tp, toks[row], row, blocks=[2 + 4 * row + i
                                                  for i in range(3)])
    tok = np.argmax(_np(jl)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(3):
        pos = np.full((2,), 21 + t, np.int32)
        jlg, jc = step(jp, tok, jc, pos)
        tlg, _ = tf.decode_step(tp, cfg, torch.as_tensor(tok), st.cache,
                                torch.as_tensor(pos), table=st.device_table(),
                                paged_kernel=True)
        np.testing.assert_allclose(tlg.numpy(), _np(jlg), **FP32)
        tok = np.argmax(_np(jlg)[:, 0], -1).astype(np.int32)[:, None]


# ---------------------------------------------------------------------------
# MusicGen
# ---------------------------------------------------------------------------


def test_musicgen_forward_prefill_and_engine_match_jax():
    cfg, jcfg, tp, jp = _setup(MG)
    assert "wg" not in tp["stack"][0]["mlp"]
    toks = _tokens(cfg, 2, 30, seed=6)
    want = _np(_jax_forward(jcfg, "dense")(jp, toks, None))
    for impl in ("dense", "kernel"):
        with torch.no_grad():
            got, _ = tf.forward(tp, cfg, torch.as_tensor(toks), impl=impl,
                                remat=False)
        np.testing.assert_allclose(got.numpy(), want, **FP32)
        pl, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), impl=impl)
        np.testing.assert_allclose(pl.numpy(), want, **FP32)
    want = np.asarray(JaxEngine(jcfg, impl="dense").generate(jp, toks, 10))
    got = DecodeEngine(cfg, impl="kernel", paged_kernel=True,
                       device="cpu").generate(tp, toks, 10)
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# the rounds with embeds
# ---------------------------------------------------------------------------

N = 4
ROUNDS = 2
W_KW = dict(num_clients=N, participation_fraction=0.5, split_layers=(1, 2))
DEADLINE = 2.0


def cfg3():
    return _cfgs(VL, num_layers=3)[0]


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_leaves(tree):
    return [np.asarray(x, np.float32) for x in jax.tree.leaves(tree)]


def _batches():
    """Two rounds of client batches (tokens, labels, embeds (N, 2, F, D))
    and the validation set, numpy."""
    cfg = cfg3()
    out = []
    for r in range(ROUNDS):
        d = lm_batch(2 * N, 16, cfg.vocab_size, seed=r)
        b = {k: v.reshape(N, 2, 16).copy() for k, v in d.items()}
        b["embeds"] = _embeds(cfg, (N, 2, F), seed=50 + r)
        out.append(b)
    return out, lm_batch(2, 16, cfg.vocab_size, seed=999)


@functools.lru_cache(maxsize=None)
def _jax_init():
    jcfg = _cfgs(VL, num_layers=3)[1]
    state = jax.jit(lambda key: jax_init_state(
        key, jcfg, JWSSLConfig(**W_KW), JTrainConfig(**TRAIN_KW))[0])(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def jax_sync_rounds():
    jcfg = _cfgs(VL, num_layers=3)[1]
    rf = jax_make_round_fn(jcfg, JWSSLConfig(**W_KW), JTrainConfig(**TRAIN_KW),
                           impl="dense", donate=True)
    state = jax.tree.map(jnp.asarray, _jax_init())
    batches, val = _batches()
    gumbels, metrics = [], []
    for b in batches:
        _, rng_sel = jax.random.split(state.rng)
        gumbels.append(np.asarray(jax.random.gumbel(rng_sel, (N,))))
        state, m = rf(state, jax.tree.map(jnp.asarray, b),
                      jax.tree.map(jnp.asarray, val))
        metrics.append(jax.tree.map(np.asarray, m._asdict()))
    return gumbels, metrics, jax.tree.map(np.asarray, state)


@functools.lru_cache(maxsize=None)
def torch_sync_rounds(chunk=None):
    gumbels = jax_sync_rounds()[0]
    cfg = cfg3()
    state = state_from_jax(_jax_init(), cfg, device="cpu")
    rf = make_round_fn(cfg, WSSLConfig(**W_KW),
                       TrainConfig(client_chunk=chunk, **TRAIN_KW),
                       impl="dense")
    batches, val = _batches()
    metrics = []
    for b, g in zip(batches, gumbels):
        _, m = rf(state, {k: _t(v) for k, v in b.items()},
                  {k: _t(v) for k, v in val.items()}, gumbel=_t(g))
        metrics.append(m)
    return metrics, state_to_numpy(state)


def _check_stages(a, b, what):
    assert [x.shape for x in a] == [x.shape for x in b] and a
    diffs = np.concatenate([np.abs(x - y).ravel() for x, y in zip(a, b)])
    assert diffs.max() <= 2 * LR * ROUNDS, (what, diffs.max())
    assert diffs.mean() <= 1e-7, (what, diffs.mean())
    assert np.quantile(diffs, 0.999) <= 1e-6, what


def _check_metrics(m, jm):
    np.testing.assert_array_equal(m.mask.numpy(), jm["mask"])
    for f in ("loss", "per_client_loss", "val_loss", "importance"):
        np.testing.assert_allclose(getattr(m, f).numpy(), jm[f], rtol=1e-5,
                                   atol=1e-7, err_msg=f)
    for f in ("bytes_up", "bytes_per_hop", "bytes_sync", "bytes_update_raw"):
        np.testing.assert_array_equal(np.asarray(getattr(m, f)), jm[f],
                                      err_msg=f)


def test_sync_round_with_embeds_matches_live_jax_round():
    _, jmetrics, jstate = jax_sync_rounds()
    metrics, got = torch_sync_rounds()
    assert jmetrics[0]["mask"].sum() == N and jmetrics[1]["mask"].sum() < N
    for m, jm in zip(metrics, jmetrics):
        _check_metrics(m, jm)
    for f in ("client_stack", "server_params", "edge_stages"):
        _check_stages(_np_leaves(got[f]), _np_leaves(getattr(jstate, f)), f)
    for f in ("opt_client", "opt_server"):
        for k in ("m", "v"):
            for x, y in zip(_np_leaves(got[f][k]),
                            _np_leaves(getattr(getattr(jstate, f), k))):
                np.testing.assert_allclose(x, y, atol=1e-6)
    # the projector trained
    assert not np.array_equal(_jax_init().client_stack["frontend"]["proj"],
                              got["client_stack"]["frontend"]["proj"])


def test_chunked_round_with_embeds_matches_the_flat_one():
    flat_m, flat = torch_sync_rounds()
    metrics, got = torch_sync_rounds(2)
    for m, fm in zip(metrics, flat_m):
        _check_metrics(m, {f: np.asarray(getattr(fm, f)) for f in (
            "mask", "loss", "per_client_loss", "val_loss", "importance",
            "bytes_up", "bytes_per_hop", "bytes_sync", "bytes_update_raw")})
    for f in ("client_stack", "server_params", "edge_stages"):
        _check_stages(_np_leaves(got[f]), _np_leaves(flat[f]), f)


def test_async_chunked_round_with_embeds_matches_live_jax_round():
    """The async round's own path for ``embeds`` with client chunks of 2,
    at deadline 2 and no scenario (every client on time), 2 rounds."""
    jcfg = _cfgs(VL, num_layers=3)[1]
    rf = jax.jit(jar.make_async_round_fn(
        jcfg, JWSSLConfig(**W_KW), JTrainConfig(client_chunk=2, **TRAIN_KW),
        impl="dense"))
    init = _jax_init()
    state = jax.tree.map(jnp.asarray, init)
    astate = jar.init_async_state(state)
    ap = jar.async_params(JAsyncRoundsConfig(deadline=DEADLINE), N)

    cfg = cfg3()
    w = WSSLConfig(**W_KW, async_rounds=AsyncRoundsConfig(deadline=DEADLINE))
    tstate = state_from_jax(init, cfg, device="cpu")
    tastate = init_async_state(tstate)
    trf = make_async_round_fn(cfg, w, TrainConfig(client_chunk=2, **TRAIN_KW),
                              impl="dense")
    batches, val = _batches()
    for b in batches:
        _, rng_sel = jax.random.split(state.rng)
        gumbel = np.asarray(jax.random.gumbel(rng_sel, (N,)))
        state, astate, jm = rf(state, astate, jax.tree.map(jnp.asarray, b),
                               jax.tree.map(jnp.asarray, val), None, ap)
        jm = jax.tree.map(np.asarray, dict(jm._asdict(),
                                           base=jm.base._asdict()))
        _, _, m = trf(tstate, tastate, {k: _t(v) for k, v in b.items()},
                      {k: _t(v) for k, v in val.items()}, gumbel=_t(gumbel))
        _check_metrics(m.base, jm["base"])
        for f in ("on_time", "buffered", "arrived", "evicted"):
            assert float(getattr(m, f)) == float(jm[f]), f
    got = state_to_numpy(tstate)
    jstate = jax.tree.map(np.asarray, state)
    for f in ("client_stack", "server_params", "edge_stages"):
        _check_stages(_np_leaves(got[f]), _np_leaves(getattr(jstate, f)), f)


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [VL, MG])
def test_cli_serves_and_trains(capsys, arch):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--requests", "3", "--replicas", "1", "--slots", "2",
                       "--prompt-len", "12", "--gen", "4", "--block-size",
                       "8", "--paged-kernel", "--impl", "kernel"])
    out = capsys.readouterr().out
    assert f"arch={arch}-reduced" in out
    launch_train.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--clients", "2", "--rounds", "1", "--seq-len", "16",
                       "--batch-per-client", "1"])
    out = capsys.readouterr().out
    assert out.count("loss=") == 1 and "nan" not in out
