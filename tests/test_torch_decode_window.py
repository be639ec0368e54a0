"""The long-context decode window (``decode_window_override``) in the port
against the JAX package, on ``reduced()`` Qwen2.5-32B and MusicGen-medium
(window 16, or the config's ``long_context_window``, 64 reduced).

Under the override every global layer's cache is a ring of the window,
which never pages; prefill attends over the whole prompt and keeps its
last ``window`` entries; decode attends to the last ``window`` positions.

* Decode step by step from position 0 against JAX's ``decode_step`` and
  against a forward in which every layer is local with that window, as
  ``tests/test_long_context.py`` holds JAX (fp32 1e-4 against JAX, 2e-3
  against the windowed forward, JAX's own band there).
* Prefill past the window, then decode: logits and the ring's contents
  (K, V and positions, slot by slot) against JAX's.
* The ring-sized cache, also where a paged cache was asked for.
* The engine's greedy tokens under the override, merged and split at a
  cut, and through a paged batch state with a speculative round, against
  JAX's engine.
* ``make_serve_step`` for ``long_500k`` (and ``decode_32k``, no window)
  against JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import INPUT_SHAPES as JAX_SHAPES
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.launch.steps import make_serve_step as jax_serve_step
from repro.models import transformer as jtf
from repro.serve import DecodeEngine as JaxEngine
from repro_torch._bridge import params_from_jax
from repro_torch.config import INPUT_SHAPES, get_arch, reduced
from repro_torch.launch.steps import make_serve_step
from repro_torch.models import transformer as tf
from repro_torch.serve import DecodeEngine
from repro_torch.tree import tree_leaves

FP32 = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("qwen2.5-32b", "musicgen-medium")
WIN = 16


@functools.lru_cache(maxsize=None)
def _setup(arch):
    cfg = reduced(get_arch(arch))
    jcfg = jax_reduced(jax_get_arch(arch))
    jp, _ = jtf.init_params(jax.random.PRNGKey(2), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@functools.lru_cache(maxsize=None)
def _jax_decode(jcfg, win):
    return jax.jit(lambda p, t, c, pos: jtf.decode_step(
        p, jcfg, t, c, pos, decode_window_override=win))


@pytest.mark.parametrize("arch", ARCHS)
def test_override_decode_matches_jax_and_windowed_forward(arch):
    cfg, jcfg, tp, jp = _setup(arch)
    s = 28
    toks = _tokens(cfg, 1, s, seed=1)
    ref, _ = tf.forward(tp, cfg.replace(pattern=("local",), window=WIN),
                        torch.as_tensor(toks), remat=False)
    cache = tf.init_cache(cfg, 1, s, decode_window_override=WIN, device="cpu")
    jc = jtf.init_cache(jcfg, 1, s, decode_window_override=WIN)
    step = _jax_decode(jcfg, WIN)
    with torch.no_grad():
        for t in range(s):
            pos = np.full((1,), t, np.int32)
            jl, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                          jnp.asarray(pos))
            lg, _ = tf.decode_step(tp, cfg, torch.as_tensor(toks[:, t:t + 1]),
                                   cache, torch.as_tensor(pos),
                                   decode_window_override=WIN)
            np.testing.assert_allclose(lg.numpy(), _np(jl), **FP32)
            assert (lg[:, 0] - ref[:, t]).abs().max() < 2e-3
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_past_the_window_then_decode_matches_jax(arch):
    """A 37-token prompt into 16-entry rings: the prompt attends in full,
    the ring keeps positions 21..36 at slot ``pos % 16``; four decode
    steps then wrap it further."""
    cfg, jcfg, tp, jp = _setup(arch)
    toks = _tokens(cfg, 2, 37, seed=2)
    jc = jtf.init_cache(jcfg, 2, 48, decode_window_override=WIN)
    jl, jc = jtf.prefill(jp, jcfg, jnp.asarray(toks), cache=jc, impl="dense")
    cache = tf.init_cache(cfg, 2, 48, decode_window_override=WIN,
                          device="cpu")
    tl, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), cache=cache,
                       impl="kernel")
    np.testing.assert_allclose(tl.numpy(), _np(jl), **FP32)
    pos = cache["stack"][0]["pos"][0, 0]
    assert pos.tolist() == [32, 33, 34, 35, 36] + list(range(21, 32))
    tok = np.argmax(_np(jl)[:, -1], -1).astype(np.int32)[:, None]
    step = _jax_decode(jcfg, WIN)
    for t in range(4):
        p = np.full((2,), 37 + t, np.int32)
        jlg, jc = step(jp, jnp.asarray(tok), jc, jnp.asarray(p))
        tlg, _ = tf.decode_step(tp, cfg, torch.as_tensor(tok), cache,
                                torch.as_tensor(p),
                                decode_window_override=WIN)
        np.testing.assert_allclose(tlg.numpy(), _np(jlg), **FP32)
        tok = np.argmax(_np(jlg)[:, 0], -1).astype(np.int32)[:, None]
    for a, b in zip(tree_leaves(cache), jax.tree.leaves(jc)):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)


def test_override_cache_is_ring_sized():
    cfg = reduced(get_arch("stablelm-12b"))
    for paged in (None, (9, 8)):
        cache = tf.init_cache(cfg, 1, 4096, decode_window_override=64,
                              paged=paged, device="cpu")
        kv = [d for d in cache["stack"] + cache["rem"]]
        assert kv and all("pk" not in d and d["k"].shape[-3] == 64
                          and d["pos"].shape[-1] == 64 for d in kv)
    # shorter than the window: the ring is max_len long
    cache = tf.init_cache(cfg, 1, 40, decode_window_override=64, device="cpu")
    assert cache["stack"][0]["k"].shape[-3] == 40
    # Gemma-3: the local layers keep their own window, the global ones
    # take the override
    g3 = reduced(get_arch("gemma3-12b"))
    cache = tf.init_cache(g3, 1, 2048, decode_window_override=128,
                          device="cpu")
    sizes = sorted({d["k"].shape[-3] for d in cache["stack"] + cache["rem"]})
    assert sizes == [g3.window, 128]
    # without the override the global layers page
    cache = tf.init_cache(g3, 1, 2048, paged=(9, 8), device="cpu")
    assert any("pk" in d for d in cache["stack"] + cache["rem"])


@pytest.mark.parametrize("arch,cuts", [("qwen2.5-32b", None),
                                       ("musicgen-medium", (1,))])
def test_engine_under_override_matches_jax_engine(arch, cuts):
    cfg, jcfg, tp, jp = _setup(arch)
    prompts = _tokens(cfg, 2, 30, seed=3)
    want = np.asarray(JaxEngine(jcfg, impl="dense", cuts=cuts,
                                decode_window_override=WIN).generate(
        jp, prompts, 10))
    eng = DecodeEngine(cfg, impl="kernel", cuts=cuts, paged_kernel=True,
                       decode_window_override=WIN, device="cpu")
    np.testing.assert_array_equal(eng.generate(tp, prompts, 10), want)


def test_paged_state_and_speculation_under_override_match_jax_engine():
    """Admission into a paged batch state (no layer pages under the
    override), a decode chunk, then a speculative round (draft at the
    client stage, verify, ring rollback), tokens against JAX's engine."""
    cfg, jcfg, tp, jp = _setup("qwen2.5-32b")
    prompts = _tokens(cfg, 2, 27, seed=4)
    kw = dict(decode_window_override=WIN, spec_cut=1)
    jeng = JaxEngine(jcfg, impl="dense", **kw)
    teng = DecodeEngine(cfg, impl="kernel", paged_kernel=True, device="cpu",
                        **kw)
    jst = jeng.new_batch_state(2, 48, block_size=8)
    tst = teng.new_batch_state(2, 48, block_size=8)
    assert not any("pk" in d for d in tst.cache["stack"] + tst.cache["rem"])
    for row in range(2):
        blocks = [2 + 4 * row + i for i in range(4)]
        assert teng.admit(tst, tp, prompts[row], row, blocks=blocks) == \
            jeng.admit(jst, jp, prompts[row], row, blocks=blocks)
    forced, flen = np.zeros((2, 6), np.int32), np.zeros((2,), np.int32)
    np.testing.assert_array_equal(
        teng.decode_chunk(tst, tp, forced, flen),
        jeng.decode_chunk(jst, jp, forced, flen, jax.random.PRNGKey(0)))
    for _ in range(2):
        got = teng.spec_chunk(tst, tp, 4)
        want = jeng.spec_chunk(jst, jp, 4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, np.asarray(b))
    np.testing.assert_array_equal(tst.pos.numpy(), np.asarray(jst.pos))
    for a, b in zip(tree_leaves(tst.cache), jax.tree.leaves(jst.cache)):
        np.testing.assert_allclose(_np(a), _np(b), **FP32)


@pytest.mark.parametrize("shape", ["long_500k", "decode_32k"])
def test_make_serve_step_matches_jax(shape):
    """long_500k decodes within the config's long_context_window (64
    reduced; 68 steps wrap the ring), decode_32k over the whole cache."""
    cfg, jcfg, tp, jp = _setup("qwen2.5-32b")
    assert vars(INPUT_SHAPES[shape]) == vars(JAX_SHAPES[shape])
    win = cfg.long_context_window if shape == "long_500k" else None
    assert win == (64 if shape == "long_500k" else None)
    jstep = jax.jit(jax_serve_step(jcfg, JAX_SHAPES[shape]))
    step = make_serve_step(cfg, INPUT_SHAPES[shape])
    n = 68 if win else 12
    toks = _tokens(cfg, 1, n, seed=5)
    jc = jtf.init_cache(jcfg, 1, n, decode_window_override=win)
    cache = tf.init_cache(cfg, 1, n, decode_window_override=win, device="cpu")
    assert cache["stack"][0]["k"].shape[2] == (win or n)
    for t in range(n):
        pos = np.full((1,), t, np.int32)
        jl, jc = jstep(jp, jc, {"tokens": jnp.asarray(toks[:, t:t + 1]),
                                "pos": jnp.asarray(pos)})
        lg, _ = step(tp, cache, {"tokens": torch.as_tensor(toks[:, t:t + 1]),
                                 "pos": torch.as_tensor(pos)})
        assert not lg.requires_grad
        np.testing.assert_allclose(lg.numpy(), _np(jl), **FP32)
