"""Gemma-3-12B in the port against the JAX package, at the reduced size
(one local layer with window 64 over one global layer, 4 query heads over
4 KV heads, fp32), on the same params (bridged from JAX) and tokens.

Bands are test_torch_model.py's: fp32 logits atol = rtol = 1e-4 (same
ops, other summation order); bf16 atol = rtol = 5e-2 (both round the
logits to bf16).  Greedy tokens in fp32 are equal exactly.  The prompts
run past the window, so the local layer's mask and ring both bind.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import transformer as jtf
from repro.serve import DecodeEngine as JaxEngine
from repro_torch._bridge import params_from_jax
from repro_torch.config import ATTN_GLOBAL, ATTN_LOCAL, get_arch, reduced
from repro_torch.models import transformer as tf
from repro_torch.serve import DecodeEngine

FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


@functools.lru_cache(maxsize=None)
def _setup(dtype="float32"):
    jcfg = jax_reduced(jax_get_arch("gemma3-12b")).replace(dtype=dtype)
    cfg = reduced(get_arch("gemma3-12b")).replace(dtype=dtype)
    jp = jax.jit(lambda key: jtf.init_params(key, jcfg)[0])(
        jax.random.PRNGKey(1))
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


@functools.lru_cache(maxsize=None)
def _jax_forward(jcfg):
    """JAX's dense forward -> logits, jitted: one compile, where run
    eagerly each op would compile on its own first use."""
    return jax.jit(lambda p, t: jtf.forward(p, jcfg, t, impl="dense",
                                            remat=False)[0])


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def test_config_equals_jax():
    cfg, jcfg = get_arch("gemma3-12b"), jax_get_arch("gemma3-12b")
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    specs = cfg.layer_specs()
    assert [s.mixer for s in specs] == ([ATTN_LOCAL] * 5 + [ATTN_GLOBAL]) * 8
    assert {s.window for s in specs if s.mixer == ATTN_LOCAL} == {1024}
    # 11.77 B params, reckoned from the shapes (tied embedding, no biases)
    d, f, h, kv, hd = 3840, 15360, 16, 8, 256
    layer = d * hd * (2 * h + 2 * kv) + 3 * d * f + 2 * d
    n = cfg.vocab_size * d + 48 * layer + d
    assert round(n / 1e9, 2) == 11.77


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_forward_logits_match_jax(impl):
    cfg, jcfg, tp, jp = _setup()
    toks = _tokens(cfg, 2, 90, seed=2)
    want = _jax_forward(jcfg)(jp, toks)
    with torch.no_grad():      # the kernel path has no backward
        got, _ = tf.forward(tp, cfg, torch.as_tensor(toks), impl=impl,
                            remat=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FP32)


@pytest.mark.parametrize("paged", [False, True])
def test_prefill_and_decode_logits_match_jax(paged):
    """Prefill 90 tokens (the ring keeps the last 64), then four decode
    steps, contiguous or paged (block 16, rows on permuted blocks)."""
    cfg, jcfg, tp, jp = _setup()
    toks = _tokens(cfg, 2, 90, seed=3)
    max_len = 96
    jl, jc = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, max_len=max_len,
                                              impl="dense"))(jp, toks)
    jstep = jax.jit(lambda p, t, c, pos, tab: jtf.decode_step(
        p, jcfg, t, c, pos, table=tab))
    cache = tf.init_cache(cfg, 2, max_len, device="cpu")
    tl, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), cache=cache,
                       impl="kernel")
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **FP32)
    table = jtable = None
    if paged:
        # both engines admit the rows onto the same permuted pool blocks
        perm = np.random.default_rng(4).permutation(np.arange(2, 14))
        eng, jeng = DecodeEngine(cfg, device="cpu"), JaxEngine(jcfg)
        st = eng.new_batch_state(2, max_len, block_size=16)
        jst = jeng.new_batch_state(2, max_len, block_size=16)
        for row in range(2):
            blocks = [int(b) for b in perm[6 * row:6 * row + 6]]
            eng.admit(st, tp, toks[row], row, blocks=blocks)
            jeng.admit(jst, jp, toks[row], row, blocks=blocks)
        cache, table = st.cache, st.device_table()
        jc, jtable = jst.cache, jst.device_table()
    tok = np.argmax(np.asarray(jl)[:, -1], -1).astype(np.int32)[:, None]
    for t in range(4):
        pos = np.full((2,), 90 + t, np.int32)
        jlg, jc = jstep(jp, tok, jc, pos, jtable)
        tlg, _ = tf.decode_step(tp, cfg, torch.as_tensor(tok), cache,
                                torch.as_tensor(pos), table=table,
                                paged_kernel=paged)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg), **FP32)
        tok = np.argmax(np.asarray(jlg)[:, 0], -1).astype(np.int32)[:, None]


def test_greedy_tokens_match_jax_engine():
    cfg, jcfg, tp, jp = _setup()
    prompts = _tokens(cfg, 2, 70, seed=5)
    want = np.asarray(JaxEngine(jcfg, impl="dense").generate(jp, prompts, 12))
    got = DecodeEngine(cfg, impl="kernel", device="cpu").generate(
        tp, prompts, 12)
    np.testing.assert_array_equal(got, want)


def test_bf16_prefill_logits_within_the_band():
    cfg, jcfg, tp, jp = _setup("bfloat16")
    toks = _tokens(cfg, 1, 80, seed=6)
    want, _ = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, impl="dense"))(
        jp, toks)
    got, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), impl="kernel")
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16)
