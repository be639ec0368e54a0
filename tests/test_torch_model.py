"""The port's model against ``repro.models.transformer`` at the reduced
Gemma-2B size, on the same params (bridged from JAX) and the same tokens.

Tolerances: fp32 logits atol = rtol = 1e-4 (measured gaps ~4e-6: same ops,
other summation order).  The bf16 case uses atol = rtol = 5e-2: both sides
round the logits to bf16 before the fp32 cast, and one bf16 step at
|logit| ~ 12 is 0.0625, so the band has to scale with the logit.
"""

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
from repro_torch.config import get_arch, reduced
from repro_torch.models import transformer as tf
from repro_torch.serve import DecodeEngine

FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


@functools.lru_cache(maxsize=None)
def _setup(dtype="float32", seed=0):
    """(port config, JAX config, port params, JAX params); read-only."""
    jcfg = jax_reduced(jax_get_arch("gemma-2b")).replace(dtype=dtype)
    cfg = reduced(get_arch("gemma-2b")).replace(dtype=dtype)
    jp, _ = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


@pytest.fixture(scope="module")
def jax_contiguous():
    """JAX prefill of 19 tokens (ragged: not a tile multiple), then two
    greedy decode steps on the contiguous cache: (tokens, logits list)."""
    cfg, jcfg, tp, jp = _setup()
    toks = _tokens(cfg, 2, 19, seed=1)
    prefill = jax.jit(lambda p, t: jtf.prefill(p, jcfg, t, max_len=24,
                                               impl="dense"))
    decode = jax.jit(lambda p, t, c, pos: jtf.decode_step(p, jcfg, t, c, pos))
    jl, jc = prefill(jp, jnp.asarray(toks))
    logits = [_np(jl)]
    for step in range(2):
        nxt = np.argmax(logits[-1][:, -1], -1)[:, None].astype(np.int32)
        jd, jc = decode(jp, jnp.asarray(nxt), jc,
                        jnp.full((2,), 19 + step, jnp.int32))
        logits.append(_np(jd))
    return toks, logits


@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_prefill_and_decode_logits_match_jax_contiguous(impl, jax_contiguous):
    cfg, _, tp, _ = _setup()
    toks, want = jax_contiguous
    tl, tc = tf.prefill(tp, cfg, torch.as_tensor(toks), max_len=24, impl=impl)
    np.testing.assert_allclose(tl.numpy(), want[0], **FP32)
    tlast, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), max_len=24,
                          impl=impl, last_only=True)
    np.testing.assert_allclose(tlast.numpy(), tl[:, -1:].numpy(), **FP32)
    for step in range(2):
        nxt = np.argmax(want[step][:, -1], -1)[:, None].astype(np.int32)
        td, tc = tf.decode_step(tp, cfg, torch.as_tensor(nxt), tc,
                                torch.full((2,), 19 + step, dtype=torch.int32))
        np.testing.assert_allclose(td.numpy(), want[step + 1], **FP32)


@pytest.mark.parametrize("paged_kernel", [False, True])
def test_decode_logits_match_jax_paged(paged_kernel):
    """Two requests of different lengths admitted into a paged pool by each
    engine, then one decode step on each side with the same table."""
    cfg, jcfg, tp, jp = _setup(seed=1)
    bs, max_len, slots = 8, 32, 3
    jeng = JaxEngine(jcfg, impl="dense")
    teng = DecodeEngine(cfg, impl="kernel", paged_kernel=paged_kernel,
                        device="cpu")
    jst = jeng.new_batch_state(slots, max_len, block_size=bs)
    tst = teng.new_batch_state(slots, max_len, block_size=bs)
    blocks = {0: [7, 4], 2: [5, 9, 3]}
    lengths = {0: 11, 2: 17}
    for slot, blk in blocks.items():
        prompt = _tokens(cfg, 1, lengths[slot], seed=slot)[0]
        assert jeng.admit(jst, jp, prompt, slot, blocks=blk) == \
            teng.admit(tst, tp, prompt, slot, blocks=blk)
    np.testing.assert_array_equal(tst.table, jst.table)
    tok = np.array(jst.tok)
    pos = np.array(jst.pos)
    jd, _ = jtf.decode_step(jp, jcfg, jnp.asarray(tok), jst.cache,
                            jnp.asarray(pos), table=jst.device_table())
    td, _ = tf.decode_step(tp, cfg, torch.as_tensor(tok), tst.cache,
                           torch.as_tensor(pos), table=tst.device_table(),
                           paged_kernel=paged_kernel)
    for slot in blocks:                  # the empty slot decodes garbage
        np.testing.assert_allclose(td[slot].numpy(), _np(jd)[slot], **FP32)


def test_prefill_logits_match_jax_bf16():
    cfg, jcfg, tp, jp = _setup(dtype="bfloat16")
    toks = _tokens(cfg, 2, 21, seed=2)
    jl, _ = jtf.prefill(jp, jcfg, jnp.asarray(toks), impl="dense")
    tl, _ = tf.prefill(tp, cfg, torch.as_tensor(toks), impl="kernel")
    np.testing.assert_allclose(tl.numpy(), _np(jl), **BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bridge_round_trip(dtype):
    cfg, jcfg, tp, jp = _setup(dtype=dtype)
    leaves = jax.tree_util.tree_leaves_with_path(jp)
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    for path, leaf in leaves:
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        assert tuple(node.shape) == leaf.shape
        is_scale = path[-1].key == "scale"
        assert node.dtype == (torch.float32 if is_scale else tdt)
        want = np.asarray(leaf) if is_scale else \
            np.asarray(jnp.asarray(leaf).astype(jnp.dtype(dtype)), np.float32)
        np.testing.assert_array_equal(node.float().numpy(), want)


def test_init_params_has_the_jax_layout():
    cfg, jcfg, _, jp = _setup()
    gen = torch.Generator().manual_seed(0)
    ours = tf.init_params(cfg.replace(dtype="bfloat16"), gen, device="cpu")
    want = jax.tree.map(lambda a: a.shape, jp)
    got = jax.tree.map(lambda t: tuple(t.shape), ours)
    assert got == want
    assert ours["stack"][0]["norm1"]["scale"].dtype == torch.float32
    assert ours["stack"][0]["mixer"]["wq"].dtype == torch.bfloat16
    w = ours["stack"][0]["mlp"]["wu"].float()
    assert abs(w.std().item() - cfg.d_model ** -0.5) < 0.1 * cfg.d_model ** -0.5
