"""The port's blocked training attention against the JAX package's.

* ``_FlashAttention`` (through ``_attn_flash``), ``_attn_chunked``,
  ``_attn_triangular`` and ``_attn_banded`` against JAX's private
  functions of the same names on the same numpy inputs: the forward
  output and the gradients of q, k and v (``jax.vjp`` against
  ``torch.autograd.grad`` of one random cotangent).  The cases walk
  several KV blocks (a small ``block``), a window that crosses block
  edges (so leading blocks hold no valid key for late queries: the
  ``-1e30`` running max), a softcap, GQA (g 2), MQA (8 over 1), each
  fallback (flash and chunked to dense where the keys do not split into
  blocks, triangular to chunked, banded to dense where S is not a whole
  number of windows above one) and one bf16 case.  Bands: fp32 within
  1e-4 of the reference's max magnitude (the same ops in another order);
  bf16 within 5e-2 of it (both round p and ds to bf16).
* Routing: ``multihead_attention`` and ``prefill_attention`` reach the
  same private functions as JAX's, fallbacks included, for every training
  impl with and without a window (JAX traced abstractly, both spied).
* The Function saves exactly its eight residuals (qg, k, v, both
  positions, out, m, l), none of them (Sq, Sk)-sized.

The JAX references are jitted, one executable per case.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import ModelConfig as JModelConfig
from repro.models import attention as ja
from repro_torch.config import ModelConfig
from repro_torch.models import attention as ta

FP32_BAND = 1e-4
BF16_BAND = 5e-2

# name -> (fn, hq, hkv, S, window, softcap, block, dtype)
CASES = {
    "flash-blocks": ("_attn_flash", 4, 2, 64, None, None, 16, "float32"),
    "flash-window-cap": ("_attn_flash", 4, 2, 64, 24, 30.0, 16, "float32"),
    "flash-mqa": ("_attn_flash", 8, 1, 64, 20, 5.0, 16, "float32"),
    "flash-to-dense": ("_attn_flash", 4, 2, 40, 24, None, 16, "float32"),
    "flash-bf16": ("_attn_flash", 4, 2, 64, 24, 30.0, 16, "bfloat16"),
    "chunked-window-cap": ("_attn_chunked", 4, 2, 64, 24, 5.0, 16,
                           "float32"),
    "chunked-to-dense": ("_attn_chunked", 8, 1, 40, None, None, 16,
                         "float32"),
    "triangular-window-cap": ("_attn_triangular", 4, 2, 64, 24, 5.0, 16,
                              "float32"),
    "triangular-mqa": ("_attn_triangular", 8, 1, 64, None, None, 16,
                       "float32"),
    "triangular-to-chunked": ("_attn_triangular", 4, 2, 48, 20, None, 32,
                              "float32"),
    "banded-mqa-cap": ("_attn_banded", 8, 1, 64, 16, 5.0, None, "float32"),
    "banded-to-dense": ("_attn_banded", 4, 2, 64, 24, None, None, "float32"),
    "banded-short-to-dense": ("_attn_banded", 4, 2, 16, 16, None, None,
                              "float32"),
}
HD = 16


def _cfgs(hq, hkv, cap, dtype="float32"):
    kw = dict(name="tiny-attn", num_layers=1, d_model=32, num_heads=hq,
              num_kv_heads=hkv, head_dim=HD, d_ff=64, vocab_size=64,
              attn_logit_softcap=cap, dtype=dtype)
    return JModelConfig(**kw), ModelConfig(**kw)


def _inputs(hq, hkv, s, seed=0):
    rng = np.random.default_rng(seed)
    q, do = (rng.normal(size=(2, s, hq, HD)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(2, s, hkv, HD)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    return q, k, v, do, pos


def _extra(fn, window, block):
    if fn == "_attn_banded":
        return dict(window=window)
    return dict(window=window, block=block)


@functools.lru_cache(maxsize=None)
def _jax_case(name):
    """JAX's output and (dq, dk, dv) of the case, as fp32 numpy."""
    fn, hq, hkv, s, window, cap, block, dtype = CASES[name]
    jcfg, _ = _cfgs(hq, hkv, cap, dtype)
    q, k, v, do, pos = _inputs(hq, hkv, s)
    jdt = jnp.dtype(dtype)
    f = getattr(ja, fn)

    @jax.jit
    def run(q, k, v, do, pos):
        out, vjp = jax.vjp(lambda q, k, v: f(jcfg, q, k, v, pos, pos,
                                            **_extra(fn, window, block)),
                           q, k, v)
        return (out,) + vjp(do)

    res = run(*(jnp.asarray(a, jdt) for a in (q, k, v, do)), jnp.asarray(pos))
    return [np.asarray(r, np.float32) for r in res]


def _torch_case(name):
    fn, hq, hkv, s, window, cap, block, dtype = CASES[name]
    _, cfg = _cfgs(hq, hkv, cap, dtype)
    q, k, v, do, pos = _inputs(hq, hkv, s)
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.tensor(a, dtype=tdt).requires_grad_(True)
                  for a in (q, k, v))
    p = torch.tensor(pos)
    out = getattr(ta, fn)(cfg, tq, tk, tv, p, p, **_extra(fn, window, block))
    grads = torch.autograd.grad(out, (tq, tk, tv),
                                torch.tensor(do, dtype=tdt))
    return [t.detach().float().numpy() for t in (out,) + grads]


@pytest.mark.parametrize("name", list(CASES))
def test_blocked_attention_and_grads_match_jax(name):
    band = BF16_BAND if CASES[name][-1] == "bfloat16" else FP32_BAND
    for what, got, want in zip(("out", "dq", "dk", "dv"), _torch_case(name),
                               _jax_case(name)):
        assert got.shape == want.shape, what
        err = np.abs(got - want).max() / np.abs(want).max()
        assert err <= band, (name, what, err)


def _spied(module, names):
    """Patch ``module``'s private attention functions with wrappers that
    log their names in call order (nested fallbacks included)."""
    calls = []

    def wrap(n, f):
        def g(*a, **kw):
            calls.append(n)
            return f(*a, **kw)
        return g

    patches = [mock.patch.object(module, n, wrap(n, getattr(module, n)))
               for n in names]
    return calls, patches


ROUTED = ("_attn_dense", "_attn_flash", "_attn_chunked", "_attn_triangular",
          "_attn_banded")


def _route(module, fn, *args, **kw):
    calls, patches = _spied(module, ROUTED)
    for p in patches:
        p.start()
    try:
        fn(*args, **kw)
    finally:
        for p in patches:
            p.stop()
    return calls


@pytest.mark.parametrize("s", [64, 40, 300, 1040])
def test_dispatch_matches_jax(s):
    """Which blocked function each impl reaches, fallbacks included, in
    training (``multihead_attention``) and prefill (``prefill_attention``):
    a windowed ``chunked`` prefill takes the band, a windowless
    ``banded`` layer the flash path; S 40 leaves the band (window 16 or
    24) to dense, S 300 the flash path's 256-key blocks to dense, S 1040
    triangular's and chunked's 1024-key blocks to chunked and dense."""
    jcfg, cfg = _cfgs(4, 2, None)
    rng = np.random.default_rng(1)
    d, hq, hkv = 32, 4, 2
    p = {n: rng.normal(size=shape).astype(np.float32) * 0.2 for n, shape in
         (("wq", (d, hq, HD)), ("wk", (d, hkv, HD)), ("wv", (d, hkv, HD)),
          ("wo", (hq, HD, d)))}
    x = rng.normal(size=(1, s, d)).astype(np.float32)
    pos = np.arange(s, dtype=np.int32)[None]
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.tensor(v) for k, v in p.items()}
    for impl in ("dense", "chunked", "flash", "banded", "triangular"):
        for window in (None, 16, 24):
            jax_train = _route(ja, lambda: jax.eval_shape(
                lambda x: ja.multihead_attention(
                    jcfg, jp, x, jnp.asarray(pos), window=window, impl=impl),
                jnp.asarray(x)))
            train = _route(ta, ta.multihead_attention, cfg, tp,
                           torch.tensor(x), torch.tensor(pos), window=window,
                           impl=impl)
            assert train == jax_train, (impl, window, train, jax_train)
            jcache = ja.init_kv_cache(jcfg, 1, s, window, jnp.float32)
            jax_pre = _route(ja, lambda: jax.eval_shape(
                lambda x: ja.prefill_attention(
                    jcfg, jp, x, jnp.asarray(pos), jcache, window=window,
                    impl=impl), jnp.asarray(x)))
            with torch.no_grad():
                pre = _route(ta, ta.prefill_attention, cfg, tp,
                             torch.tensor(x), torch.tensor(pos),
                             ta.init_kv_cache(cfg, 1, s, torch.float32,
                                              window=window),
                             window=window, impl=impl)
            assert pre == jax_pre, (impl, window, pre, jax_pre)


def test_flash_saves_only_its_residuals():
    """The Function's forward saves eight tensors, none of them an
    (Sq, Sk) tile; the dense path's autograd saves the whole score
    matrix."""
    _, cfg = _cfgs(8, 1, 30.0)
    q, k, v, _, pos = _inputs(8, 1, 64)
    tq, tk, tv = (torch.tensor(a).requires_grad_(True) for a in (q, k, v))
    p = torch.tensor(pos)
    for fn, want in ((ta._attn_flash, 8), (ta._attn_dense, None)):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(
                lambda t: saved.append(t) or t, lambda t: t):
            out = fn(cfg, tq, tk, tv, p, p, 24)
        largest = max(t.numel() for t in saved)
        if want is None:
            assert largest >= 2 * 8 * 64 * 64        # the (B, H, S, S) scores
        else:
            assert len(saved) == want, len(saved)
            assert largest == 2 * 64 * 8 * HD        # q and out
        out.sum().backward()
