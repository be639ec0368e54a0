"""The recurrent families end to end against the JAX package:
``reduced(mamba2-370m)`` (2 SSD layers, no MLP) and
``reduced(recurrentgemma-2b)`` (an RG-LRU layer and a local-attention
layer of window 64, GeGLU MLPs), on bridged params and the same tokens.

* The full-sequence forward, plain (``impl="dense"``) and through the
  kernels (``impl="kernel"``: the plain versions on the CPU), against JAX's
  ``forward(impl="pallas")`` with its three kernels replaced by their
  ``repro.kernels.ref`` oracles inside the test (the Pallas kernels cannot
  run here), and against its plain forward.
* ``make_prefill_step`` against JAX's.
* Prefill + decode on a contiguous cache, including a prompt longer than
  the window (the ring keeps the last 64 entries), and the engine and
  router against JAX's (paged for RecurrentGemma: only global layers page,
  so its rings and states stay per slot).
* The bridge keeps the fp32 leaves fp32; ``impl="kernel"`` refuses
  autograd.  (Their training through the round is
  ``tests/test_torch_family_train.py``.)

Tolerance: fp32 logits atol = rtol = 1e-4 (same fp32 math, other summation
orders; measured gaps ~1e-5).  Greedy tokens must be equal exactly.
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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch.steps import make_prefill_step as jax_prefill_step
from repro.models import transformer as jtf
from repro.serve import DecodeEngine as JaxEngine
from repro.serve import FaultRoutedServer as JaxServer
from repro.serve import ServeParams as JaxServeParams
from repro.serve import synthetic_requests as jax_requests
from repro_torch import _bridge
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import transformer as tf
from repro_torch.serve import (DecodeEngine, FaultRoutedServer, ServeParams,
                               synthetic_requests)

FP32 = dict(atol=1e-4, rtol=1e-4)
ARCHS = ("mamba2-370m", "recurrentgemma-2b")
# prompt lengths: a Mamba-2 prompt is one SSD chunk (32 reduced) or a
# whole number of them; RecurrentGemma's 80 runs past the window of 64
SEQ = {"mamba2-370m": 64, "recurrentgemma-2b": 80}


@functools.lru_cache(maxsize=None)
def _setup(arch, dtype="float32", seed=0):
    """(port config, JAX config, port params, JAX params); read-only."""
    jcfg = jax_reduced(jax_get_arch(arch)).replace(dtype=dtype)
    cfg = reduced(get_arch(arch)).replace(dtype=dtype)
    jp, _ = jtf.init_params(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x, dtype=np.float32)


def _patch_jax_kernels(monkeypatch):
    """JAX's kernel entry points -> their oracles, in the model layouts."""
    def flash(q, k, v, *, causal=True, window=None, scale=None,
              logit_softcap=None, **_):
        t = lambda a: a.transpose(0, 2, 1, 3)
        return t(jref.flash_attention(t(q), t(k), t(v), causal=causal,
                                      window=window, scale=scale,
                                      logit_softcap=logit_softcap))

    monkeypatch.setattr(jops, "flash_attention", flash)
    monkeypatch.setattr(jops, "ssd_scan",
                        lambda x, dt, a, b_, c_, **_: jref.ssd_scan(
                            x, dt, a, b_, c_))
    monkeypatch.setattr(jops, "rg_lru_scan",
                        lambda log_a, b, **_: jref.rg_lru_scan(log_a, b))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("impl", ["dense", "kernel"])
def test_forward_matches_jax(arch, impl, monkeypatch):
    cfg, jcfg, tp, jp = _setup(arch)
    toks = _tokens(cfg, 2, SEQ[arch], seed=1)
    if impl == "kernel":
        _patch_jax_kernels(monkeypatch)
    want, _ = jtf.forward(jp, jcfg, jnp.asarray(toks),
                          impl="pallas" if impl == "kernel" else "dense",
                          remat=False)
    with torch.no_grad():
        got, aux = tf.forward(tp, cfg, torch.as_tensor(toks), impl=impl,
                              remat=False)
    assert float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), _np(want), **FP32)
    # and the plain JAX forward: the kernel path computes the same function
    plain, _ = jtf.forward(jp, jcfg, jnp.asarray(toks), impl="dense",
                           remat=False)
    np.testing.assert_allclose(got.numpy(), _np(plain), **FP32)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_step_matches_jax(arch):
    cfg, jcfg, tp, jp = _setup(arch, seed=1)
    toks = _tokens(cfg, 2, SEQ[arch], seed=2)
    want = jax_prefill_step(jcfg, impl="dense")(jp, {"tokens":
                                                     jnp.asarray(toks)})
    for impl in ("dense", "kernel"):
        got = make_prefill_step(cfg, impl)(tp, {"tokens":
                                                torch.as_tensor(toks)})
        assert got.shape == (2, 1, cfg.vocab_size)
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), _np(want), **FP32)


@pytest.mark.parametrize("arch,s", [("mamba2-370m", 32), ("mamba2-370m", 64),
                                    ("recurrentgemma-2b", 19),
                                    ("recurrentgemma-2b", 80)])
def test_prefill_and_decode_match_jax_contiguous(arch, s):
    """Prefill on a contiguous cache, then three greedy decode steps; the
    80-token RecurrentGemma prompt wraps the 64-entry ring."""
    cfg, jcfg, tp, jp = _setup(arch)
    toks = _tokens(cfg, 2, s, seed=s)
    max_len = s + 8
    jl, jc = jtf.prefill(jp, jcfg, jnp.asarray(toks), max_len=max_len,
                         impl="dense")
    for impl in ("dense", "kernel"):
        tl, tc = tf.prefill(tp, cfg, torch.as_tensor(toks), max_len=max_len,
                            impl=impl)
        np.testing.assert_allclose(tl.numpy(), _np(jl), **FP32)
    jcs = jax.tree.leaves(jc)
    tcs = jax.tree.leaves(tc)
    assert [a.shape for a in jcs] == [tuple(t.shape) for t in tcs]
    for a, t in zip(jcs, tcs):
        if t.dtype == torch.int32:       # ring positions
            np.testing.assert_array_equal(t.numpy(), np.asarray(a))
        else:
            np.testing.assert_allclose(t.float().numpy(), _np(a), **FP32)
    logits = _np(jl)
    for step in range(3):
        nxt = np.argmax(logits[:, -1], -1)[:, None].astype(np.int32)
        pos = np.full((2,), s + step, np.int32)
        jd, jc = jtf.decode_step(jp, jcfg, jnp.asarray(nxt), jc,
                                 jnp.asarray(pos))
        td, tc = tf.decode_step(tp, cfg, torch.as_tensor(nxt), tc,
                                torch.as_tensor(pos))
        np.testing.assert_allclose(td.numpy(), _np(jd), **FP32)
        logits = _np(jd)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_matches_jax_engine(arch):
    cfg, jcfg, tp, jp = _setup(arch, seed=2)
    prompts = _tokens(cfg, 3, 32, seed=4)
    want = np.asarray(JaxEngine(jcfg, impl="dense").generate(jp, prompts, 6))
    for impl in ("dense", "kernel"):
        got = DecodeEngine(cfg, impl=impl, device="cpu").generate(
            tp, prompts, 6)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,block_size", [("mamba2-370m", 0),
                                             ("recurrentgemma-2b", 8)])
def test_router_matches_jax_router(arch, block_size):
    """Four requests through two replicas of two slots; RecurrentGemma in
    paged mode with prompts of 40-80 tokens (past its window of 64)."""
    cfg, jcfg, tp, jp = _setup(arch, seed=3)
    plen = 32 if arch == "mamba2-370m" else 80
    kw = dict(replicas=2, slots=2, chunk=4, max_len=104,
              block_size=block_size)
    want = JaxServer(JaxEngine(jcfg, impl="dense"), jp,
                     JaxServeParams(**kw)).run(
        jax_requests(jcfg, 4, prompt_len=plen, gen=10, seed=1))
    reqs = synthetic_requests(cfg, 4, prompt_len=plen, gen=10, seed=1)
    got = FaultRoutedServer(DecodeEngine(cfg, impl="kernel", device="cpu"),
                            tp, ServeParams(**kw)).run(reqs)
    assert got.outputs == want.outputs
    assert got.latencies == want.latencies


def test_paged_admission_keeps_recurrent_rows_per_slot():
    """RecurrentGemma in paged mode: the pool holds no layer (no global
    attention), admission copies the ring and the RG-LRU state into the
    slot's row, and the other slot's row stays as it was."""
    cfg, _, tp, _ = _setup("recurrentgemma-2b")
    eng = DecodeEngine(cfg, impl="kernel", device="cpu")
    st = eng.new_batch_state(2, 96, block_size=8)
    assert not any("pk" in d for d in st.cache["stack"] + st.cache["rem"])
    leaves = lambda c: [t for d in c["stack"] for t in d.values()]
    before = [t.clone() for t in leaves(st.cache)]
    prompt = _tokens(cfg, 1, 70, seed=5)[0]
    eng.admit(st, tp, prompt, 1, blocks=[3, 4, 5, 6, 7, 8, 9, 10, 11])
    ref_cache = tf.init_cache(cfg, 1, 96, device="cpu")
    tf.prefill(tp, cfg, torch.as_tensor(prompt)[None], cache=ref_cache)
    for got, want, old in zip(leaves(st.cache), leaves(ref_cache), before):
        torch.testing.assert_close(got[:, 1], want[:, 0], rtol=0, atol=0)
        torch.testing.assert_close(got[:, 0], old[:, 0], rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_keeps_fp32_leaves(arch):
    """Bridged in bf16: the leaves the model reads in fp32 stay fp32 and
    exact; every other leaf is the bf16 rounding of the JAX value.  The
    port's own init follows the same rule and the JAX tree layout."""
    cfg, jcfg, tp, jp = _setup(arch, dtype="bfloat16")
    own = tf.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert jax.tree.map(lambda a: a.shape, jp) == jax.tree.map(
        lambda t: tuple(t.shape), tp) == jax.tree.map(
        lambda t: tuple(t.shape), own)
    owns = dict(jax.tree_util.tree_leaves_with_path(own))
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for k in path:
            node = node[k.key if hasattr(k, "key") else k.idx]
        fp32 = path[-1].key in _bridge._FP32_LEAVES
        assert node.dtype == (torch.float32 if fp32 else torch.bfloat16)
        assert owns[path].dtype == node.dtype
        want = np.asarray(leaf) if fp32 else np.asarray(
            jnp.asarray(leaf).astype(jnp.bfloat16), np.float32)
        np.testing.assert_array_equal(node.float().numpy(), want)


def test_kernel_impl_refuses_autograd():
    cfg, _, tp, _ = _setup("recurrentgemma-2b")
    toks = torch.as_tensor(_tokens(cfg, 1, 16, seed=6))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tf.forward(tp, cfg, toks, impl="kernel", remat=False)
    with torch.no_grad():
        tf.forward(tp, cfg, toks, impl="kernel", remat=False)
