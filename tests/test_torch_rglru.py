"""The port's RG-LRU pieces against ``repro.models.rglru`` and
``repro.kernels.ref.rg_lru_scan``, on the same numpy inputs and bridged
params, at the reduced RecurrentGemma size (d_model 256, lru_width 256).

Tolerances: the plain scan against the JAX oracle 1e-5 (as
``tests/test_kernels.py`` holds the TPU kernel; both round each step's
exp, product and sum once); the doubling scan against
``lax.associative_scan`` atol = rtol = 1e-5 (two log-depth trees of fp32
products in different orders); module outputs fp32 atol = rtol = 1e-4,
bf16 atol = rtol = 5e-2 (bf16 rounding after every op).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.kernels import ref as jref
from repro.models import rglru as jrglru
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rg_lru as rglru_kernel
from repro_torch.models import rglru

SCAN = dict(atol=1e-5, rtol=1e-5)
FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    log_a = -rng.uniform(1e-3, 0.5, size=(b, s, w)).astype(np.float32)
    bb = rng.normal(size=(b, s, w)).astype(np.float32)
    return log_a, bb


def _np(x):
    return np.asarray(x, dtype=np.float32)


# the shape sweep of tests/test_kernels.py::test_rg_lru_sweep
@pytest.mark.parametrize("b,s,w,chunk,bw", [
    (1, 128, 64, 64, 64),
    (2, 256, 256, 128, 128),
    (1, 64, 512, 32, 256),
])
def test_plain_rg_lru_matches_jax_ref(b, s, w, chunk, bw):
    log_a, bb = _scan_inputs(b, s, w, seed=s + w)
    want = jref.rg_lru_scan(jnp.asarray(log_a), jnp.asarray(bb))
    got = ops.rg_lru_scan(torch.as_tensor(log_a), torch.as_tensor(bb),
                          chunk=chunk, block_w=bw)
    np.testing.assert_allclose(got.numpy(), _np(want), **SCAN)


def test_rg_lru_dispatch_and_tiling_rule():
    log_a, bb = (torch.as_tensor(a) for a in _scan_inputs(2, 48, 96, seed=1))
    with pytest.raises(ValueError, match="multiple"):
        ops.rg_lru_scan(log_a, bb, chunk=32, block_w=96)
    with pytest.raises(ValueError, match="multiple"):
        ops.rg_lru_scan(log_a, bb, chunk=48, block_w=64)
    torch.testing.assert_close(ops.rg_lru_scan(log_a, bb, chunk=16,
                                               block_w=32),
                               ref.rg_lru_scan(log_a, bb), rtol=0, atol=0)
    # bf16 b: fp32 math, h in b's dtype
    h16 = ref.rg_lru_scan(log_a, bb.bfloat16())
    assert h16.dtype == torch.bfloat16
    # the CUDA wrapper takes CUDA tensors only: it never runs on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        rglru_kernel.rg_lru_scan(log_a, bb)


@pytest.mark.parametrize("s", [1, 2, 37, 64, 200])
def test_doubling_scan_matches_associative_scan(s):
    log_a, bb = _scan_inputs(2, s, 48, seed=s)
    a = np.exp(log_a)

    def combine(lhs, rhs):
        return lhs[0] * rhs[0], rhs[0] * lhs[1] + rhs[1]

    # jitted: one compile, where run eagerly each level's ops would
    # compile on their own first use
    _, want = jax.jit(lambda a, b: jax.lax.associative_scan(
        combine, (a, b), axis=1))(a, bb)
    got = rglru.linear_scan(torch.as_tensor(a), torch.as_tensor(bb))
    np.testing.assert_allclose(got.numpy(), _np(want), **SCAN)
    np.testing.assert_allclose(got.numpy(), ref.rg_lru_scan(
        torch.as_tensor(log_a), torch.as_tensor(bb)).numpy(), **SCAN)


def _block(dtype, seed=0):
    jcfg = jax_reduced(jax_get_arch("recurrentgemma-2b")).replace(dtype=dtype)
    cfg = reduced(get_arch("recurrentgemma-2b")).replace(dtype=dtype)
    jp, _ = jrglru.rglru_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _acts(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


def _jax_apply(jcfg, jp, x):
    """JAX's plain block: jitted in fp32 (one compile where eager ops
    compile one by one); eager in bf16, where XLA's jit on the CPU may
    keep intermediates wider than the activation dtype."""
    if jcfg.dtype == "float32":
        return jax.jit(lambda p, x: jrglru.apply_rglru(jcfg, p, x))(jp, x)
    return jrglru.apply_rglru(jcfg, jp, x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_rglru_matches_jax(dtype, use_kernel, monkeypatch):
    """Both branches against JAX's associative-scan block; the kernel
    branch also against JAX's kernel branch with its kernel replaced by
    the oracle (the Pallas kernel cannot run here)."""
    from repro.kernels import ops as jops
    cfg, jcfg, tp, jp = _block(dtype)
    x = _acts(cfg, 2, 40, seed=1)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    band = FP32 if dtype == "float32" else BF16
    got = rglru.apply_rglru(cfg, tp, torch.as_tensor(x).to(td),
                            use_kernel=use_kernel)
    want = _jax_apply(jcfg, jp, jnp.asarray(x, jd))
    np.testing.assert_allclose(got.float().numpy(), _np(want), **band)
    if use_kernel:
        monkeypatch.setattr(jops, "rg_lru_scan",
                            lambda log_a, b, **_: jref.rg_lru_scan(log_a, b))
        want_k = jrglru.apply_rglru(jcfg, jp, jnp.asarray(x, jd),
                                    use_kernel=True)
        np.testing.assert_allclose(got.float().numpy(), _np(want_k), **band)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(dtype):
    cfg, jcfg, tp, jp = _block(dtype, seed=2)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    band = FP32 if dtype == "float32" else BF16
    x = _acts(cfg, 2, 33, seed=3)
    jcache = jrglru.init_rglru_cache(jcfg, 2, jd)
    tcache = rglru.init_rglru_cache(cfg, 2, td)
    assert tcache["h"].dtype == torch.float32
    jo, jcache = jrglru.prefill_rglru(jcfg, jp, jnp.asarray(x, jd), jcache)
    to, same = rglru.prefill_rglru(cfg, tp, torch.as_tensor(x).to(td), tcache)
    assert same is tcache
    np.testing.assert_allclose(to.float().numpy(), _np(jo), **band)
    for key in ("h", "conv"):
        np.testing.assert_allclose(tcache[key].float().numpy(),
                                   _np(jcache[key]), **band)
    for step in range(3):
        xs = _acts(cfg, 2, 1, seed=10 + step)
        jo, jcache = jrglru.decode_rglru(jcfg, jp, jnp.asarray(xs, jd), jcache)
        to, _ = rglru.decode_rglru(cfg, tp, torch.as_tensor(xs).to(td), tcache)
        np.testing.assert_allclose(to.float().numpy(), _np(jo), **band)
    np.testing.assert_allclose(tcache["h"].numpy(), _np(jcache["h"]), **band)
