"""The port's Mamba-2 SSD pieces against ``repro.models.ssm`` and
``repro.kernels.ref.ssd_scan``, on the same numpy inputs and bridged
params, at the reduced Mamba-2 size (d_model 256, 16 heads of 32, state
32, chunk 32).

Tolerances: the plain scan against the JAX oracle as
``tests/test_kernels.py`` holds the TPU kernel (fp32 atol 5e-4 / rtol
1e-3; bf16 0.15 / 0.05); fp32 module outputs atol = rtol = 1e-4 (same fp32
math, other summation order; measured gaps ~1e-5); bf16 module outputs
atol = rtol = 5e-2 (both sides round to bf16 after every op, in places a
different order: measured 1–3 bf16 ulps at |y| ~ 3–10).
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
from repro.models import ssm as jssm
from repro_torch._bridge import params_from_jax
from repro_torch.config import get_arch, reduced
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssd_scan as ssd_kernel
from repro_torch.models import ssm

SCAN_FP32 = dict(atol=5e-4, rtol=1e-3)
SCAN_BF16 = dict(atol=0.15, rtol=0.05)
FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


def _scan_inputs(b, s, h, p, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = rng.uniform(0.01, 0.5, size=(b, s, h)).astype(np.float32)
    a = -rng.uniform(0.5, 4.0, size=(h,)).astype(np.float32)
    b_ = rng.normal(size=(b, s, n)).astype(np.float32)
    c_ = rng.normal(size=(b, s, n)).astype(np.float32)
    return x, dt, a, b_, c_


def _both(arrays, dtype):
    """(JAX arrays, torch tensors) of x, dt, a, b_, c_; x, b_ and c_ in
    ``dtype``, dt and a fp32."""
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    cast = (True, False, False, True, True)
    j = [jnp.asarray(v, jd if c else jnp.float32) for v, c in zip(arrays, cast)]
    t = [torch.as_tensor(v).to(td if c else torch.float32)
         for v, c in zip(arrays, cast)]
    return j, t


def _np(x):
    return np.asarray(x, dtype=np.float32)


# the shape sweep of tests/test_kernels.py::test_ssd_scan_sweep
@pytest.mark.parametrize("b,s,h,p,n,chunk,bh", [
    (1, 128, 4, 32, 16, 64, 4),
    (2, 256, 8, 64, 32, 128, 4),
    (1, 64, 2, 16, 8, 32, 2),
])
def test_plain_ssd_scan_matches_jax_ref(b, s, h, p, n, chunk, bh):
    (jx, jt) = _both(_scan_inputs(b, s, h, p, n, seed=s + h), "float32")
    want = jref.ssd_scan(*jx)
    got = ops.ssd_scan(*jt, chunk=chunk, block_h=bh)
    np.testing.assert_allclose(got.numpy(), _np(want), **SCAN_FP32)


def test_plain_ssd_scan_bf16_matches_jax_ref():
    jx, jt = _both(_scan_inputs(1, 128, 4, 32, 16, seed=5), "bfloat16")
    want = jref.ssd_scan(*jx)
    got = ref.ssd_scan(*jt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), _np(want), **SCAN_BF16)


def test_ssd_scan_dispatch_and_tiling_rule():
    _, jt = _both(_scan_inputs(1, 96, 4, 16, 8, seed=6), "float32")
    # the TPU kernel's rule: S a multiple of min(chunk, S), H of block_h
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(*jt, chunk=64, block_h=4)
    with pytest.raises(ValueError, match="multiple"):
        ops.ssd_scan(*jt, chunk=32, block_h=3)
    torch.testing.assert_close(ops.ssd_scan(*jt, chunk=32, block_h=4),
                               ref.ssd_scan(*jt), rtol=0, atol=0)
    # the CUDA wrapper takes CUDA tensors only: it never runs on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        ssd_kernel.ssd_scan(*jt)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_jax(dtype):
    jx, jt = _both(_scan_inputs(2, 96, 4, 16, 8, seed=7), dtype)
    jy, jfinal = jssm.ssd_chunked(*jx, chunk=32)
    ty, tfinal = ssm.ssd_chunked(*jt, chunk=32)
    assert ty.dtype == tfinal.dtype == getattr(torch, dtype)
    band = FP32 if dtype == "float32" else BF16
    np.testing.assert_allclose(ty.float().numpy(), _np(jy), **band)
    np.testing.assert_allclose(tfinal.float().numpy(), _np(jfinal), **band)
    # the chunked SSD form and the step-by-step recurrence agree
    np.testing.assert_allclose(ty.float().numpy(),
                               ref.ssd_scan(*jt).float().numpy(),
                               **(SCAN_FP32 if dtype == "float32"
                                  else SCAN_BF16))
    with pytest.raises(ValueError, match="multiple"):
        ssm.ssd_chunked(*[t[:, :80] if t.dim() > 1 else t for t in jt],
                        chunk=32)


def _block(dtype, seed=0):
    jcfg = jax_reduced(jax_get_arch("mamba2-370m")).replace(dtype=dtype)
    cfg = reduced(get_arch("mamba2-370m")).replace(dtype=dtype)
    jp, _ = jssm.ssm_init(jax.random.PRNGKey(seed), jcfg)
    tp = params_from_jax(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return cfg, jcfg, tp, jp


def _acts(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(b, s, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_kernel", [False, True])
def test_apply_ssm_matches_jax(dtype, use_kernel, monkeypatch):
    """Both branches against JAX's plain (chunked) block; the kernel branch
    also against JAX's kernel branch with its kernel replaced by the
    oracle (the Pallas kernel cannot run here)."""
    from repro.kernels import ops as jops
    cfg, jcfg, tp, jp = _block(dtype)
    x = _acts(cfg, 2, 64, seed=1)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    band = FP32 if dtype == "float32" else BF16
    got = ssm.apply_ssm(cfg, tp, torch.as_tensor(x).to(td),
                        use_kernel=use_kernel)
    want = jssm.apply_ssm(jcfg, jp, jnp.asarray(x, jd))
    np.testing.assert_allclose(got.float().numpy(), _np(want), **band)
    if use_kernel:
        monkeypatch.setattr(jops, "ssd_scan",
                            lambda x, dt, a, b_, c_, **_: jref.ssd_scan(
                                x, dt, a, b_, c_))
        want_k = jssm.apply_ssm(jcfg, jp, jnp.asarray(x, jd), use_kernel=True)
        np.testing.assert_allclose(got.float().numpy(), _np(want_k), **band)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_then_decode_matches_jax(dtype):
    """prefill_ssm fills the cache (state, conv windows) as JAX's does, and
    three decode steps from it match JAX's step for step."""
    cfg, jcfg, tp, jp = _block(dtype, seed=2)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    band = FP32 if dtype == "float32" else BF16
    x = _acts(cfg, 2, 64, seed=3)
    jcache = jssm.init_ssm_cache(jcfg, 2, jd)
    tcache = ssm.init_ssm_cache(cfg, 2, td)
    jo, jcache = jssm.prefill_ssm(jcfg, jp, jnp.asarray(x, jd), jcache)
    to, same = ssm.prefill_ssm(cfg, tp, torch.as_tensor(x).to(td), tcache)
    assert same is tcache
    np.testing.assert_allclose(to.float().numpy(), _np(jo), **band)
    for key in ("state", "conv_x", "conv_BC"):
        np.testing.assert_allclose(tcache[key].float().numpy(),
                                   _np(jcache[key]), **band)
    for step in range(3):
        xs = _acts(cfg, 2, 1, seed=10 + step)
        jo, jcache = jssm.decode_ssm(jcfg, jp, jnp.asarray(xs, jd), jcache)
        to, _ = ssm.decode_ssm(cfg, tp, torch.as_tensor(xs).to(td), tcache)
        np.testing.assert_allclose(to.float().numpy(), _np(jo), **band)
    np.testing.assert_allclose(tcache["state"].float().numpy(),
                               _np(jcache["state"]), **band)


def test_prefill_of_a_short_prompt_pads_the_conv_window():
    """A prompt shorter than the conv window leaves zeros before its start,
    as the zero-padded conv reads them."""
    cfg, _, tp, _ = _block("float32")
    x = torch.as_tensor(_acts(cfg, 1, 2, seed=4))
    cache = ssm.init_ssm_cache(cfg, 1, torch.float32)
    ssm.prefill_ssm(cfg, tp, x, cache)
    assert cache["conv_x"].shape == (1, cfg.ssm_conv - 1, cfg.d_inner)
    assert torch.count_nonzero(cache["conv_x"][:, 0]) == 0
    torch.testing.assert_close(cache["conv_x"][:, 1:],
                               x @ tp["wx"], rtol=0, atol=0)
