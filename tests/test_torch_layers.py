"""The port's config copy and building blocks against the JAX package.

Inputs come from numpy seeds and go through ``repro.models.layers`` and
``repro_torch.models.layers`` alike.  Tolerances: fp32 atol = rtol = 1e-4
(both sides compute the same fp32 ops; measured gaps are ~1e-6); the bf16
case uses atol = rtol = 5e-2, since both sides round the same values to
bf16 (8 significant bits) at slightly different points.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401
from repro.config import get_arch as jax_get_arch
from repro.config import reduced as jax_reduced
from repro.models import layers as jl
from repro_torch.config import get_arch, reduced
from repro_torch.models import layers as tl

FP32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=5e-2, rtol=5e-2)


def _cfgs(dtype="float32"):
    return (reduced(get_arch("gemma-2b")).replace(dtype=dtype),
            jax_reduced(jax_get_arch("gemma-2b")).replace(dtype=dtype))


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_config_copy_matches_jax(size):
    cfg, jcfg = get_arch("gemma-2b"), jax_get_arch("gemma-2b")
    if size == "reduced":
        cfg, jcfg = reduced(cfg), jax_reduced(jcfg)
    ours = dataclasses.asdict(cfg)
    theirs = dataclasses.asdict(jcfg)
    assert ours == {k: theirs[k] for k in ours}
    assert [s.signature() for s in cfg.layer_specs()] == \
        [s.signature() for s in jcfg.layer_specs()]
    assert cfg.period == jcfg.period


def test_rmsnorm_matches_jax():
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    scale = (0.1 * rng.normal(size=(cfg.d_model,))).astype(np.float32)
    want = np.asarray(jl.apply_norm(jcfg, {"scale": jnp.asarray(scale)},
                                    jnp.asarray(x)))
    got = tl.apply_norm(cfg, {"scale": torch.as_tensor(scale)},
                        torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def test_rope_matches_jax():
    cfg, jcfg = _cfgs()
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    pos = (np.arange(7)[None, :] + np.array([[0], [300]])).astype(np.int32)
    want = np.asarray(jl.apply_rope(jcfg, jnp.asarray(x), jnp.asarray(pos)))
    got = tl.apply_rope(cfg, torch.as_tensor(x), torch.as_tensor(pos))
    np.testing.assert_allclose(got.numpy(), want, **FP32)


def _mlp_params(cfg, rng):
    d, f = cfg.d_model, cfg.d_ff
    return {"wg": (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32),
            "wu": (rng.normal(size=(d, f)) / np.sqrt(d)).astype(np.float32),
            "wd": (rng.normal(size=(f, d)) / np.sqrt(f)).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_geglu_mlp_matches_jax(dtype):
    cfg, jcfg = _cfgs(dtype)
    rng = np.random.default_rng(2)
    p = _mlp_params(cfg, rng)
    x = rng.normal(size=(2, 5, cfg.d_model)).astype(np.float32)
    want = np.asarray(jl.apply_mlp(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()},
        jnp.asarray(x).astype(jnp.dtype(dtype))).astype(jnp.float32))
    tdt = tl.torch_dtype(dtype)
    got = tl.apply_mlp(cfg, {k: torch.as_tensor(v).to(tdt) for k, v in p.items()},
                       torch.as_tensor(x).to(tdt)).float()
    np.testing.assert_allclose(got.numpy(), want,
                               **(FP32 if dtype == "float32" else BF16))


def test_softcap_matches_jax():
    x = np.linspace(-200, 200, 101).astype(np.float32)
    want = np.asarray(jl.softcap(jnp.asarray(x), 30.0))
    np.testing.assert_allclose(tl.softcap(torch.as_tensor(x), 30.0).numpy(),
                               want, **FP32)
    t = torch.as_tensor(x)
    assert torch.equal(tl.softcap(t, None), t)
