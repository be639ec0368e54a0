"""Shared building blocks: parameter init, RMSNorm and LayerNorm, RoPE
(standard, partial and Qwen2-VL's three-stream M-RoPE), the gated or
plain MLP (with optional biases).

The PyTorch twin of ``repro/models/layers.py``.  Parameters are plain
dicts of tensors in the JAX package's layout.  Matrices and biases are
cast to the activation dtype on every use, as in the JAX package: serving
stores them in that dtype already, training keeps fp32 master weights.
Norm scales stay fp32, because RMSNorm forms ``1 + scale`` in fp32 before
it rounds to the activation dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch import sharding
from repro_torch.config import ModelConfig

Params = Dict[str, Any]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config dtype string ("bfloat16", ...)."""
    return _DTYPES[name]


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``.  A CUDA device with no card present
    raises: the port never goes on on the CPU unless the caller asks."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return device


@contextlib.contextmanager
def true_fp32():
    """No TF32 in cuDNN convolutions or cuBLAS matmuls inside the block;
    the previous settings are restored after it."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# Param init
# ---------------------------------------------------------------------------


# a stacked leaf of more elements than this is drawn layer by layer
# (2^31: 8 GiB of fp32).  Every config ported before Qwen2.5-32B and
# StableLM-2-12B stays below it (the largest leaf, Gemma-3-12B's embedding,
# has 1,006,632,960), so a seed gives those configs the weights it gave
# them before; Qwen2.5-32B's stacked MLP leaves (64, 5120, 27648) would
# take a 36.2 GB fp32 temporary each drawn whole.  OLMoE-1B-7B's stacked
# expert leaves (16, 64, 2048, 1024) hold exactly 2^31 elements, not more,
# so each is drawn whole (an 8 GiB fp32 temporary); Phi-3.5-MoE's
# (32, 16, 4096, 6400) are drawn layer by layer.
SLICED_DRAW_ELEMENTS = 2 ** 31


def dense_param(gen: torch.Generator, shape: Sequence[int], *,
                layers: int = 0, scale: Optional[float] = None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """A normal-init weight leaf N(0, 1) * scale, drawn in fp32 from
    ``gen`` and stored in ``dtype``.  ``scale`` defaults to
    1/sqrt(shape[0]) (the fan-in, as in the JAX package).  ``layers > 0``
    stacks that many independent draws on a leading layer axis.  A stacked
    leaf above :data:`SLICED_DRAW_ELEMENTS` is drawn one layer at a time
    straight into a tensor of ``dtype``, so its fp32 temporary is one
    layer's; below it the whole leaf is one draw."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    full = ((layers,) if layers else ()) + tuple(shape)
    if layers and math.prod(full) > SLICED_DRAW_ELEMENTS:
        w = torch.empty(full, dtype=dtype, device=device)
        for i in range(layers):
            w[i] = torch.randn(tuple(shape), generator=gen,
                               dtype=torch.float32, device=device).mul_(scale)
        return w
    w = torch.randn(full, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Statistics in fp32, the elementwise path in the activation dtype,
    op by op as the JAX package orders it.

    ``layernorm``: ``(x - mu) * rsqrt(var + eps)``, mean and variance in
    fp32 and each rounded to the activation dtype before it meets ``x``,
    then ``* scale + bias`` (scale initialised to ones, bias to zeros).
    ``F.layer_norm`` would keep fp32 intermediates for a bf16 ``x`` and
    round elsewhere.  ``rmsnorm`` (Gemma's): weight ``(1 + scale)`` formed
    in fp32 then rounded, scale initialised to zeros."""
    dtype = x.dtype
    if cfg.norm == "layernorm":
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        inv = torch.rsqrt(var + cfg.norm_eps)
        y = (x - mu.to(dtype)) * inv.to(dtype)
        return y * p["scale"].to(dtype) + p["bias"].to(dtype)
    if cfg.norm != "rmsnorm":
        raise ValueError(f"unknown norm {cfg.norm!r}")
    ms = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(ms + cfg.norm_eps).to(dtype)
    return x * inv * (1.0 + p["scale"]).to(dtype)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def _rope_dims(cfg: ModelConfig) -> int:
    rot = int(cfg.head_dim * cfg.rope_fraction)
    return rot - (rot % 2)


def rope_freqs(cfg: ModelConfig, device=None) -> torch.Tensor:
    half = _rope_dims(cfg) // 2
    exps = -torch.arange(0, half, dtype=torch.float32, device=device) / half
    return torch.pow(cfg.rope_theta, exps)     # fp32, like theta ** exps in JAX


def _mrope_sections(half: int) -> Tuple[int, int, int]:
    """Qwen2-VL's split of the frequency dims over the temporal, height and
    width streams, about 1 : 1.5 : 1.5 ((16, 24, 24) at head dim 128)."""
    t = half // 4
    h = (half - t) // 2
    return t, h, half - t - h


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: (..., S), or (..., S, 3) under
    ``mrope`` (the temporal, height and width streams, each driving its
    own section of the frequency dims).

    A bf16 ``x`` times the fp32 cos/sin promotes to fp32, as in JAX; the
    rotated half is rounded back to ``x.dtype`` once at the end."""
    if cfg.rope_kind == "none":
        return x
    if cfg.rope_kind not in ("standard", "mrope"):
        raise ValueError(f"unknown rope_kind {cfg.rope_kind!r}")
    rot = _rope_dims(cfg)
    half = rot // 2
    inv = rope_freqs(cfg, x.device)
    if cfg.rope_kind == "mrope":
        sec = torch.cat([positions[..., i:i + 1].expand(
            positions.shape[:-1] + (n,)) for i, n in
            enumerate(_mrope_sections(half))], dim=-1)   # (..., S, half)
        angles = sec.float() * inv
    else:
        angles = positions[..., None].float() * inv      # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def text_positions(batch: int, seq: int, cfg: ModelConfig,
                   device=None) -> torch.Tensor:
    """(batch, seq) int32 absolute positions ``arange(seq)``; under
    ``mrope`` (batch, seq, 3), the three streams equal (text)."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    pos = pos[None, :].expand(batch, seq)
    if cfg.rope_kind == "mrope":
        return pos[..., None].expand(batch, seq, 3)
    return pos


# ---------------------------------------------------------------------------
# MLP (dense, gated)
# ---------------------------------------------------------------------------


def _act(cfg: ModelConfig, g: torch.Tensor) -> torch.Tensor:
    if cfg.activation == "swiglu":
        return F.silu(g)
    if cfg.activation in ("geglu", "gelu"):
        # jax.nn.gelu(approximate=True) is the tanh form
        return F.gelu(g, approximate="tanh")
    raise ValueError(cfg.activation)


def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """The (gated) MLP; with ``mlp_bias`` the up projection takes ``bu``
    and the down projection ``bd``, added in the activation dtype.  On a
    grid whose model axis splits ``ff``, ``wu`` / ``wg`` are this rank's
    columns and ``wd`` its rows: the down projection is a partial sum,
    summed over the model group before ``bd``."""
    dtype = x.dtype
    up = x @ p["wu"].to(dtype)
    if cfg.mlp_bias:
        up = up + p["bu"].to(dtype)
    if cfg.activation in ("swiglu", "geglu"):
        h = _act(cfg, x @ p["wg"].to(dtype)) * up
    else:
        h = _act(cfg, up)
    out = h @ p["wd"].to(dtype)
    if p["wd"].shape[0] != cfg.d_ff:
        out = sharding.model_sum(out)
    if cfg.mlp_bias:
        out = out + p["bd"].to(dtype)
    return out


# ---------------------------------------------------------------------------
# Recurrent blocks' shared pieces
# ---------------------------------------------------------------------------


def causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, x (B,S,C), w (k,C): ``sum_i w[i] *
    x[t - k + 1 + i]`` added in x's dtype in the order i = 0..k-1, as the
    JAX module adds it (``F.conv1d`` would round differently)."""
    k, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + w[i] * pad[:, i:i + s]
    return out


def conv_tail(x: torch.Tensor, k: int) -> torch.Tensor:
    """The conv window a decode step continues from: the last ``k``
    positions of x (B,S,C), zeros before the sequence's start."""
    if x.shape[1] < k:
        x = F.pad(x, (0, 0, k - x.shape[1], 0))
    return x[:, x.shape[1] - k:]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)
