"""Shared building blocks: parameter init, RMSNorm, RoPE, the gated MLP.

The PyTorch twin of ``repro/models/layers.py``.  Parameters are plain
dicts of tensors in the JAX package's layout.  Matrices are cast to the
activation dtype on every use, as in the JAX package: serving stores them
in that dtype already, training keeps fp32 master weights.  Norm scales
stay fp32, because the norm forms ``1 + scale`` in fp32 before it rounds
to the activation dtype.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, Optional, Sequence

import torch
import torch.nn.functional as F

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


def dense_param(gen: torch.Generator, shape: Sequence[int], *,
                layers: int = 0, scale: Optional[float] = None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """A normal-init weight leaf N(0, 1) * scale, drawn in fp32 from
    ``gen`` and stored in ``dtype``.  ``scale`` defaults to
    1/sqrt(shape[0]) (the fan-in, as in the JAX package).  ``layers > 0``
    stacks that many independent draws on a leading layer axis."""
    if scale is None:
        fan_in = shape[0] if len(shape) > 1 else shape[-1]
        scale = 1.0 / math.sqrt(max(fan_in, 1))
    full = ((layers,) if layers else ()) + tuple(shape)
    w = torch.randn(full, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Gemma RMSNorm: statistics in fp32, the elementwise path in the
    activation dtype, weight ``(1 + scale)`` formed in fp32 then rounded."""
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(
            f"norm {cfg.norm!r} is not ported yet (ROADMAP Queue 1, item 11: "
            f"the other model families)")
    dtype = x.dtype
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


def apply_rope(cfg: ModelConfig, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, head_dim); positions: (..., S).

    A bf16 ``x`` times the fp32 cos/sin promotes to fp32, as in JAX; the
    rotated half is rounded back to ``x.dtype`` once at the end."""
    if cfg.rope_kind == "none":
        return x
    if cfg.rope_kind != "standard":
        raise NotImplementedError(
            f"rope_kind {cfg.rope_kind!r} is not ported yet (ROADMAP "
            f"Queue 1, item 11: models/frontend.py and M-RoPE)")
    rot = _rope_dims(cfg)
    half = rot // 2
    inv = rope_freqs(cfg, x.device)
    angles = positions[..., None].float() * inv          # (..., S, half)
    cos = torch.cos(angles)[..., None, :]                # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    out = out.to(x.dtype)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out


def text_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """(batch, seq) int32 absolute positions ``arange(seq)``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)
    return pos[None, :].expand(batch, seq)


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
    if cfg.mlp_bias:
        raise NotImplementedError(
            "MLP biases are not ported yet (ROADMAP Queue 1, item 11: the "
            "other model families)")
    dtype = x.dtype
    up = x @ p["wu"].to(dtype)
    if cfg.activation in ("swiglu", "geglu"):
        h = _act(cfg, x @ p["wg"].to(dtype)) * up
    else:
        h = _act(cfg, up)
    return h @ p["wd"].to(dtype)


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
