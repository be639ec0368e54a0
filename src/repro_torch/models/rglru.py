"""RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427).

h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t²) ⊙ (i_t ⊙ u_t),
a_t = exp(-c · softplus(Λ) · r_t),   r_t, i_t = sigmoid(gates(u_t)),

wrapped in the Griffin recurrent block: in-proj → causal conv → RG-LRU →
gated out-proj.  The PyTorch twin of ``repro/models/rglru.py``.  A full
sequence runs the recurrence either as a log-depth doubling scan on
tensors (:func:`linear_scan`, the counterpart of JAX's
``lax.associative_scan``: ~log2(S) elementwise passes, where a step loop
would launch ~S of them) or, with ``use_kernel``, through the RG-LRU
kernel (``kernels/ops.py``: the CUDA kernel on the card, its plain
sequential version on the CPU).  Caches are updated in place.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import (causal_conv, conv_tail, dense_param,
                                       softplus)

Params = Dict[str, Any]

_C = 8.0  # Griffin's fixed gate sharpness


def rglru_init(gen: torch.Generator, cfg: ModelConfig, *, layers: int = 0,
               dtype=torch.float32, device=None) -> Params:
    """One recurrent block's params in the JAX layout, ``layers > 0``
    stacked on a leading axis.  Matrices in ``dtype`` except the gate
    matrices ``w_r`` / ``w_i``, which the gates read in fp32; ``lambda``,
    ``b_r`` and ``b_i`` fp32."""
    d, w = cfg.d_model, cfg.lru_width
    lead = (layers,) if layers else ()

    def mat(shape, scale=None, dt=dtype):
        return dense_param(gen, shape, layers=layers, scale=scale, dtype=dt,
                           device=device)

    def fixed(v):
        return v.to(device).expand(lead + v.shape).clone()

    # Λ init so a^(1/r) spans ~[0.9, 0.999]: softplus^-1(-log u / c)
    u = torch.linspace(0.9, 0.999, w, dtype=torch.float32)
    lam = torch.log(torch.expm1(-torch.log(u) / _C))
    k = cfg.lru_conv
    return {
        "wy": mat((d, w)), "wgate": mat((d, w)),
        "conv": mat((k, w), scale=1.0 / math.sqrt(k)),
        "w_r": mat((w, w), dt=torch.float32),
        "w_i": mat((w, w), dt=torch.float32),
        "wo": mat((w, d), scale=1.0 / math.sqrt(w)),
        "lambda": fixed(lam),
        "b_r": fixed(torch.zeros((w,), dtype=torch.float32)),
        "b_i": fixed(torch.zeros((w,), dtype=torch.float32)),
    }


def _gates(p: Params, u: torch.Tensor):
    """Returns (log_a, gated_input), both (B,S,W) fp32."""
    u32 = u.float()
    r = torch.sigmoid(u32 @ p["w_r"].float() + p["b_r"])
    i = torch.sigmoid(u32 @ p["w_i"].float() + p["b_i"])
    log_a = -_C * softplus(p["lambda"]) * r                  # <= 0
    a2 = torch.exp(2.0 * log_a)
    beta = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12))
    return log_a, beta * i * u32


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``h_t = a_t h_{t-1} + b_t`` from h = 0 along axis 1, as an inclusive
    scan of the pairs (a, b) under ``(a1, b1) . (a2, b2) = (a1 a2,
    a2 b1 + b2)`` by recursive doubling: pass d combines every position
    with the one 2^d before it, so ceil(log2(S)) passes of elementwise
    ops.  Returns h in b's dtype."""
    s = a.shape[1]
    d = 1
    while d < s:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def kernel_tiling(w: int, s: int) -> Tuple[int, int]:
    """(chunk, block_w) of the kernel branch, as the JAX module picks them:
    chunk min(128, S), block_w 512 halved until it divides W."""
    bw = 512
    while w % bw:
        bw //= 2
    return min(128, s), max(bw, 1)


def _inputs(p: Params, x: torch.Tensor):
    dtype = x.dtype
    y = x @ p["wy"].to(dtype)
    gate = x @ p["wgate"].to(dtype)
    u = causal_conv(y, p["conv"].to(dtype))
    log_a, b = _gates(p, u)
    return y, gate, log_a, b


def _out(p: Params, h: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    dtype = gate.dtype
    return (h.to(dtype) * F.gelu(gate, approximate="tanh")) @ p["wo"].to(dtype)


def apply_rglru(cfg: ModelConfig, p: Params, x: torch.Tensor,
                use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence Griffin recurrent block.  x: (B,S,D)."""
    _, gate, log_a, b = _inputs(p, x)
    if use_kernel:
        chunk, block_w = kernel_tiling(log_a.shape[-1], log_a.shape[1])
        h = ops.rg_lru_scan(log_a.contiguous(), b.contiguous(), chunk=chunk,
                            block_w=block_w)
    else:
        h = linear_scan(torch.exp(log_a), b)
    return _out(p, h, gate)


def prefill_rglru(cfg: ModelConfig, p: Params, x: torch.Tensor,
                  cache: Params) -> Tuple[torch.Tensor, Params]:
    """Full-sequence block that also fills the decode state, in place: the
    last hidden state (fp32) and the last ``k - 1`` conv inputs.  Runs the
    doubling scan, as the JAX module runs its associative scan."""
    y, gate, log_a, b = _inputs(p, x)
    h = linear_scan(torch.exp(log_a), b)
    cache["h"].copy_(h[:, -1])
    cache["conv"].copy_(conv_tail(y, cfg.lru_conv - 1))
    return _out(p, h, gate), cache


def init_rglru_cache(cfg: ModelConfig, batch: int, dtype,
                     device=None) -> Params:
    w, k = cfg.lru_width, cfg.lru_conv
    return {
        "h": torch.zeros((batch, w), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, k - 1, w), dtype=dtype, device=device),
    }


def decode_rglru(cfg: ModelConfig, p: Params, x: torch.Tensor,
                 cache: Params) -> Tuple[torch.Tensor, Params]:
    """One-token step, x (B,1,D); the cache is updated in place."""
    dtype = x.dtype
    y = x @ p["wy"].to(dtype)                                   # (B,1,W)
    gate = x @ p["wgate"].to(dtype)
    full = torch.cat([cache["conv"], y], dim=1)                  # (B,k,W)
    u = torch.einsum("bkc,kc->bc", full, p["conv"].to(dtype))[:, None]
    log_a, b = _gates(p, u)
    h = torch.exp(log_a[:, 0]) * cache["h"] + b[:, 0]            # (B,W) fp32
    cache["h"].copy_(h)
    cache["conv"].copy_(full[:, 1:])
    return _out(p, h[:, None], gate), cache
