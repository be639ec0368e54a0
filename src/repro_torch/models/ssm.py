"""Mamba-2 SSD block (state-space duality, arXiv:2405.21060).

The PyTorch twin of ``repro/models/ssm.py``.  A full sequence runs either
the *chunked* SSD algorithm in plain PyTorch (:func:`ssd_chunked`: the
intra-chunk attention-like products and the inter-chunk state recurrence,
with the JAX module's casts to the activation dtype) or, with
``use_kernel``, the SSD scan kernel through ``kernels/ops.py`` (the CUDA
kernel on the card, its plain sequential version on the CPU; fp32 inside,
one cast at the end).  Decode carries the (B, H, N, P) state and the
conv windows.  Caches are updated in place.

All decays are exp of non-positive numbers (A < 0), so fp32 math is stable
without rescaling.
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


def ssm_init(gen: torch.Generator, cfg: ModelConfig, *, layers: int = 0,
             dtype=torch.float32, device=None) -> Params:
    """One SSD block's params in the JAX layout, ``layers > 0`` stacked on
    a leading axis.  Matrices in ``dtype``; ``A_log``, ``D``, ``dt_bias``
    and ``norm_scale`` fp32 (the block reads them in fp32)."""
    d, di, st, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    lead = (layers,) if layers else ()

    def w(shape, scale=None):
        return dense_param(gen, shape, layers=layers, scale=scale,
                           dtype=dtype, device=device)

    def fixed(v):
        return v.to(device).expand(lead + v.shape).clone()

    k = cfg.ssm_conv
    return {
        "wz": w((d, di)), "wx": w((d, di)), "wB": w((d, st)),
        "wC": w((d, st)), "wdt": w((d, nh)),
        "wo": w((di, d), scale=1.0 / math.sqrt(di)),
        "conv_x": w((k, di), scale=1.0 / math.sqrt(k)),
        "conv_BC": w((k, 2 * st), scale=1.0 / math.sqrt(k)),
        # -exp(A_log) spans [-16, -1]: the standard Mamba-2 init
        "A_log": fixed(torch.log(torch.linspace(1.0, 16.0, nh,
                                                dtype=torch.float32))),
        "D": fixed(torch.ones((nh,), dtype=torch.float32)),
        "dt_bias": fixed(torch.zeros((nh,), dtype=torch.float32)),
        "norm_scale": fixed(torch.ones((di,), dtype=torch.float32)),
    }


def _gated_norm(p: Params, y: torch.Tensor, z: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """Mamba2 RMSNorm-gated output: norm(y) * silu(z)."""
    y32 = y.float()
    ms = y32.square().mean(dim=-1, keepdim=True)
    n = (y32 * torch.rsqrt(ms + eps) * p["norm_scale"]).to(y.dtype)
    return n * F.silu(z)


def _project(p: Params, x: torch.Tensor):
    dtype = x.dtype
    z = x @ p["wz"].to(dtype)
    xin = x @ p["wx"].to(dtype)
    bc = torch.cat([x @ p["wB"].to(dtype), x @ p["wC"].to(dtype)], -1)
    dt_raw = x @ p["wdt"].to(dtype)
    return z, xin, bc, dt_raw


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B_: torch.Tensor, C_: torch.Tensor, chunk: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The SSD algorithm.  x (B,S,H,P) head inputs; dt (B,S,H) positive
    step sizes; A (H,) < 0; B_, C_ (B,S,N) shared across heads.  Returns
    y (B,S,H,P) and the final state (B,H,N,P), both in x's dtype.

    Casts follow the JAX module: the intra-chunk weights and the
    dt-weighted decays are rounded to x's dtype before their products, and
    the inter-chunk state is carried in x's dtype."""
    b, s, h, pdim = x.shape
    n = B_.shape[-1]
    q = min(chunk, s)
    if s % q:
        raise ValueError(f"ssd_chunked: sequence {s} is not a multiple of "
                         f"the chunk {q}")
    nc = s // q
    dtype = x.dtype
    xr = x.reshape(b, nc, q, h, pdim)
    dtr = dt.reshape(b, nc, q, h).float()
    br = B_.reshape(b, nc, q, n)
    cr = C_.reshape(b, nc, q, n)
    cum = torch.cumsum(dtr * A, dim=2)                  # (B,nc,Q,H), <= 0
    cum_end = cum[:, :, -1]                              # (B,nc,H)

    # ---- intra-chunk (attention-like dense path) ----
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]       # (B,nc,Qi,Qj,H)
    tri = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    # mask BEFORE exp: the upper triangle's diffs are positive and overflow
    L = torch.exp(diff.masked_fill(~tri[None, None, :, :, None],
                                   -math.inf))
    cb = torch.einsum("bcin,bcjn->bcij", cr, br).float()       # (B,nc,Qi,Qj)
    att = cb[..., None] * L * dtr[:, :, None, :, :]            # (B,nc,Qi,Qj,H)
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", att.to(dtype), xr)

    # ---- chunk states ----
    decay_to_end = torch.exp(cum_end[:, :, None, :] - cum)     # (B,nc,Q,H)
    wx = (decay_to_end * dtr).to(dtype)[..., None] * xr        # (B,nc,Q,H,P)
    sbx = torch.einsum("bcqn,bcqhp->bchnp", br, wx)           # (B,nc,H,N,P)

    # ---- inter-chunk recurrence, the state in x's dtype ----
    chunk_decay = torch.exp(cum_end).to(dtype)                 # (B,nc,H)
    state = torch.zeros((b, h, n, pdim), dtype=dtype, device=x.device)
    prev = torch.empty((b, nc, h, n, pdim), dtype=dtype, device=x.device)
    for c in range(nc):
        prev[:, c] = state
        state = state * chunk_decay[:, c, :, None, None] + sbx[:, c]

    # y_inter_i = exp(cum_i) * C_i . prev_state
    y_inter = torch.einsum("bcqn,bchnp->bcqhp", cr, prev) * torch.exp(
        cum)[..., None].to(dtype)
    y = (y_intra + y_inter).reshape(b, s, h, pdim)
    return y, state


def kernel_tiling(cfg: ModelConfig) -> Tuple[int, int]:
    """(chunk, block_h) of the kernel branch, as the JAX module picks them:
    chunk min(ssm_chunk, 128), block_h the largest divisor of the heads
    not above 8."""
    nh = cfg.ssm_heads
    block_h = max(1, min(8, nh))
    while nh % block_h:
        block_h -= 1
    return min(cfg.ssm_chunk, 128), block_h


def _ssm_full(cfg: ModelConfig, p: Params, x: torch.Tensor,
              use_kernel: bool = False):
    b, s, _ = x.shape
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dtype = x.dtype
    z, xin_raw, bc_raw, dt_raw = _project(p, x)
    xin = F.silu(causal_conv(xin_raw, p["conv_x"].to(dtype)))
    bc = F.silu(causal_conv(bc_raw, p["conv_BC"].to(dtype)))
    B_, C_ = bc[..., :st], bc[..., st:]
    dt = softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = xin.reshape(b, s, nh, hd)
    if use_kernel:
        chunk, block_h = kernel_tiling(cfg)
        y = ops.ssd_scan(xh.contiguous(), dt.contiguous(), A.contiguous(),
                         B_.contiguous(), C_.contiguous(), chunk=chunk,
                         block_h=block_h)
        final = None
    else:
        y, final = ssd_chunked(xh, dt, A, B_, C_, cfg.ssm_chunk)
    y = y + p["D"].to(dtype)[:, None] * xh
    y = y.reshape(b, s, di)
    out = _gated_norm(p, y, z) @ p["wo"].to(dtype)
    return out, final, xin_raw, bc_raw


def apply_ssm(cfg: ModelConfig, p: Params, x: torch.Tensor,
              use_kernel: bool = False) -> torch.Tensor:
    """Full-sequence Mamba2 block.  x: (B,S,D)."""
    out, _, _, _ = _ssm_full(cfg, p, x, use_kernel=use_kernel)
    return out


def prefill_ssm(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Params
                ) -> Tuple[torch.Tensor, Params]:
    """Full-sequence block that also fills the decode cache, in place: the
    final state and the last ``k - 1`` conv inputs.  Runs the chunked
    plain path, which yields the final state (the kernel returns none)."""
    out, final, xin_raw, bc_raw = _ssm_full(cfg, p, x)
    k = cfg.ssm_conv
    cache["state"].copy_(final)
    cache["conv_x"].copy_(conv_tail(xin_raw, k - 1))
    cache["conv_BC"].copy_(conv_tail(bc_raw, k - 1))
    return out, cache


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype,
                   device=None) -> Params:
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    k = cfg.ssm_conv
    return {
        "state": torch.zeros((batch, nh, st, hd), dtype=dtype, device=device),
        "conv_x": torch.zeros((batch, k - 1, di), dtype=dtype, device=device),
        "conv_BC": torch.zeros((batch, k - 1, 2 * st), dtype=dtype,
                               device=device),
    }


def decode_ssm(cfg: ModelConfig, p: Params, x: torch.Tensor, cache: Params
               ) -> Tuple[torch.Tensor, Params]:
    """One-token step, x (B,1,D); the cache is updated in place."""
    b = x.shape[0]
    di, st, nh, hd = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    dtype = x.dtype
    z, xin, bc, dt_raw = _project(p, x)
    full_x = torch.cat([cache["conv_x"], xin], dim=1)            # (B,k,di)
    full_bc = torch.cat([cache["conv_BC"], bc], dim=1)
    xin1 = F.silu(torch.einsum("bkc,kc->bc", full_x, p["conv_x"].to(dtype)))
    bc1 = F.silu(torch.einsum("bkc,kc->bc", full_bc, p["conv_BC"].to(dtype)))
    B_, C_ = bc1[..., :st], bc1[..., st:]
    dt = softplus(dt_raw[:, 0].float() + p["dt_bias"])           # (B,nh)
    A = -torch.exp(p["A_log"])
    dA = torch.exp(dt * A).to(dtype)                              # (B,nh)
    xh = xin1.reshape(b, nh, hd)
    state = cache["state"] * dA[..., None, None] + (
        dt.to(dtype)[..., None, None] * B_[:, None, :, None]
        * xh[:, :, None, :])                                      # (B,nh,st,hd)
    y = torch.einsum("bn,bhnp->bhp", C_, state) + p["D"].to(dtype)[:, None] * xh
    y = y.reshape(b, 1, di)
    out = _gated_norm(p, y, z) @ p["wo"].to(dtype)
    cache["state"].copy_(state)
    cache["conv_x"].copy_(full_x[:, 1:])
    cache["conv_BC"].copy_(full_bc[:, 1:])
    return out, cache
