"""Plain PyTorch versions of the port's kernels, in fp32 math.

Ports of ``repro/kernels/ref.py::flash_attention``,
``::paged_decode_attention``, ``::ssd_scan``, ``::rg_lru_scan``,
``::weighted_average_2d``, ``::fused_adamw_2d``,
``::quantize_stochastic_2d``, ``::dequantize_2d`` and ``::topk_mask_2d``,
in the same layouts.  The CPU dispatch in
``kernels/ops.py`` runs these; ``chip_smoke.py`` holds each CUDA kernel
against them on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None) -> torch.Tensor:
    """q: (B,Hq,Sq,hd); k,v: (B,Hkv,Sk,hd) -> (B,Hq,Sq,hd).  Positions are
    ``arange`` from 0 on both sides; q head h reads kv head h // g."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    kk = k.repeat_interleave(g, dim=1).float()
    vv = v.repeat_interleave(g, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    qp = torch.arange(sq, device=q.device)[:, None]
    kp = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window is not None:
        mask &= (qp - kp) < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, vv).to(q.dtype)


def paged_decode_attention(q: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, ppos: torch.Tensor,
                           table: torch.Tensor, pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           logit_softcap: Optional[float] = None
                           ) -> torch.Tensor:
    """One-token attention against a paged KV pool, via the full gather.

    q: (B, Hq, hd); pk/pv: (NB, bs, Hkv, hd); ppos: (NB, bs);
    table: (B, nb); pos: (B,) -> (B, Hq, hd).

    Valid entries satisfy ``0 <= ppos <= pos[b]``; invalid ones get
    probability exactly 0, so a row with no valid entry returns exactly 0.
    The gather attends the whole table; the kernel skips logical blocks past
    ``pos[b] // bs``, so the two agree whenever those blocks hold no valid
    entry (the engine keeps it so)."""
    b, hq, hd = q.shape
    _, bs, hkv, _ = pk.shape
    nb = table.shape[1]
    g = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    tab = table.long()
    kc = pk[tab].reshape(b, nb * bs, hkv, hd).float()
    vc = pv[tab].reshape(b, nb * bs, hkv, hd).float()
    pc = ppos[tab].reshape(b, nb * bs)
    qg = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bkgd,bskd->bkgs", qg, kc) * scale
    if logit_softcap is not None:
        s = logit_softcap * torch.tanh(s / logit_softcap)
    valid = ((pc >= 0) & (pc <= pos[:, None]))[:, None, None, :]
    s = s.masked_fill(~valid, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), torch.zeros((), device=q.device))
    l = p.sum(dim=-1).clamp_min(1e-30)
    out = torch.einsum("bkgs,bskd->bkgd", p, vc) / l[..., None]
    return out.reshape(b, hq, hd).to(q.dtype)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_: torch.Tensor, c_: torch.Tensor) -> torch.Tensor:
    """The SSD recurrence step by step, in fp32: x (B,S,H,P); dt (B,S,H);
    a (H,); b_, c_ (B,S,N) -> y (B,S,H,P) in x's dtype.  The state
    starts at zero; per step ``state = exp(dt a) state + dt B (x) x`` and
    ``y = C . state``."""
    bsz, s, h, p = x.shape
    n = b_.shape[-1]
    a32 = a.float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = torch.empty((bsz, s, h, p), dtype=torch.float32, device=x.device)
    xf, dtf, bf, cf = x.float(), dt.float(), b_.float(), c_.float()
    for t in range(s):
        xt, dtt, bt, ct = xf[:, t], dtf[:, t], bf[:, t], cf[:, t]
        da = torch.exp(dtt * a32)
        state = state * da[..., None, None] + (
            dtt[..., None, None] * bt[:, None, :, None] * xt[:, :, None, :])
        ys[:, t] = torch.einsum("bn,bhnp->bhp", ct, state)
    return ys.to(x.dtype)


def rg_lru_scan(log_a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The LRU recurrence step by step, in fp32: ``h_t = exp(la_t) h_{t-1}
    + b_t`` from h = 0; log_a, b (B,S,W) -> h in b's dtype.  Each step
    rounds the exp, the product and the sum once each, as the CUDA
    kernel does."""
    la, bf = log_a.float(), b.float()
    h = torch.zeros_like(bf[:, 0])
    hs = torch.empty_like(bf)
    for t in range(b.shape[1]):
        h = torch.exp(la[:, t]) * h + bf[:, t]
        hs[:, t] = h
    return hs.to(b.dtype)


def weighted_average_2d(stacked: torch.Tensor,
                        weights: torch.Tensor) -> torch.Tensor:
    """(N, M) x (N,) -> (M,): an fp32 matrix product, rounded once to the
    stack's dtype."""
    return (weights.float() @ stacked.float()).to(stacked.dtype)


def fused_adamw_2d(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                   v: torch.Tensor, mask: Optional[torch.Tensor],
                   scalars: torch.Tensor):
    """Masked AdamW over (N, M) leaves -> new (p', m', v').

    p, g: (N, M); m, v: (N, M) fp32; mask: (N,) or None (every row on);
    scalars: (9,) fp32 ``[lr, b1, b2, 1-b1, 1-b2, eps, wd, bc1, bc2]``.
    One PyTorch op per step of the JAX oracle, in its order, with the
    hyper-parameters as fp32 tensors on the data's device (a Python scalar
    divisor would make CUDA multiply by its reciprocal), so fp32 results
    are those of the CUDA kernel bit for bit."""
    s = scalars.to(device=p.device, dtype=torch.float32)
    lr, b1, b2, omb1, omb2 = s[0], s[1], s[2], s[3], s[4]
    eps, wd, bc1, bc2 = s[5], s[6], s[7], s[8]
    p32 = p.float()
    g32 = g.float()
    m32 = m.float()
    v32 = v.float()
    m_new = b1 * m32 + omb1 * g32
    v_new = b2 * v32 + omb2 * torch.square(g32)
    mhat = m_new / bc1
    vhat = v_new / bc2
    p_new = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p32)
    if mask is None:
        mk = torch.ones((p.shape[0], 1), dtype=torch.float32, device=p.device)
    else:
        mk = mask.float()[:, None]
    return ((mk * p_new + (1 - mk) * p32).to(p.dtype),
            mk * m_new + (1 - mk) * m32,
            mk * v_new + (1 - mk) * v32)


# elements per chunk of the exact fp32 fused multiply-add (its float64
# temporaries stay ~1 GB however large the leaf)
_FMA_CHUNK = 1 << 24


def _fma_f32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
             ) -> torch.Tensor:
    """fp32 ``a * b + c`` rounded once, as CUDA's ``fmaf``: a, c (N, M)
    fp32, b (N, 1) fp32.

    The product of two fp32 values is exact in float64 and TwoSum gives
    the float64 sum's exact error ``e``.  Rounding the float64 sum to fp32
    is then the correctly rounded result except where the sum lands
    exactly on a midpoint between two fp32 values; there the sign of ``e``
    picks the side."""
    inf = torch.tensor(math.inf, dtype=torch.float32, device=a.device)
    p = a.double() * b.double()
    cd = c.double()
    s = p + cd
    z = s - p
    e = (p - (s - z)) + (cd - z)
    r = s.float()
    up = torch.nextafter(r, inf)
    dn = torch.nextafter(r, -inf)
    rd = r.double()
    r = torch.where((s == (rd + up.double()) * 0.5) & (e > 0), up, r)
    return torch.where((s == (rd + dn.double()) * 0.5) & (e < 0), dn, r)


def quantize_stochastic_2d(x: torch.Tensor, u: torch.Tensor,
                           inv_step: torch.Tensor, levels) -> torch.Tensor:
    """Stochastic symmetric quantization: x, u (N, M); inv_step (N,) =
    levels / scale (0 for an all-zero row) -> int8 codes
    ``clip(floor(x * inv_step + u), -levels, levels)``.

    The pre-floor value is rounded once (:func:`_fma_f32`), as the CUDA
    kernel's ``fmaf`` and the JAX oracle under XLA (which contracts the
    multiply-add) compute it: rounding the product first moves a value
    across an integer about once in 8 M elements."""
    n, m = x.shape
    out = torch.empty((n, m), dtype=torch.int8, device=x.device)
    if m == 0:
        return out
    lv = float(levels)
    inv = inv_step.float()[:, None]
    step = max(1, _FMA_CHUNK // max(n, 1))
    for c0 in range(0, m, step):
        sl = slice(c0, min(c0 + step, m))
        pre = _fma_f32(x[:, sl].float(), inv, u[:, sl].float())
        out[:, sl] = torch.clamp(torch.floor(pre), -lv, lv).to(torch.int8)
    return out


def dequantize_2d(q: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """q (N, M) int8 codes; step (N,) = scale / levels -> fp32 q * step."""
    return q.float() * step.float()[:, None]


def topk_mask_2d(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """Zero every entry whose magnitude is below its row's threshold:
    x (N, M); thresh (N,) -> x's dtype."""
    xf = x.float()
    return torch.where(xf.abs() >= thresh.float()[:, None], xf,
                       torch.zeros((), dtype=torch.float32, device=x.device)
                       ).to(x.dtype)
