"""Plain PyTorch versions of the port's kernels, in fp32 math.

Ports of ``repro/kernels/ref.py::flash_attention``,
``::paged_decode_attention``, ``::weighted_average_2d`` and
``::fused_adamw_2d``, in the same layouts.  The CPU dispatch in
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
