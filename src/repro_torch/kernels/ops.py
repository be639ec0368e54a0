"""Kernel dispatch by the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel, or raises.  Nothing here catches
a build or launch failure, and no CUDA tensor is ever handed to the plain
version.  Every wrapper takes the model-layer layouts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import compress as _comp
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fused_adam as _fadam
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref
from repro_torch.kernels import rg_lru as _rglru
from repro_torch.kernels import ssd_scan as _ssd
from repro_torch.kernels import wavg as _wavg

# kernel -> (wrapper module, its launch counter)
_COUNTED = {"flash_attention": (_fa, "launches"),
            "paged_decode_attention": (_pa, "launches"),
            "ssd_scan": (_ssd, "launches"),
            "rg_lru_scan": (_rglru, "launches"),
            "fused_adamw": (_fadam, "launches"),
            "weighted_average": (_wavg, "launches"),
            "quantize_stochastic": (_comp, "quantize_launches"),
            "dequantize": (_comp, "dequantize_launches"),
            "topk_mask": (_comp, "topk_launches")}
# launches by body, beside the counts above: the flash kernel's tensor-core
# body (bf16), the paged kernel's split-K pair and the SSD scan's
# tensor-core pair (bf16 at the shapes it takes); and the flash launches
# that took a sliding window
_BODIES = {"flash_attention_tc": (_fa, "tc_launches"),
           "paged_decode_attention_split": (_pa, "split_launches"),
           "ssd_scan_tc": (_ssd, "tc_launches"),
           "flash_attention_window": (_fa, "window_launches")}


def _on_cpu(t: torch.Tensor) -> bool:
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"no kernel for device {t.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    logit_softcap: Optional[float] = None) -> torch.Tensor:
    """Model layout: q (B,S,Hq,hd); k,v (B,S,Hkv,hd) -> (B,S,Hq,hd)."""
    if _on_cpu(q):
        out = ref.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window, scale=scale,
            logit_softcap=logit_softcap)
        return out.transpose(1, 2)
    return _fa.flash_attention_bshd(q, k, v, causal=causal, window=window,
                                    scale=scale, logit_softcap=logit_softcap)


def paged_decode_attention(q: torch.Tensor, pk: torch.Tensor,
                           pv: torch.Tensor, ppos: torch.Tensor,
                           table: torch.Tensor, pos: torch.Tensor, *,
                           scale: Optional[float] = None,
                           logit_softcap: Optional[float] = None
                           ) -> torch.Tensor:
    """One-token paged attention straight off the (NB, bs, Hkv, hd) pool:
    q (B,Hq,hd), table (B,nb), pos (B,) -> (B,Hq,hd)."""
    fn = ref.paged_decode_attention if _on_cpu(q) else _pa.paged_decode_attention
    return fn(q, pk, pv, ppos, table, pos, scale=scale,
              logit_softcap=logit_softcap)


def _check_tiling(name: str, s: int, chunk: int, width: int,
                  block: int) -> None:
    """The TPU kernels' tiling rule (``S % min(chunk, S) == 0`` and the
    width a multiple of its block), so the port raises where JAX does.
    The CUDA kernels tile by their own sizes and take any shape."""
    chunk, block = min(chunk, s), min(block, width)
    if chunk < 1 or block < 1 or s % chunk or width % block:
        raise ValueError(f"{name}: S {s} must be a multiple of chunk {chunk} "
                         f"and width {width} of block {block}")


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
             b_: torch.Tensor, c_: torch.Tensor, *, chunk: int = 128,
             block_h: int = 8) -> torch.Tensor:
    """Mamba-2 SSD scan in the model layout: x (B,S,H,P); dt (B,S,H) fp32;
    a (H,) fp32; b_, c_ (B,S,N) -> y (B,S,H,P) in x's dtype."""
    _check_tiling("ssd_scan", x.shape[1], chunk, x.shape[2], block_h)
    fn = ref.ssd_scan if _on_cpu(x) else _ssd.ssd_scan
    return fn(x, dt, a, b_, c_)


def rg_lru_scan(log_a: torch.Tensor, b: torch.Tensor, *, chunk: int = 128,
                block_w: int = 512) -> torch.Tensor:
    """``h_t = exp(log_a_t) h_{t-1} + b_t`` from h = 0: log_a, b (B,S,W)
    -> h (B,S,W) in b's dtype."""
    _check_tiling("rg_lru_scan", b.shape[1], chunk, b.shape[2], block_w)
    fn = ref.rg_lru_scan if _on_cpu(b) else _rglru.rg_lru_scan
    return fn(log_a, b)


def weighted_average(stacked: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Any-rank stacked leaf (N, ...) x (N,) fp32 weights -> (...) in the
    stack's dtype.  An empty leaf short-circuits: nothing to reduce."""
    n = stacked.shape[0]
    if stacked[0].numel() == 0:
        return torch.zeros(stacked.shape[1:], dtype=stacked.dtype,
                           device=stacked.device)
    flat = stacked.reshape(n, -1)
    if _on_cpu(flat):
        out = ref.weighted_average_2d(flat, weights)
    else:
        out = _wavg.weighted_average_2d(flat, weights)
    return out.reshape(stacked.shape[1:])


def _adam_rows(p, g, m, v, mask):
    n = p.shape[0] if mask is not None else 1
    return p.view(n, -1), g.reshape(n, -1), m.view(n, -1), v.view(n, -1)


def fused_adamw(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                v: torch.Tensor, mask: Optional[torch.Tensor],
                scalars: torch.Tensor) -> None:
    """One fused masked-AdamW step over one leaf, in place on p, m and v.

    Any-rank leaves.  With ``mask`` (a per-client stacked stage, leaves
    (N, ...)) the leading axis is the client axis and rows with mask 0
    keep p, m and v; with ``mask=None`` (a shared stage) the leaf is one
    row, always on.  ``scalars`` is the (9,) fp32 host tensor
    ``[lr, b1, b2, 1-b1, 1-b2, eps, wd, bc1, bc2]``.  An empty leaf
    short-circuits."""
    if p.numel() == 0:
        return
    if _on_cpu(p):
        fused_adamw_plain(p, g, m, v, mask, scalars)
        return
    _fadam.fused_adamw_2d(*_adam_rows(p, g, m, v, mask), mask,
                          scalars.tolist())


# columns per slice of the plain AdamW: its elementwise transients stay a
# few hundred MB a slice, where a whole (2, 655,360,000) embedding leaf
# would need ~5 GB each
PLAIN_ADAM_COLS = 1 << 24


def fused_adamw_plain(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                      v: torch.Tensor, mask: Optional[torch.Tensor],
                      scalars: torch.Tensor) -> None:
    """:func:`fused_adamw` through its plain version on any device, in
    place: what a CPU tensor takes, and the reference a card's run is
    held against.  The update is elementwise, so it runs in column slices
    of ``PLAIN_ADAM_COLS`` with the same result bit for bit."""
    if p.numel() == 0:
        return
    pf, gf, mf, vf = _adam_rows(p, g, m, v, mask)
    for lo in range(0, pf.shape[1], PLAIN_ADAM_COLS):
        cols = slice(lo, lo + PLAIN_ADAM_COLS)
        po, mo, vo = ref.fused_adamw_2d(pf[:, cols], gf[:, cols],
                                        mf[:, cols], vf[:, cols], mask,
                                        scalars)
        pf[:, cols].copy_(po)
        mf[:, cols].copy_(mo)
        vf[:, cols].copy_(vo)


def quantize_stochastic(x: torch.Tensor, u: torch.Tensor,
                        inv_step: torch.Tensor, levels: float) -> torch.Tensor:
    """(N, M) fp32 -> (N, M) int8 codes in [-levels, levels]."""
    fn = (ref.quantize_stochastic_2d if _on_cpu(x)
          else _comp.quantize_stochastic_2d)
    return fn(x, u, inv_step, levels)


def dequantize(q: torch.Tensor, step: torch.Tensor) -> torch.Tensor:
    """(N, M) int8 codes -> (N, M) fp32 reconstruction."""
    fn = ref.dequantize_2d if _on_cpu(q) else _comp.dequantize_2d
    return fn(q, step)


def topk_mask(x: torch.Tensor, thresh: torch.Tensor) -> torch.Tensor:
    """(N, M) fp32 -> the same with |x| < its row's threshold zeroed."""
    fn = ref.topk_mask_2d if _on_cpu(x) else _comp.topk_mask_2d
    return fn(x, thresh)


def launch_counts() -> Dict[str, int]:
    """Kernel launches of this process, by kernel."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _COUNTED.items()}


def body_launches() -> Dict[str, int]:
    """Launches of this process by kernel body (see ``_BODIES``)."""
    return {name: getattr(mod, attr) for name, (mod, attr) in _BODIES.items()}


def reset_launch_counts() -> None:
    """Zero the counts of :func:`launch_counts` and :func:`body_launches`."""
    for mod, attr in (*_COUNTED.values(), *_BODIES.values()):
        setattr(mod, attr, 0)
