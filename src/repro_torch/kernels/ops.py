"""Kernel dispatch by the tensor's device.

A CPU tensor takes the plain PyTorch version (``kernels/ref.py``); a CUDA
tensor launches the hand-written kernel, or raises.  Nothing here catches
a build or launch failure, and no CUDA tensor is ever handed to the plain
version.  Every wrapper takes the model-layer layouts.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref

_COUNTED = {"flash_attention": _fa, "paged_decode_attention": _pa}


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


def launch_counts() -> Dict[str, int]:
    """Kernel launches of this process, by kernel."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0
