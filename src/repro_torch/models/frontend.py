"""The modality frontend: patch embeddings spliced before the text, and
the M-RoPE grid positions of the spliced sequence.

The PyTorch twin of ``repro/models/frontend.py``.  Both frontends are
stubs, as in the JAX package:

* vision (Qwen2-VL): the vision encoder is not modelled; the caller
  supplies its output, ``embeds`` (B, F, d_model) patch embeddings, which
  the projector ``proj`` (d_model, d_model) maps into the decoder's space
  before they are put in front of the text embeddings.  The patches take
  (t = 0, h = row, w = col) positions on a ``sqrt(F)``-wide grid; the text
  follows on all three streams from one past the grid's extent.
* audio (MusicGen): the codec's output tokens are the decoder's input
  stream, so there is nothing to splice and no parameter.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import dense_param

Params = Dict[str, Any]


def frontend_init(gen: torch.Generator, cfg: ModelConfig, *, dtype,
                  device) -> Params:
    """The vision projector ``{"proj": (d, d)}`` at the fan-in scale
    1/sqrt(d), as JAX draws it; ``{}`` for any other frontend."""
    if cfg.frontend != "vision":
        return {}
    d = cfg.d_model
    return {"proj": dense_param(gen, (d, d), dtype=dtype, device=device)}


def splice_frontend(cfg: ModelConfig, p: Params, x_text: torch.Tensor,
                    embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """``embeds @ proj`` (in the activation dtype) put in front of the text
    embeddings x_text (B, S, D) -> (B, F + S, D)."""
    if cfg.frontend != "vision" or embeds is None:
        return x_text
    vis = embeds @ p["proj"].to(x_text.dtype)
    return torch.cat([vis, x_text], dim=1)


def build_positions(cfg: ModelConfig, batch: int, text_len: int,
                    vis_tokens: int, device=None) -> torch.Tensor:
    """Positions of the spliced sequence.  Under ``mrope`` (B, F + S, 3)
    int32: patch i at (0, i // g, i % g) with ``g = int(sqrt(F))``, then
    the text at ``start + arange(S)`` on all three streams, ``start =
    ceil(F / g) + 1``.  Otherwise (B, F + S) ``arange``."""
    if cfg.rope_kind != "mrope":
        pos = torch.arange(text_len + vis_tokens, dtype=torch.int32,
                           device=device)
        return pos[None].expand(batch, -1)
    g = max(int(math.sqrt(max(vis_tokens, 1))), 1)
    idx = torch.arange(vis_tokens, dtype=torch.int32, device=device)
    vis = torch.stack([torch.zeros_like(idx), idx // g, idx % g], dim=-1)
    start = (vis_tokens + g - 1) // g + 1 if vis_tokens else 0
    t = start + torch.arange(text_len, dtype=torch.int32, device=device)
    text = torch.stack([t, t, t], dim=-1)
    return torch.cat([vis, text])[None].expand(batch, -1, -1)
