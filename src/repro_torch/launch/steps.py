"""The step functions the launchers drive — the twin of
``repro/launch/steps.py``.

* ``prefill_32k`` → :func:`make_prefill_step`: a full-sequence forward
  that returns the last position's logits, a vision frontend's patch
  embeddings (``batch["embeds"]``) in front of the text when given.  With
  ``impl="kernel"`` it runs every attention, SSD and RG-LRU layer through
  its CUDA kernel.
* ``decode_32k`` / ``long_500k`` → :func:`make_serve_step`: one decode
  step against a cache; ``long_500k`` decodes every global layer within
  the config's ``long_context_window``.

The train and validation steps are the rounds' own
(``core/round.py::make_round_fn``).
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig
from repro_torch.models import transformer as tf


def make_prefill_step(model_cfg: ModelConfig, impl: str = "kernel"
                      ) -> Callable[[dict, Dict[str, torch.Tensor]],
                                    torch.Tensor]:
    """``prefill_step(params, batch) -> logits (B, 1, V)`` fp32 for
    ``batch["tokens"]`` (B, S) and the optional ``batch["embeds"]``
    (B, F, D), under ``torch.no_grad()``."""

    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = tf.forward(params, model_cfg, batch["tokens"],
                                   embeds=batch.get("embeds"), impl=impl,
                                   remat=False, last_only=True)
        return logits

    return prefill_step


def make_serve_step(model_cfg: ModelConfig, shape: ShapeConfig
                    ) -> Callable[..., Tuple[torch.Tensor, dict]]:
    """``serve_step(params, cache, batch) -> (logits (B, 1, V), cache)``:
    one decode step of ``batch["tokens"]`` (B, 1) at ``batch["pos"]``
    (B,), the cache updated in place, under ``torch.no_grad()``.  For the
    ``long_500k`` shape every global layer decodes within
    ``model_cfg.long_context_window`` (its cache built by
    ``tf.init_cache`` with the same ``decode_window_override``)."""
    override = (model_cfg.long_context_window
                if shape.name == "long_500k" else None)

    def serve_step(params, cache, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            return tf.decode_step(params, model_cfg, batch["tokens"], cache,
                                  batch["pos"],
                                  decode_window_override=override)

    return serve_step
