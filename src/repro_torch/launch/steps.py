"""The step functions the launchers drive — the twin of
``repro/launch/steps.py``.

* ``prefill_32k`` → :func:`make_prefill_step`: a full-sequence forward
  that returns the last position's logits.  With ``impl="kernel"`` it
  runs every attention, SSD and RG-LRU layer through its CUDA kernel.

The train and validation steps come with the training of the model
families (ROADMAP Queue 1, item 11); the one-token serve step is the
engine's ``decode_step``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.config import ModelConfig
from repro_torch.models import transformer as tf


def make_prefill_step(model_cfg: ModelConfig, impl: str = "kernel"
                      ) -> Callable[[dict, Dict[str, torch.Tensor]],
                                    torch.Tensor]:
    """``prefill_step(params, batch) -> logits (B, 1, V)`` fp32 for
    ``batch["tokens"]`` (B, S), under ``torch.no_grad()``."""

    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            logits, _ = tf.forward(params, model_cfg, batch["tokens"],
                                   impl=impl, remat=False, last_only=True)
        return logits

    return prefill_step
