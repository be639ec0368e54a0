"""Learning-rate schedules: constant, linear and cosine, each with a linear
warmup, as plain functions of the step.

The twin of ``repro/optim/schedule.py``.  Every schedule returns a 0-d
fp32 tensor on the host, computed in fp32 in the JAX order (there the step
is an int32 array and every constant is weakly typed, so the whole
expression is fp32).
"""

from __future__ import annotations

import math

import torch


def make_schedule(kind: str, base_lr: float, warmup_steps: int,
                  total_steps: int):
    """Returns ``schedule(step) -> lr`` (a 0-d fp32 tensor)."""

    def warmup(step: int) -> torch.Tensor:
        num = torch.tensor(step + 1, dtype=torch.int32)
        return torch.clamp(num / max(warmup_steps, 1), max=1.0)

    def frac(step: int) -> torch.Tensor:
        num = torch.tensor(step - warmup_steps, dtype=torch.int32)
        return torch.clamp(num / max(total_steps - warmup_steps, 1), 0.0, 1.0)

    if kind == "constant":
        def sched(step):
            return base_lr * warmup(int(step))
    elif kind == "linear":
        def sched(step):
            step = int(step)
            return base_lr * warmup(step) * (1.0 - 0.9 * frac(step))
    elif kind == "cosine":
        def sched(step):
            step = int(step)
            cos = torch.cos(torch.tensor(math.pi, dtype=torch.float32)
                            * frac(step))
            return base_lr * warmup(step) * (0.1 + 0.45 * (1 + cos))
    else:
        raise ValueError(kind)
    return sched
