"""Parameter bridge from the JAX package to the port.

``params_from_jax`` takes the JAX parameter tree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's tree:
the same nesting of dicts and lists, each leaf a tensor on ``device``.  It
needs only numpy on its input side.

Matrices are stored in ``dtype`` (the activation dtype): the JAX package
keeps fp32 params and casts them with ``.astype(dtype)`` on every use, so
the values the model computes with are the same.  Norm scales stay fp32,
because the norm forms ``1 + scale`` in fp32 before it rounds.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.models.layers import resolve_device, torch_dtype

_FP32_LEAVES = ("scale",)   # norm scales


def params_from_jax(np_params: Any, cfg: ModelConfig, *, device="cuda",
                    dtype=None) -> Any:
    """JAX param tree (numpy leaves) -> the port's param tree.  ``dtype``
    defaults to ``cfg.dtype``."""
    device = resolve_device(device)
    dtype = dtype or torch_dtype(cfg.dtype)

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v, key) for v in node]
        t = torch.from_numpy(np.array(node, dtype=np.float32))
        leaf_dtype = torch.float32 if key in _FP32_LEAVES else dtype
        return t.to(device=device, dtype=leaf_dtype)

    return conv(np_params)
