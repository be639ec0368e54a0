"""AdamW and SGD with momentum over parameter trees, with the masked-update
mode of WSSL: a client that is not selected keeps its params and moments
for the round (the paper's semantics — a non-participant does not step).

The twin of ``repro/optim/optimizers.py``.  The mask broadcasts over the
leading (client) axis of every leaf.  Where the JAX package returned a new
state (and the round donated the old one), the port updates the params and
the optimizer state **in place** under ``torch.no_grad()``, so one copy of
the state is live; the update functions return the same objects.

AdamW steps every leaf through ``kernels/ops.fused_adamw``: the fused
masked-AdamW CUDA kernel on the card, its plain version
(``kernels/ref.py::fused_adamw_2d``, the JAX op order) on the CPU.  The
fp32 hyper-parameters, the bias corrections ``bc1 = 1 - b1**t`` and
``bc2`` included, are computed once per call on the host in fp32
(:func:`adam_scalars`), so both agree with the JAX package bit for bit
in fp32.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch
from torch.utils._pytree import tree_leaves, tree_map

from repro_torch.kernels import ops

Params = Any


@dataclass
class AdamState:
    step: torch.Tensor      # 0-d int32 on the host
    m: Params               # fp32, the params' tree
    v: Params


@dataclass
class SgdState:
    step: torch.Tensor
    mom: Params


def _zeros32(p: torch.Tensor) -> torch.Tensor:
    return torch.zeros(p.shape, dtype=torch.float32, device=p.device)


def adamw_init(params: Params) -> AdamState:
    return AdamState(step=torch.zeros((), dtype=torch.int32),
                     m=tree_map(_zeros32, params), v=tree_map(_zeros32, params))


def adam_scalars(step: int, *, lr, beta1: float, beta2: float, eps: float,
                 weight_decay: float) -> torch.Tensor:
    """The (9,) fp32 host vector ``[lr, b1, b2, 1-b1, 1-b2, eps, wd, bc1,
    bc2]`` of the update at ``step`` (counted from 1), computed as the JAX
    package does: ``t`` is the fp32 step, ``bc = 1 - beta ** t`` in fp32,
    ``1 - beta`` in double and then rounded."""
    f32 = lambda x: torch.as_tensor(x, dtype=torch.float32).reshape(())
    t = f32(float(step))
    b1, b2 = f32(beta1), f32(beta2)
    return torch.stack([f32(lr), b1, b2, f32(1 - beta1), f32(1 - beta2),
                        f32(eps), f32(weight_decay), 1.0 - b1 ** t,
                        1.0 - b2 ** t])


def _row_mask(mask: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    return mask.reshape((-1,) + (1,) * (p.dim() - 1)).float()


@torch.no_grad()
def adamw_update(params: Params, grads: Params, state: AdamState, *,
                 lr, beta1: float = 0.9, beta2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.01,
                 mask: Optional[torch.Tensor] = None
                 ) -> Tuple[Params, AdamState]:
    """One AdamW step of every leaf, in place: one read of (p, g, m, v)
    and one write of (p, m, v) per leaf."""
    state.step += 1
    scalars = adam_scalars(int(state.step), lr=lr, beta1=beta1, beta2=beta2,
                           eps=eps, weight_decay=weight_decay)
    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state.m), tree_leaves(state.v)):
        ops.fused_adamw(p, g, m, v, mask, scalars)
    return params, state


def sgd_init(params: Params) -> SgdState:
    return SgdState(step=torch.zeros((), dtype=torch.int32),
                    mom=tree_map(_zeros32, params))


@torch.no_grad()
def sgd_update(params: Params, grads: Params, state: SgdState, *,
               lr, momentum: float = 0.9, weight_decay: float = 0.0,
               mask: Optional[torch.Tensor] = None
               ) -> Tuple[Params, SgdState]:
    """One SGD-momentum step, in place.  Masked rows keep params and
    momentum bit-identical: the blend ``mk*new + (1-mk)*old`` at mk = 0 is
    ``0*new + old`` with ``new`` always finite (the step divides by
    nothing), so a non-participant's momentum cannot drift."""
    ps, gs, ms = tree_leaves(params), tree_leaves(grads), tree_leaves(state.mom)
    dev = ps[0].device if ps else torch.device("cpu")
    lr_ = torch.as_tensor(lr, dtype=torch.float32).to(dev)
    for p, g, m in zip(ps, gs, ms):
        g = g.float() + weight_decay * p.float()
        m_new = momentum * m + g
        p_new = p.float() - lr_ * m_new
        if mask is not None:
            mk = _row_mask(mask, p)
            p_new = mk * p_new + (1 - mk) * p.float()
            m_new = mk * m_new + (1 - mk) * m
        p.copy_(p_new)
        m.copy_(m_new)
    state.step += 1
    return params, state


@torch.no_grad()
def clip_by_global_norm(grads: Params, max_norm: float, *, group=None
                        ) -> Tuple[Params, torch.Tensor]:
    """Scale every leaf, in place, by ``min(1, max_norm / ||grads||)``
    (the norm over all leaves, in fp32).  Returns (grads, the norm).
    ``group``: when the tree is one shard of the client axis (a sharded
    round's client gradients), the squared norm sums across the group, so
    the clip sees the flat round's norm (JAX's ``axis_name``)."""
    leaves = tree_leaves(grads)
    # per-leaf norms without an fp32 temporary the size of the leaf (the
    # Gemma-2B client embedding gradient is 4.2 GB)
    gnorm2 = sum(torch.square(torch.linalg.vector_norm(l, dtype=torch.float32))
                 for l in leaves)
    gnorm2 = torch.as_tensor(gnorm2, dtype=torch.float32)
    if group is not None:
        from repro_torch import sharding
        gnorm2 = gnorm2.clone()
        sharding.all_reduce_sum([gnorm2], group)
    gnorm = torch.sqrt(gnorm2)
    # a tensor numerator: ``float / tensor`` is a reciprocal times the
    # float in PyTorch, two roundings where JAX divides once
    num = torch.full_like(gnorm, max_norm)
    scale = torch.clamp(num / torch.clamp(gnorm, min=1e-12), max=1.0)
    for l in leaves:
        if l.dtype == torch.float32:
            l.mul_(scale)
        else:
            l.copy_(l.float() * scale)
    return grads, gnorm


def make_optimizer(kind: str):
    if kind == "adamw":
        return adamw_init, adamw_update
    if kind == "sgd":
        return sgd_init, sgd_update
    raise ValueError(kind)
