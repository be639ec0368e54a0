"""Algorithm 2's split step over an N-stage pipeline, with torch autograd.

The twin of ``repro/core/split.py``.  ``pipeline_grads`` runs the
multi-hop protocol (client -> edge ... -> server):

  1. stage 0 forward             -> hop activation a0     (first upload)
  2. stage i forward (0 < i < S-1) -> hop activation ai   (relayed upload)
  3. final stage forward + backward -> loss, dL/da_{S-2}  (first download)
  4. each stage's backward with the relayed cotangent, in reverse

Each hop's activation enters the next stage detached, as a fresh leaf:
the paper's "detach from the computation graph and forward", applied at
every boundary; the cotangent the downstream stage returns for that leaf
is what crosses back.  The result equals end-to-end autograd
(tests/test_torch_round.py checks 1, 2 and 3 cuts).
"""

from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Sequence, Tuple

import torch
from torch.utils._pytree import tree_flatten, tree_unflatten

Params = Any


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class SplitStepResult(NamedTuple):
    loss: torch.Tensor
    grads_client: Params
    grads_server: Params
    activation: torch.Tensor      # what crossed the cut
    bytes_up: int
    bytes_down: int


class PipelineStepResult(NamedTuple):
    loss: torch.Tensor
    grads: Tuple[Params, ...]             # per stage, client first
    activations: Tuple[torch.Tensor, ...]  # what crossed each hop
    bytes_up: Tuple[int, ...]             # per-hop activation bytes
    bytes_down: Tuple[int, ...]           # per-hop returned-gradient bytes


def _leaves_of(params: Params):
    """Fresh leaves that require grad, aliasing ``params``' storage."""
    flat, spec = tree_flatten(params)
    leaves = [t.detach().requires_grad_(True) for t in flat]
    return leaves, tree_unflatten(leaves, spec), spec


def _grads(outputs, grad_outputs, leaves: List[torch.Tensor], spec,
           act: torch.Tensor = None):
    """Gradients of ``outputs`` (seeded by ``grad_outputs``) w.r.t. the
    stage's leaves (zeros where unused) and, if given, its input
    activation."""
    inputs = leaves + ([act] if act is not None else [])
    got = torch.autograd.grad(outputs, inputs, grad_outputs,
                              allow_unused=True)
    g = [torch.zeros_like(l) if x is None else x
         for l, x in zip(leaves, got)]
    return tree_unflatten(g, spec), (got[-1] if act is not None else None)


def pipeline_grads(stage_fns: Sequence[Callable],
                   stage_params: Sequence[Params]) -> PipelineStepResult:
    """One N-stage split-learning forward and backward.

    ``stage_fns[0](params) -> activation`` (the stage's data is closed
    over); ``stage_fns[i](params, activation) -> activation`` for
    0 < i < S-1; ``stage_fns[-1](params, activation) -> scalar loss``."""
    if not len(stage_fns) == len(stage_params) >= 2:
        raise ValueError("need at least a client and a server stage, one "
                         "function per stage")
    with torch.enable_grad():
        # phase 1: forward relay, each hop's activation detached
        leaves0, p0, spec0 = _leaves_of(stage_params[0])
        out0 = stage_fns[0](p0)
        acts, mids = [out0.detach()], []
        x = acts[-1].requires_grad_(True)
        for fn, p in zip(stage_fns[1:-1], stage_params[1:-1]):
            leaves, pt, spec = _leaves_of(p)
            y = fn(pt, x)
            mids.append((leaves, spec, x, y))
            acts.append(y.detach())
            x = acts[-1].requires_grad_(True)

        # phase 2: final-stage forward and backward
        leaves, pt, spec = _leaves_of(stage_params[-1])
        loss = stage_fns[-1](pt, x)
        g_last, g_x = _grads(loss, None, leaves, spec, x)

        # phase 3: backward relay with the returned cotangents
        grads, grad_acts = [g_last], [g_x]
        for leaves, spec, x_in, y in reversed(mids):
            g_p, g_x = _grads(y, g_x, leaves, spec, x_in)
            grads.append(g_p)
            grad_acts.append(g_x)
        g0, _ = _grads(out0, g_x, leaves0, spec0)
        grads.append(g0)
    grads.reverse()
    grad_acts.reverse()
    return PipelineStepResult(
        loss=loss.detach(), grads=tuple(grads),
        activations=tuple(a.detach() for a in acts),
        bytes_up=tuple(_nbytes(a) for a in acts),
        bytes_down=tuple(_nbytes(g) for g in grad_acts))


def split_grads(client_fn: Callable[[Params], torch.Tensor],
                server_loss_fn: Callable[[Params, torch.Tensor], torch.Tensor],
                client_params: Params,
                server_params: Params) -> SplitStepResult:
    """The classic two-stage split step: :func:`pipeline_grads` with one
    cut."""
    res = pipeline_grads([client_fn, server_loss_fn],
                         [client_params, server_params])
    return SplitStepResult(loss=res.loss, grads_client=res.grads[0],
                           grads_server=res.grads[1],
                           activation=res.activations[0],
                           bytes_up=res.bytes_up[0],
                           bytes_down=res.bytes_down[0])


def end_to_end_grads_n(stage_fns: Sequence[Callable],
                       stage_params: Sequence[Params]):
    """Reference: the composed N-stage objective differentiated end to end.
    Returns (loss, per-stage grads tuple)."""
    with torch.enable_grad():
        parts = [_leaves_of(p) for p in stage_params]
        x = stage_fns[0](parts[0][1])
        for fn, (_, pt, _) in zip(stage_fns[1:-1], parts[1:-1]):
            x = fn(pt, x)
        loss = stage_fns[-1](parts[-1][1], x)
        flat = [l for leaves, _, _ in parts for l in leaves]
        got = torch.autograd.grad(loss, flat, allow_unused=True)
    out, i = [], 0
    for leaves, _, spec in parts:
        g = [torch.zeros_like(l) if x is None else x
             for l, x in zip(leaves, got[i:i + len(leaves)])]
        out.append(tree_unflatten(g, spec))
        i += len(leaves)
    return loss.detach(), tuple(out)


def end_to_end_grads(client_fn, server_loss_fn, client_params, server_params):
    """Reference: the two-stage objective differentiated end to end."""
    loss, grads = end_to_end_grads_n([client_fn, server_loss_fn],
                                     [client_params, server_params])
    return loss, grads[0], grads[1]
