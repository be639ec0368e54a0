"""Bridge between the JAX package's trees and the port's.

``params_from_jax`` takes the JAX parameter tree as numpy arrays (for
example ``jax.tree.map(np.asarray, params)``) and returns the port's tree:
the same nesting of dicts and lists, each leaf a tensor on ``device``.
:func:`shard_params` cuts a whole param tree to one rank's blocks of a
grid (``launch/mesh.py::ProcessGrid``) under the logical-axis rules, the
counterpart of ``jax.device_put(params, shardings_from_axes(...))``, and
:func:`init_shard_params` builds a rank's blocks of a seeded random tree
without the whole tree (``transformer.init_params_by_layer``).
``state_from_jax`` does the same for a whole training state, and
``state_to_numpy`` goes back, for comparisons; ``async_state_from_jax``
and ``async_state_to_numpy`` do it for the async round's buffer state.
``paper_params_from_jax`` and ``paper_params_to_numpy`` do it for the
paper's gait FFN and ResNet-18 (``models/paper_models.py``), whose trees
keep the JAX layout, HWIO convolutions included, so no leaf is permuted;
every leaf of theirs stays fp32, their norms' ``bias`` too.  Only numpy
is needed on the JAX side.

Matrices and biases (``bq``, ``bk``, ``bv``, ``bu``, ``bd``, LayerNorm's
``bias``; an MoE layer's ``router``, ``wg``, ``wu`` and ``wd``; the vision
frontend's projector ``frontend.proj``, which rides with the client
stage) are stored in ``dtype``: serving passes the activation dtype (the
JAX package keeps fp32 params and casts them on every use, so the values
the model computes with are the same); training passes
``torch.float32``, the JAX package's fp32 master params.  The leaves the
model reads in fp32 stay fp32 (:data:`_FP32_LEAVES`): norm scales, because
RMSNorm forms ``1 + scale`` in fp32 before it rounds (LayerNorm's scale
stays fp32 with them and is cast at use); the SSD block's ``A_log``,
``D``, ``dt_bias`` and gated-norm ``norm_scale``; the RG-LRU
``lambda``, ``b_r``, ``b_i`` and the gate matrices ``w_r`` / ``w_i``,
which the gates cast to fp32 at use (stored in bf16 they would lose bits
the JAX model keeps).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils._pytree import tree_map

from repro_torch import sharding
from repro_torch.config import ModelConfig
from repro_torch.models.layers import resolve_device, torch_dtype

_FP32_LEAVES = ("scale", "norm_scale", "A_log", "D", "dt_bias", "lambda",
                "b_r", "b_i", "w_r", "w_i")


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


def _block(grid, rules, axes, leaf: torch.Tensor) -> torch.Tensor:
    """This rank's block of ``leaf`` under the rules, a contiguous copy."""
    place = sharding.resolve_spec(grid, rules, axes, leaf.shape)
    return leaf[sharding.block_slices(place, leaf.shape, grid)].clone(
        memory_format=torch.contiguous_format)


def shard_params(params: Any, grid, rules, axes_tree) -> Any:
    """This rank's blocks of a whole param tree (``params_from_jax``'s or
    ``init_params``'): each leaf cut to its ``sharding.local_shape``
    block by its ``sharding.placement_tree`` entry under ``rules``, at the
    rank's coordinates in ``grid``, a contiguous copy on the leaf's
    device.  A rank's blocks hold ``sharding.device_bytes(grid, rules,
    axes_tree, params)`` bytes."""
    return sharding.map_axes(lambda ax, t: _block(grid, rules, ax, t),
                             axes_tree, params)


def init_shard_params(cfg: ModelConfig, seed: int, grid, rules, *,
                      device="cuda") -> Any:
    """This rank's blocks of ``transformer.init_params_by_layer(cfg,
    seed)``'s tree, each drawn piece (one layer) cut to its blocks as it is
    drawn: what :func:`shard_params` gives of the whole tree, without the
    whole tree on this rank."""
    from repro_torch.models import transformer as tf
    return tf.init_params_by_layer(
        cfg, seed, device=device,
        keep=lambda ax, t: _block(grid, rules, ax, t))


def _opt_from_jax(np_opt: Any, device):
    from repro_torch.optim import AdamState, SgdState
    moments = lambda t: tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device),
        t)
    step = torch.tensor(int(np.asarray(np_opt.step)), dtype=torch.int32)
    if hasattr(np_opt, "m"):
        return AdamState(step=step, m=moments(np_opt.m), v=moments(np_opt.v))
    return SgdState(step=step, mom=moments(np_opt.mom))


def state_from_jax(np_state: Any, cfg: ModelConfig, *, device="cuda",
                   dtype=torch.float32):
    """The JAX package's ``WSSLState`` with numpy leaves (for example
    ``jax.tree.map(np.asarray, state)``) -> the port's
    :class:`~repro_torch.core.round.WSSLState`: params in ``dtype``,
    optimizer moments and error-feedback residuals fp32, the step and
    round index on the host.  The selection generator is seeded from the
    JAX key's bits; a test that needs the JAX selection injects the JAX
    Gumbel draw instead."""
    from repro_torch.core.round import WSSLState
    device = resolve_device(device)
    conv = lambda t: params_from_jax(t, cfg, device=device, dtype=dtype)
    key = np.asarray(np_state.rng).astype(np.uint32).tobytes()
    fp32 = lambda t: tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)).to(device),
        t)
    return WSSLState(
        client_stack=conv(np_state.client_stack),
        server_params=conv(np_state.server_params),
        edge_stages=tuple(conv(e) for e in np_state.edge_stages),
        opt_client=_opt_from_jax(np_state.opt_client, device),
        opt_server=_opt_from_jax(np_state.opt_server, device),
        opt_edge=tuple(_opt_from_jax(o, device) for o in np_state.opt_edge),
        importance=torch.from_numpy(
            np.array(np_state.importance, dtype=np.float32)).to(device),
        round_index=torch.tensor(int(np.asarray(np_state.round_index)),
                                 dtype=torch.int32),
        rng=torch.Generator().manual_seed(
            int.from_bytes(key[:8], "little") % 2 ** 63),
        ef_residual=fp32(np_state.ef_residual))


def state_to_numpy(state: Any) -> dict:
    """The port's state as nested dicts and lists of fp32 numpy arrays, in
    the JAX state's field and tree layout (``opt_*`` as
    ``{"step", "m", "v"}`` or ``{"step", "mom"}``; ``ef_residual`` ``()``
    when there is none)."""
    arr = lambda t: tree_map(lambda a: a.detach().float().cpu().numpy(), t)

    def opt(o):
        out = {"step": np.asarray(int(o.step), np.int32)}
        if hasattr(o, "m"):
            out.update(m=arr(o.m), v=arr(o.v))
        else:
            out.update(mom=arr(o.mom))
        return out

    return {"client_stack": arr(state.client_stack),
            "server_params": arr(state.server_params),
            "edge_stages": [arr(e) for e in state.edge_stages],
            "opt_client": opt(state.opt_client),
            "opt_server": opt(state.opt_server),
            "opt_edge": [opt(o) for o in state.opt_edge],
            "importance": arr(state.importance),
            "ef_residual": arr(state.ef_residual),
            "round_index": np.asarray(int(state.round_index), np.int32)}


def async_state_from_jax(np_astate: Any, cfg: ModelConfig, *, device="cuda",
                         dtype=torch.float32):
    """The JAX package's ``AsyncState`` with numpy leaves -> the port's
    :class:`~repro_torch.core.async_round.AsyncState`: ``pending`` and
    ``staleness`` int32, the buffer in ``dtype`` (the client stack's) in
    the client stack's tree layout."""
    from repro_torch.core.async_round import AsyncState
    device = resolve_device(device)
    i32 = lambda a: torch.from_numpy(np.array(a, dtype=np.int32)).to(device)
    return AsyncState(pending=i32(np_astate.pending),
                      staleness=i32(np_astate.staleness),
                      buffer=params_from_jax(np_astate.buffer, cfg,
                                             device=device, dtype=dtype))


def async_state_to_numpy(astate: Any) -> dict:
    """The port's ``AsyncState`` as ``{"pending", "staleness", "buffer"}``
    numpy copies (int32 counters, an fp32 buffer in the JAX tree layout),
    so a snapshot taken between rounds stays as it was."""
    copy = lambda a, dtype: np.array(a.detach().cpu().numpy(), dtype=dtype)
    return {"pending": copy(astate.pending, np.int32),
            "staleness": copy(astate.staleness, np.int32),
            "buffer": tree_map(lambda a: copy(a.float(), np.float32),
                               astate.buffer)}


def paper_params_from_jax(np_params: Any, *, device="cuda") -> Any:
    """A paper model's JAX param tree (numpy leaves; a stage or a
    ``(client, server)`` pair) -> the port's, every leaf fp32 and
    contiguous on ``device``."""
    device = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return torch.from_numpy(np.array(node, dtype=np.float32)).to(device)

    return conv(np_params)


def paper_params_to_numpy(params: Any) -> Any:
    """The inverse of :func:`paper_params_from_jax`: fp32 numpy leaves in
    the same nesting."""
    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(conv(v) for v in node)
        return node.detach().float().cpu().numpy()

    return conv(params)
