"""The step functions the launchers drive — the twin of
``repro/launch/steps.py``.

* ``train_4k`` → :func:`make_train_step`: one WSSL round without
  validation, and :func:`make_val_step`: every client's validation loss
  and the new importance (Algorithm 1 line 6), at a lower cadence.  Both
  default to ``impl="chunked"``, the flash training path, as in JAX.
* ``prefill_32k`` → :func:`make_prefill_step`: a full-sequence forward
  that returns the last position's logits, a vision frontend's patch
  embeddings (``batch["embeds"]``) in front of the text when given.  With
  ``impl="kernel"`` it runs every attention, SSD and RG-LRU layer through
  its CUDA kernel.  Given a grid (``launch/mesh.py::ProcessGrid``) it is
  the sharded step JAX runs under ``use_sharding_rules(mesh,
  build_rules(mesh, cfg, "prefill", B))``: each rank holds the param
  blocks the rules place on it (``_bridge.shard_params``), prefills its
  batch rows and returns their whole-vocab logits, the logits of the
  one-rank step.  Given a bare mesh shape it is the one-rank step under
  that binding (the per-shard MoE dispatch of a data axis above 1).
* ``decode_32k`` / ``long_500k`` → :func:`make_serve_step`: one decode
  step against a cache; ``long_500k`` decodes every global layer within
  the config's ``long_context_window``.  Given a grid it is the sharded
  step JAX runs under ``build_rules(mesh, cfg, "decode", B)``: each rank
  holds its param blocks and its blocks of the caches, split on their
  sequence over ``kv_seq`` (``model``, or ``data x model`` when B is
  below the data axis and the rows are then whole on every rank).

"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch import sharding
from repro_torch.config import (ModelConfig, ShapeConfig, TrainConfig,
                                WSSLConfig)
from repro_torch.core import round as rnd
from repro_torch.launch.mesh import data_axis_size
from repro_torch.launch.specs import build_rules
from repro_torch.models import transformer as tf


def make_train_step(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                    train_cfg: TrainConfig, impl: str = "chunked"
                    ) -> Callable[..., Tuple[rnd.WSSLState,
                                             rnd.RoundMetrics]]:
    """``train_step(state, batch, gumbel=None) -> (state, metrics)``: one
    round of ``make_round_fn`` without a validation set (the importance
    carries over), the state updated in place; ``gumbel`` replaces the
    selection draw."""
    round_fn = rnd.make_round_fn(model_cfg, wssl_cfg, train_cfg, impl=impl)

    def train_step(state: rnd.WSSLState, batch: Dict[str, torch.Tensor],
                   gumbel: Optional[torch.Tensor] = None):
        return round_fn(state, batch, None, gumbel=gumbel)

    return train_step


def make_val_step(model_cfg: ModelConfig, wssl_cfg: WSSLConfig,
                  train_cfg: TrainConfig, impl: str = "chunked"
                  ) -> Callable[..., Tuple[rnd.WSSLState, torch.Tensor]]:
    """``val_step(state, val_batch) -> (state, val_losses (N,))``: every
    client's stage, selected or not, through the shared stages on
    ``val_batch`` (tokens / labels (bv, S)), then the importance EMA,
    written into ``state.importance`` in place.  The losses are the
    round's own validation (``core/round.py::_validate``); JAX's step
    vmaps the client stage straight into the server stage, which is the
    same computation wherever there is one cut."""

    def val_step(state: rnd.WSSLState, val_batch: Dict[str, torch.Tensor]):
        val_losses, importance = rnd._validate(
            state, val_batch, model_cfg=model_cfg, wssl_cfg=wssl_cfg,
            impl=impl)
        state.importance.copy_(importance)
        return state, val_losses

    return val_step


def make_prefill_step(model_cfg: ModelConfig, impl: str = "kernel",
                      grid=None
                      ) -> Callable[[dict, Dict[str, torch.Tensor]],
                                    torch.Tensor]:
    """``prefill_step(params, batch) -> logits (B, 1, V)`` fp32 for
    ``batch["tokens"]`` (B, S) and the optional ``batch["embeds"]``
    (B, F, D), under ``torch.no_grad()``.

    With ``grid`` the step runs under ``use_sharding_rules(grid,
    specs.build_rules(grid, cfg, "prefill", B))``.  On a ``ProcessGrid`` ``params`` are this rank's blocks
    (``_bridge.shard_params``), ``batch`` the whole batch, of which the
    step prefills this rank's rows (``"batch"`` over the data axis, which
    B must divide); it returns their logits (B / data, 1, V).  On a bare
    mesh shape ``params`` and ``batch`` are whole."""

    def forward(params, batch):
        return tf.forward(params, model_cfg, batch["tokens"],
                          embeds=batch.get("embeds"), impl=impl,
                          remat=False, last_only=True)[0]

    def prefill_step(params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        with torch.no_grad():
            if grid is None:
                return forward(params, batch)
            b = batch["tokens"].shape[0]
            bound = build_rules(grid, model_cfg, "prefill", b)
            with sharding.use_sharding_rules(grid, bound):
                rows = sharding.resolve_spec(grid, bound, ("batch", None),
                                             batch["tokens"].shape)[0]
                data = data_axis_size(grid)
                split = ("data",) if data > 1 else (None, "data")
                if sharding.current_grid() is not None and rows not in split:
                    raise ValueError(
                        f"a batch of {b} rows placed on {rows} on a "
                        f"{grid.shape} grid: the rows must split over the "
                        f"data axis (else they are replicated)")
                local = {k: sharding.shard_activation(
                    v, "batch", *(None,) * (v.dim() - 1))
                    for k, v in batch.items()}
                return forward(params, local)

    return prefill_step


def make_serve_step(model_cfg: ModelConfig, shape: ShapeConfig, grid=None
                    ) -> Callable[..., Tuple[torch.Tensor, dict]]:
    """``serve_step(params, cache, batch) -> (logits (B, 1, V), cache)``:
    one decode step of ``batch["tokens"]`` (B, 1) at ``batch["pos"]``
    (B,), the cache updated in place, under ``torch.no_grad()``.  For the
    ``long_500k`` shape every global layer decodes within
    ``model_cfg.long_context_window`` (its cache built by
    ``tf.init_cache`` with the same ``decode_window_override``).

    With ``grid`` the step runs under ``use_sharding_rules(grid,
    specs.build_rules(grid, cfg, "decode", B))``.  On a ``ProcessGrid``
    ``params`` are this rank's blocks (``_bridge.shard_params``), ``cache``
    its cache blocks (``tf.init_cache`` under the same binding, filled by
    ``tf.prefill``) and ``batch`` the whole batch; it returns the logits
    of this rank's rows: B / data where ``"batch"`` splits over the data
    axis, all B where the rules leave it unbound (B below the data axis).
    A batch the bound data axis does not divide raises."""
    override = (model_cfg.long_context_window
                if shape.name == "long_500k" else None)

    def decode(params, cache, batch):
        return tf.decode_step(params, model_cfg, batch["tokens"], cache,
                              batch["pos"], decode_window_override=override)

    def serve_step(params, cache, batch: Dict[str, torch.Tensor]):
        with torch.no_grad():
            if grid is None:
                return decode(params, cache, batch)
            b = batch["tokens"].shape[0]
            bound = build_rules(grid, model_cfg, "decode", b)
            with sharding.use_sharding_rules(grid, bound):
                want, n = sharding.bound_axes("batch")
                if n > 1 and b % n:
                    raise ValueError(
                        f"a batch of {b} rows bound to {want} on a "
                        f"{grid.shape} grid: the rows must split over it")
                local = {k: sharding.shard_activation(
                    v, "batch", *(None,) * (v.dim() - 1))
                    for k, v in batch.items()}
                return decode(params, cache, local)

    return serve_step
