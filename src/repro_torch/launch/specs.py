"""Input specs (meta tensors) and sharding-rule construction for every
(architecture x input shape x mesh) combination.

The twin of ``repro/launch/specs.py``.  A spec is a tensor on the meta
device, the port's ``ShapeDtypeStruct``: its shape and ``torch.dtype``
and no storage, so nothing here allocates.  Specs feed the dry run
(``launch/dryrun.py``), which runs the port's steps on them under the op
counter; a placement (``sharding.py``) stands where JAX has a
``NamedSharding``.

What differs from JAX, and why:

* The decode step's ``pos`` is ``(B,)``, a position a row: the port's
  ``decode_step`` takes per-row positions where JAX's serve step takes one
  scalar.
* Serving params (:func:`serve_param_specs`) are the tree the port's
  engine holds: ``init_params`` in the config's dtype (bf16 at full
  size), whose norm scales and the SSD / RG-LRU leaves read in fp32 stay
  fp32.  JAX's spec casts every leaf to bf16.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, ShapeConfig, WSSLConfig
from repro_torch.launch.mesh import data_axis_size, model_axis_size
from repro_torch.models import transformer as tf
from repro_torch.models.layers import torch_dtype
from repro_torch.sharding import default_rules, placement_tree


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------


def build_rules(mesh, model_cfg: ModelConfig, kind: str,
                global_batch: int, overrides: Optional[Dict] = None) -> Dict:
    """Per-(arch, shape, mesh) logical -> mesh-axis binding, as JAX's."""
    multi = "pod" in dict(getattr(mesh, "shape", mesh))
    rules = default_rules(multi)
    msize = model_axis_size(mesh)
    dsize = data_axis_size(mesh)

    # head-parallel attention needs the flat head count and one of the
    # GQA-grouped dims (kv heads K or group G) to divide the model axis;
    # otherwise attention is sequence-parallel
    h, kh = model_cfg.num_heads, max(model_cfg.num_kv_heads, 1)
    g = h // kh if kh else 0
    head_ok = h and h % msize == 0 and (kh % msize == 0 or g % msize == 0)
    if model_cfg.num_heads and not head_ok:
        rules["act_heads"] = None      # params still shard on "heads"
        rules["attn_seq"] = "model"
    if model_cfg.num_heads and model_cfg.num_heads % msize != 0:
        # heads cannot shard the model axis at all: shard the attention
        # weights on d_model instead of replicating them across it
        rules["attn_din"] = "model"
        rules["attn_dout"] = "model"

    # MoE dispatch intermediates shard over the data axes outside the
    # client-vmapped train step
    if kind in ("prefill", "decode"):
        rules["moe_tokens"] = ("pod", "data") if multi else ("data",)
        # serving stores bf16 params: no FSDP whenever the model-sharded
        # copy fits comfortably
        if model_cfg.param_count() * 2 / msize < 1.5e9:
            rules["fsdp"] = None
    if kind == "train":
        # the client axis takes the data axes; a client's batch is local
        rules["batch"] = None

    if kind == "decode":
        # decode KV caches shard over the model axis; tiny global batches
        # also spread the KV over the data axes
        if global_batch < dsize:
            rules["batch"] = None
            rules["kv_seq"] = (("pod", "data", "model") if multi
                               else ("data", "model"))
        else:
            rules["kv_seq"] = "model"
    if overrides:
        rules.update(overrides)
    return rules


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def batch_specs(model_cfg: ModelConfig, shape: ShapeConfig,
                wssl_cfg: Optional[WSSLConfig] = None
                ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """(meta tensor tree, logical-axes tree) of the step's data input."""
    s, gb = shape.seq_len, shape.global_batch
    f = model_cfg.frontend_tokens if model_cfg.frontend == "vision" else 0
    i32, act = torch.int32, torch_dtype(model_cfg.dtype)
    if shape.kind == "train":
        n = wssl_cfg.num_clients
        b = max(gb // n, 1)
        specs = {"tokens": _spec((n, b, s - f), i32),
                 "labels": _spec((n, b, s - f), i32)}
        axes = {"tokens": ("client", None, None),
                "labels": ("client", None, None)}
        if f:
            specs["embeds"] = _spec((n, b, f, model_cfg.d_model), act)
            axes["embeds"] = ("client", None, None, None)
        return specs, axes
    if shape.kind == "prefill":
        specs = {"tokens": _spec((gb, s - f), i32)}
        axes = {"tokens": ("batch", None)}
        if f:
            specs["embeds"] = _spec((gb, f, model_cfg.d_model), act)
            axes["embeds"] = ("batch", None, None)
        return specs, axes
    # decode: one new token a row against a seq_len-deep cache
    specs = {"tokens": _spec((gb, 1), i32), "pos": _spec((gb,), i32)}
    axes = {"tokens": ("batch", None), "pos": ("batch",)}
    return specs, axes


def serve_param_specs(model_cfg: ModelConfig):
    """The serving params on meta, and their axes: matrices in the
    config's compute dtype (bf16 at every full-size config), as the
    engine holds them."""
    return tf.abstract_params(model_cfg, dtype=torch_dtype(model_cfg.dtype))


def decode_window(model_cfg: ModelConfig, shape: ShapeConfig
                  ) -> Optional[int]:
    """The long-context decode window of ``long_500k``, else None."""
    return (model_cfg.long_context_window if shape.name == "long_500k"
            else None)


def cache_specs(model_cfg: ModelConfig, shape: ShapeConfig
                ) -> Tuple[Any, Any]:
    """The decode cache on meta (``long_500k`` under the long-context
    window), and its axes."""
    override = decode_window(model_cfg, shape)
    cache = tf.init_cache(model_cfg, shape.global_batch, shape.seq_len,
                          decode_window_override=override, device="meta")
    return cache, tf.cache_axes(model_cfg, decode_window_override=override)


def shardings_from_axes(mesh, rules: Dict, axes_tree, specs_tree):
    """The placement tree matching an (axes, specs) pair."""
    return placement_tree(mesh, rules, axes_tree, specs_tree)


def replicated(mesh) -> Tuple:
    """The placement of a replicated value (``PartitionSpec()``)."""
    return ()
