"""What one rank of ``tests/test_torch_model_axis.py`` and
``tests/test_torch_model_axis_decode.py`` runs.

The tests spawn gloo ranks of a ``data x model`` grid on the CPU through
``repro_torch.launch.mesh.spawn_grid``; a spawned rank unpickles its
function from this module, which imports no JAX (the test module does).

:func:`run_grid` takes three kinds of case, each a dict:

* ``kind="prefill"``: ``cfg`` (the port's), ``params`` (the JAX param
  tree as numpy), ``tokens`` (numpy (B, S)) and ``overrides`` of
  ``build_rules``; the rank builds the whole tree with ``params_from_jax``,
  keeps its blocks (``_bridge.shard_params``) and runs the sharded
  ``make_prefill_step`` (with ``overrides``, :func:`prefill_under` the
  overridden rules) under the op counter.  It returns its rows'
  logits, its held bytes, ``device_bytes`` for the same tree, the
  collective log and the op counter's collective bytes by kind.
* ``kind="moe"``: ``cfg``, ``params`` (one MoE layer's JAX tree, numpy)
  and ``x`` (numpy (B, S, D)); the rank keeps its experts and its rows of
  ``x`` and runs ``models/moe.py::apply_moe`` under the prefill rules (or
  ``rules``: ``"decode"``, whose rows arrive whole at a batch below the
  data axis).  It returns its rows' output and the aux loss.
* ``kind="decode"``: ``cfg``, ``params``, ``tokens`` (the prompts, numpy
  (B, S)), ``feed`` (numpy (B, n): the tokens decoded, one a step),
  ``pos0`` (numpy (B,): each row's first decode position), ``max_len``,
  ``shape`` (an ``INPUT_SHAPES`` name) and optional ``cuts``.  Under
  ``build_rules(grid, cfg, "decode", B)`` the rank keeps its param blocks,
  builds its cache blocks (``tf.init_cache`` under the binding), prefills
  its rows into them (``impl="kernel"``) and decodes ``n`` steps through
  ``make_serve_step(cfg, shape, grid)``, or with ``cuts`` through
  ``tf.split_decode_step`` on its partitioned blocks under the same
  binding.  It returns its rows' prefill and step logits, its cache
  blocks after the prefill, its held bytes of params and cache beside
  ``device_bytes`` (the params' under the prefill rules too), and the
  first step's collective log and op-counter bytes by kind.
"""

import numpy as np
import torch

from repro_torch import _bridge, sharding
from repro_torch.config import INPUT_SHAPES
from repro_torch.launch.specs import build_rules, decode_window
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import moe
from repro_torch.models import transformer as tf
from repro_torch.roofline import op_cost
from repro_torch.tree import tree_leaves


def prefill_under(cfg, grid, rules, params, tokens):
    """What the sharded prefill step computes, under ``rules`` in place of
    the ``build_rules`` it binds: this rank's rows of ``tokens`` through
    ``tf.forward``, last-position logits."""
    with torch.no_grad(), sharding.use_sharding_rules(grid, rules):
        rows = sharding.shard_activation(tokens, "batch", None)
        return tf.forward(params, cfg, rows, impl="kernel", remat=False,
                          last_only=True)[0]


def _prefill(grid, device, case):
    cfg = case["cfg"]
    whole = _bridge.params_from_jax(case["params"], cfg, device=device)
    tokens = torch.as_tensor(case["tokens"], device=device)
    rules = build_rules(grid, cfg, "prefill", tokens.shape[0],
                        overrides=case.get("overrides"))
    axes = tf.param_axes_tree(cfg)
    blocks = _bridge.shard_params(whole, grid, rules, axes)
    want = sharding.device_bytes(grid, rules, axes, whole)
    del whole
    if case.get("overrides"):
        def step(params, batch):
            return prefill_under(cfg, grid, rules, params, batch["tokens"])
    else:
        step = make_prefill_step(cfg, "kernel", grid=grid)
    sharding.reset_collective_stats()
    with op_cost.OpCounter() as counter:
        logits = step(blocks, {"tokens": tokens})
    tot = counter.totals()
    return {"logits": logits.cpu().numpy(),
            "held_bytes": sum(t.numel() * t.element_size()
                              for t in tree_leaves(blocks)),
            "device_bytes": want,
            "stats": sharding.collective_stats(),
            "coll": {k: v for k, v in tot.items() if k.startswith("coll_")
                     and k != "coll_weighted"}}


def _moe(grid, device, case):
    cfg = case["cfg"]
    layer = {k: torch.as_tensor(np.asarray(v, np.float32), device=device)
             for k, v in case["params"].items()}
    x = torch.as_tensor(case["x"], device=device)
    rules = build_rules(grid, cfg, case.get("rules", "prefill"), x.shape[0],
                        overrides={"fsdp": None})
    axes = tf._mlp_axes(cfg, cfg.layer_specs()[0])
    blocks = _bridge.shard_params(layer, grid, rules, axes)
    with torch.no_grad(), sharding.use_sharding_rules(grid, rules):
        out, aux = moe.apply_moe(cfg, blocks, sharding.shard_activation(
            x, "batch", None, None))
    return {"out": out.cpu().numpy(), "aux": float(aux),
            "experts": blocks["wu"].shape[0]}


def _nbytes(tree):
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _coll(counter):
    return {k.removeprefix("coll_"): v for k, v in counter.totals().items()
            if k.startswith("coll_") and k != "coll_weighted"}


def _decode(grid, device, case):
    cfg = case["cfg"]
    whole = _bridge.params_from_jax(case["params"], cfg, device=device)
    tokens = torch.as_tensor(case["tokens"], device=device)
    feed = torch.as_tensor(case["feed"], device=device)
    pos0 = torch.as_tensor(case["pos0"], device=device)
    b = tokens.shape[0]
    shape = INPUT_SHAPES[case["shape"]]
    override = decode_window(cfg, shape)
    rules = build_rules(grid, cfg, "decode", b)
    axes = tf.param_axes_tree(cfg)
    blocks = _bridge.shard_params(whole, grid, rules, axes)
    out = {"held_bytes": _nbytes(blocks),
           "device_bytes": sharding.device_bytes(grid, rules, axes, whole),
           "prefill_device_bytes": sharding.device_bytes(
               grid, build_rules(grid, cfg, "prefill", b), axes, whole)}
    del whole
    whole_cache = tf.init_cache(cfg, b, case["max_len"], device="meta",
                                decode_window_override=override)
    with torch.no_grad(), sharding.use_sharding_rules(grid, rules):
        cache = tf.init_cache(cfg, b, case["max_len"], device=device,
                              decode_window_override=override)
        rows = sharding.shard_activation(tokens, "batch", None)
        logits, _ = tf.prefill(blocks, cfg, rows, cache=cache,
                               impl="kernel", last_only=True)
        cuts = case.get("cuts")
        if cuts:
            stages = tf.partition_params(blocks, cfg, cuts, copy=False)
            cstages = tf.partition_cache(cache, cfg, cuts)
    out.update(
        prefill=logits.numpy(),
        cache=[t.clone().numpy() for t in tree_leaves(cache)],
        cache_held_bytes=_nbytes(cache),
        cache_device_bytes=sharding.device_bytes(
            grid, rules, tf.cache_axes(cfg, decode_window_override=override),
            whole_cache))
    if cuts:
        def step(params, cache, batch):
            with torch.no_grad(), sharding.use_sharding_rules(grid, rules):
                local = {k: sharding.shard_activation(
                    v, "batch", *(None,) * (v.dim() - 1))
                    for k, v in batch.items()}
                return tf.split_decode_step(
                    stages, cfg, local["tokens"], cstages, local["pos"],
                    decode_window_override=override)
    else:
        step = make_serve_step(cfg, shape, grid)
    steps = []
    for i in range(feed.shape[1]):
        sharding.reset_collective_stats()
        with op_cost.OpCounter() as counter:
            lg, _ = step(blocks, cache, {"tokens": feed[:, i:i + 1],
                                         "pos": pos0 + i})
        steps.append(lg.numpy())
        if i == 0:
            out.update(stats=sharding.collective_stats(),
                       coll=_coll(counter))
    out["steps"] = np.stack(steps, axis=1)
    return out


def run_grid(grid, device, cases):
    """Every case in turn on this rank: name -> its result."""
    run = {"prefill": _prefill, "moe": _moe, "decode": _decode}
    return {"coords": grid.coords,
            **{name: run[case["kind"]](grid, device, case)
               for name, case in cases.items()}}
