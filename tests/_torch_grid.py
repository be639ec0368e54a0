"""What one rank of ``tests/test_torch_model_axis.py`` runs.

The test spawns gloo ranks of a ``data x model`` grid on the CPU through
``repro_torch.launch.mesh.spawn_grid``; a spawned rank unpickles its
function from this module, which imports no JAX (the test module does).

:func:`run_grid` takes two kinds of case, each a dict:

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
  ``x`` and runs ``models/moe.py::apply_moe`` under the prefill rules.  It
  returns its rows' output and the aux loss.
"""

import numpy as np
import torch

from repro_torch import _bridge, sharding
from repro_torch.launch.specs import build_rules
from repro_torch.launch.steps import make_prefill_step
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
    rules = build_rules(grid, cfg, "prefill", x.shape[0],
                        overrides={"fsdp": None})
    axes = tf._mlp_axes(cfg, cfg.layer_specs()[0])
    blocks = _bridge.shard_params(layer, grid, rules, axes)
    with torch.no_grad(), sharding.use_sharding_rules(grid, rules):
        out, aux = moe.apply_moe(cfg, blocks, sharding.shard_activation(
            x, "batch", None, None))
    return {"out": out.cpu().numpy(), "aux": float(aux),
            "experts": blocks["wu"].shape[0]}


def run_grid(grid, device, cases):
    """Every case in turn on this rank: name -> its result."""
    run = {"prefill": _prefill, "moe": _moe}
    return {"coords": grid.coords,
            **{name: run[case["kind"]](grid, device, case)
               for name, case in cases.items()}}
