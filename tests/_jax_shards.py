"""The JAX reference of the sharded-round tests: JAX's round body with a
``ShardCtx`` under ``jax.vmap``.

``make_sharded_round_fn`` passes ``auto=`` to ``shard_map``, which the
installed jax rejects, so the tests run the round body the way
``shard_map`` would, one shard a vmapped index: ``wssl_round(...,
shard_ctx=ShardCtx(axis="d", num_shards=S, index=axis_index("d")))``
under ``jax.jit(jax.vmap(..., axis_name="d"))``.  The state's leaves
whose logical axes lead with ``"client"`` (the rule of
``repro.sharding.round_state_specs``) are split to (S, N/S, ...) and
mapped; every other leaf is passed whole and unmapped, and the batch is
split like the client stack.  ``psum``, the tiled ``all_gather``,
``axis_index`` and ``dynamic_slice_in_dim`` all batch on one CPU device.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec

from repro import sharding as jshard
from repro.core import async_round as jar
from repro.core.round import ShardCtx, abstract_state, wssl_round
from repro.optim.schedule import make_schedule


def state_in_axes(jm, w, t):
    """Per-leaf vmap axes of the WSSLState from
    ``repro.sharding.round_state_specs`` on a one-device ("data",) mesh:
    0 where the spec shards the leaf's first dim, None where it is
    replicated (a spec over an empty subtree, such as ``ef_residual=()``,
    maps nothing)."""
    shapes, axes = abstract_state(jm, w, t)
    mesh = Mesh(np.array(jax.devices()[:1]), ("data",))
    specs = jshard.round_state_specs(mesh, axes)
    is_spec = lambda x: isinstance(x, PartitionSpec)
    flat, spec_def = jax.tree.flatten(specs, is_leaf=is_spec)
    subtrees = spec_def.flatten_up_to(shapes)
    return jax.tree.unflatten(spec_def, [
        jax.tree.map(lambda _, sp=sp: 0 if sp != PartitionSpec() else None,
                     sub) for sp, sub in zip(flat, subtrees)])


def async_in_axes(state_axes):
    return jar.AsyncState(pending=None, staleness=None,
                          buffer=state_axes.client_stack)


def _flat_axes(tree, axes):
    leaves, treedef = jax.tree.flatten(tree)
    ax = jax.tree.flatten(axes, is_leaf=lambda x: x is None)[0]
    assert len(ax) == len(leaves), (len(ax), len(leaves))
    return leaves, ax, treedef


def split(tree, axes, shards):
    """Mapped leaves (N, ...) -> (S, N/S, ...)."""
    leaves, ax, treedef = _flat_axes(tree, axes)
    return treedef.unflatten([
        l.reshape((shards, l.shape[0] // shards) + l.shape[1:])
        if a == 0 else l for l, a in zip(leaves, ax)])


def take(tree, axes):
    """A vmapped output (every leaf (S, ...)) back to the input's layout:
    mapped leaves stay split, replicated ones take shard 0."""
    leaves, ax, treedef = _flat_axes(tree, axes)
    return treedef.unflatten([l if a == 0 else l[0]
                              for l, a in zip(leaves, ax)])


def merge(tree, axes):
    """Split leaves (S, N/S, ...) -> (N, ...), as numpy."""
    leaves, ax, treedef = _flat_axes(tree, axes)
    return treedef.unflatten([
        np.asarray(l).reshape((-1,) + l.shape[2:]) if a == 0
        else np.asarray(l) for l, a in zip(leaves, ax)])


@functools.lru_cache(maxsize=None)
def sharded_round(jm, w, t, shards, impl):
    """The jitted vmapped sync round: (split state, split batch, val,
    scenario, agg_p, comp_p) -> (vmapped state, vmapped metrics)."""
    schedule = make_schedule(t.schedule, t.learning_rate, t.warmup_steps,
                             t.rounds)

    def body(state, batch, val, scenario, agg_p, comp_p):
        ctx = ShardCtx(axis="d", num_shards=shards,
                       index=jax.lax.axis_index("d"))
        return wssl_round(state, batch, val, scenario, agg_p, comp_p,
                          model_cfg=jm, wssl_cfg=w, train_cfg=t,
                          schedule=schedule, impl=impl, shard_ctx=ctx)

    return jax.jit(jax.vmap(body, in_axes=(state_in_axes(jm, w, t), 0, None,
                                           None, None, None),
                            out_axes=0, axis_name="d"))


@functools.lru_cache(maxsize=None)
def sharded_async_round(jm, w, t, shards, impl):
    """The jitted vmapped async round: (split state, split astate, split
    batch, val, scenario, async_p) -> (state, astate, metrics), vmapped."""
    schedule = make_schedule(t.schedule, t.learning_rate, t.warmup_steps,
                             t.rounds)
    st_axes = state_in_axes(jm, w, t)

    def body(state, astate, batch, val, scenario, async_p):
        ctx = ShardCtx(axis="d", num_shards=shards,
                       index=jax.lax.axis_index("d"))
        return jar.async_wssl_round(
            state, astate, batch, val, scenario, async_p, model_cfg=jm,
            wssl_cfg=w, train_cfg=t, schedule=schedule, impl=impl,
            shard_ctx=ctx)

    return jax.jit(jax.vmap(body, in_axes=(st_axes, async_in_axes(st_axes),
                                           0, None, None, None),
                            out_axes=0, axis_name="d"))


def rng_sel(state):
    """The round's selection key, from the state before it."""
    return jax.random.split(state.rng)[1]


def gumbel(state, n):
    return np.asarray(jax.random.gumbel(rng_sel(state), (n,)))


def update_draws(state, client_leaves, shards):
    """The JAX sharded round's update-compression draws: leaf i of shard
    s is ``uniform(fold_in(fold_in(fold_in(rng_sel, 0xC09), s), i),
    (N/S, m))``; returns leaf -> (S, N/S, m)."""
    key = jax.random.fold_in(rng_sel(state), 0xC09)
    out = {}
    for i, leaf in enumerate(client_leaves):
        n = leaf.shape[0]
        m = int(np.prod(leaf.shape[1:]))
        out[i] = np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, s), i),
            (n // shards, m), jnp.float32)) for s in range(shards)])
    return out


def metrics_numpy(m):
    """Vmapped metrics (every leaf (S, ...)) as shard 0's, numpy."""
    out = {}
    for f in m._fields:
        v = getattr(m, f)
        out[f] = (metrics_numpy(v) if hasattr(v, "_fields")
                  else np.asarray(v)[0])
    return out
