"""Pytree leaves in the JAX package's order.

``jax.tree.leaves`` takes a dict's leaves in sorted key order, while
``torch.utils._pytree`` keeps insertion order.  Wherever a leaf index is
shared with the JAX package (the per-leaf draws the round folds in, the
flattened client rows a robust rule compares), the port walks its trees
with these two functions.
"""

from __future__ import annotations

from typing import Any, List

import torch

Params = Any


def tree_leaves(tree: Params) -> List[torch.Tensor]:
    """Leaves in the JAX package's order: dict keys sorted, lists in
    order.  ``()`` has none."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for t in tree for l in tree_leaves(t)]
    return [tree]


def tree_unflatten(tree: Params, leaves) -> Params:
    """``tree``'s structure with the leaves of :func:`tree_leaves`'s order
    (an iterator) in place of its own."""
    if isinstance(tree, dict):
        vals = {k: tree_unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: vals[k] for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_unflatten(t, leaves) for t in tree)
    return next(leaves)
