"""Tree checkpointing: a flat .npz of leaves plus a JSON sidecar — the
twin of ``repro/checkpoint/io.py``, in its file format.

Each leaf is stored under its key path, dict keys and list indices joined
by ``/`` (``stack/0/mixer/wq``), as the JAX package names them, so a file
either package writes loads in the other.  The sidecar holds the metadata
given, the sorted keys and the port's tree structure (JAX writes its own
treedef there; neither loader reads it).  A bf16 leaf is stored as fp32,
which numpy can hold exactly, and a loaded leaf takes the dtype and device
of its counterpart in ``like``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch.utils._pytree import tree_structure


def _paths(tree, prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[str, torch.Tensor]]:
    """(key path, leaf) in JAX's order: dict keys sorted, lists in order;
    ``None`` holds no leaf, as in JAX."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, t in enumerate(tree):
            yield from _paths(t, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()


def save_checkpoint(path: str, tree: Any,
                    metadata: Optional[Dict] = None) -> None:
    """Write ``tree``'s leaves to ``path`` (``.npz`` appended if missing)
    and the sidecar ``<path>.json``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _to_numpy(v) for k, v in _paths(tree)}
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)
    meta = dict(metadata or {})
    meta["treedef"] = str(tree_structure(tree))
    meta["keys"] = sorted(flat)
    with open(path.removesuffix(".npz") + ".json", "w") as f:
        json.dump(meta, f, indent=2, default=str)


def load_checkpoint(path: str, like: Any) -> Any:
    """Restore into the structure of ``like`` (shapes must match); each
    leaf takes the dtype and device of ``like``'s."""
    with np.load(path if path.endswith(".npz") else path + ".npz") as npz:
        want = dict(_paths(like))
        if sorted(npz.files) != sorted(want):
            raise ValueError("checkpoint keys do not match target structure")
        loaded = {}
        for key, leaf in want.items():
            arr = npz[key]
            if arr.shape != tuple(leaf.shape):
                raise ValueError(f"shape mismatch for {key}: {arr.shape} vs "
                                 f"{tuple(leaf.shape)}")
            loaded[key] = torch.from_numpy(np.asarray(arr)).to(
                device=leaf.device, dtype=leaf.dtype)

    def rebuild(tree, prefix: Tuple[str, ...] = ()):
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(t, prefix + (str(i),))
                              for i, t in enumerate(tree))
        return None if tree is None else loaded["/".join(prefix)]

    return rebuild(like)
