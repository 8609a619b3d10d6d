"""Checkpoint and resume of training states (port of
mpmavatar_tpu/utils/checkpoint.py).

``save_pytree`` / ``restore_pytree`` write a nested structure of tensors
(dicts, lists, tuples, numbers, optimizer ``state_dict()``s) into a
directory with ``torch.save`` and read it back with
``torch.load(weights_only=True)``; a ``STEP`` file beside it holds the
step.  ``save_npz_pytree`` / ``load_npz_pytree`` write the leaves into one
npz as ``leaf_0, leaf_1, ...`` in the JAX package's flattening order (dict
keys sorted, lists, tuples and dataclass fields in order, None no leaf),
so a file written by either package restores in the other.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Optional

import numpy as np
import torch

_TREE_FILE = "tree.pt"


def save_pytree(path: str, tree: Any, step: Optional[int] = None):
    """Save ``tree`` into the directory ``path`` (made if missing)."""
    os.makedirs(path, exist_ok=True)
    torch.save(tree, os.path.join(path, _TREE_FILE))
    if step is not None:
        with open(os.path.join(path, "STEP"), "w") as f:
            f.write(str(step))


def restore_pytree(path: str, like: Any = None):
    """(tree, step or None) from ``save_pytree``'s directory.  With
    ``like``, the structure must match it and each tensor goes to the
    device of ``like``'s tensor in its place."""
    tree = torch.load(os.path.join(path, _TREE_FILE), map_location="cpu",
                      weights_only=True)
    if like is not None:
        leaves, like_leaves = _flatten(tree), _flatten(like)
        if len(leaves) != len(like_leaves):
            raise ValueError(f"checkpoint {path!r} holds {len(leaves)} "
                             f"leaves, the target {len(like_leaves)}")
        tree = _unflatten(like, [
            a.to(b.device) if isinstance(a, torch.Tensor)
            and isinstance(b, torch.Tensor) else a
            for a, b in zip(leaves, like_leaves)])
    step = None
    step_file = os.path.join(path, "STEP")
    if os.path.exists(step_file):
        with open(step_file) as f:
            step = int(f.read().strip())
    return tree, step


def latest_checkpoint(base_dir: str, prefix: str = "step_"):
    """The ``prefix<N>`` entry of ``base_dir`` with the largest N, or None
    (the reference's searchForMaxIteration)."""
    if not os.path.isdir(base_dir):
        return None
    steps = []
    for name in os.listdir(base_dir):
        if name.startswith(prefix):
            try:
                steps.append(int(name[len(prefix):]))
            except ValueError:
                pass
    if not steps:
        return None
    return os.path.join(base_dir, f"{prefix}{max(steps)}")


def _flatten(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in _flatten(sub)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [leaf for f in dataclasses.fields(tree)
                for leaf in _flatten(getattr(tree, f.name))]
    return [tree]


def _unflatten(like, leaves: list):
    """``like``'s structure with ``leaves`` (JAX's order) in place of its
    own."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        if dataclasses.is_dataclass(node) and not isinstance(node, type):
            return dataclasses.replace(node, **{
                f.name: build(getattr(node, f.name))
                for f in dataclasses.fields(node)})
        return next(it)

    return build(like)


def _host(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_npz_pytree(path: str, tree: Any):
    """Flatten ``tree`` into one npz (leaves in JAX's order)."""
    leaves = _flatten(tree)
    np.savez(path, __treedef__=f"{len(leaves)} leaves",
             **{f"leaf_{i}": _host(l) for i, l in enumerate(leaves)})


def load_npz_pytree(path: str, like: Any):
    """``like``'s structure filled from ``save_npz_pytree``'s npz (or the
    JAX package's): each leaf a tensor, on the device of ``like``'s leaf
    where that is a tensor."""
    with np.load(path, allow_pickle=False) as data:
        like_leaves = _flatten(like)
        leaves = [torch.as_tensor(data[f"leaf_{i}"],
                                  device=getattr(ref, "device", None))
                  for i, ref in enumerate(like_leaves)]
    return _unflatten(like, leaves)
