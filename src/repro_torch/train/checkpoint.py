"""Step-atomic checkpointing with a manifest: the JAX package's layout.

Layout:  <dir>/step_<N>/
           manifest.json     — leaf count, shapes, dtypes, step
           leaf_<i>.npy      — one file per tree leaf (host numpy)
         <dir>/step_<N>.tmp  → fsync → rename (atomic publish)

A tree is nested dicts, tuples (``OptState``) and ``None``, with array
leaves (numpy, or tensors on any device: saved from the host). Its leaves
are numbered in the JAX package's flatten order (dict keys sorted,
tuples in field order, ``None`` holds none), so either package restores
the other's checkpoint: the trainer saves ``{"params", "opt_state"}`` in
the reference's layout (``transformer.params_to_reference``), each
segment's layers stacked. ``restore`` returns numpy leaves (memory-mapped:
a rank that restores its shards reads only them); the caller puts them on
its device.

A leaf may also be a function of no arguments that returns the array: a
sharded model's leaves are gathered one at a time as they are written, so
the whole tree never sits on the host. Every rank of a mesh calls ``save``
(each gather is a collective) and one writes (``write=True``).
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, List, Optional, Tuple

import numpy as np
import torch


def tree_leaves(tree: Any) -> List[Any]:
    """Leaves in the JAX package's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for sub in tree for leaf in tree_leaves(sub)]
    return [tree]


def tree_unflatten(like: Any, leaves: List[Any]) -> Any:
    """``like``'s structure with ``leaves`` in flatten order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(sub) for sub in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    tree = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return tree


def _host(leaf: Any) -> np.ndarray:
    if callable(leaf):
        leaf = leaf()
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, tree: Any, *, step: int, keep: int = 3,
         write: bool = True) -> str:
    """Write ``tree`` as step ``step`` and keep the newest ``keep`` steps.
    With ``write=False`` every leaf is evaluated (a gathered leaf's
    collectives joined) and nothing is written."""
    final = os.path.join(directory, f"step_{step:08d}")
    if not write:
        for leaf in tree_leaves(tree):
            _host(leaf)
        return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    flat = tree_leaves(tree)
    manifest = {
        "step": step,
        "treedef": "repro_torch: leaves in the JAX package's flatten order",
        "n_leaves": len(flat),
        "shards": 1,
        "leaves": [],
    }
    for i, leaf in enumerate(flat):
        arr = _host(leaf)
        np.save(os.path.join(tmp, f"leaf_{i}.npy"), arr)
        manifest["leaves"].append(
            {"shape": list(arr.shape), "dtype": str(arr.dtype)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)           # atomic publish
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int) -> None:
    steps = sorted(
        d for d in os.listdir(directory)
        if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(directory, d, "manifest.json"))]
    return max(steps) if steps else None


def restore(directory: str, step: int, *, like: Any) -> Any:
    """Load step's tree with ``like``'s structure, numpy leaves. The leaf
    count, shapes and dtypes must be ``like``'s where ``like`` has
    arrays."""
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    want = tree_leaves(like)
    if manifest["n_leaves"] != len(want):
        raise ValueError(f"checkpoint {path} holds {manifest['n_leaves']} "
                         f"leaves, the tree {len(want)}")
    leaves = []
    for i, w in enumerate(want):
        arr = np.load(os.path.join(path, f"leaf_{i}.npy"), mmap_mode="r")
        if tuple(arr.shape) != tuple(w.shape):
            raise ValueError(f"leaf {i} of {path} has shape {arr.shape}, "
                             f"the tree {tuple(w.shape)}")
        leaves.append(arr)
    return tree_unflatten(like, leaves)


def restore_latest(directory: str, *, like: Any
                   ) -> Optional[Tuple[Any, int]]:
    step = latest_step(directory)
    if step is None:
        return None
    return restore(directory, step, like=like), step
