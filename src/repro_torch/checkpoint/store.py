"""Checkpoint store: npz shard + atomic-rename commit, on the reference's
on-disk layout, so either package restores what the other wrote.

Layout (one directory per step)::

    <dir>/step_00000042.tmp/ -> (write) -> <dir>/step_00000042/   (atomic rename)
        meta.json              leaf names + shapes + dtypes + step
        shard_<host>.npz       the leaf arrays as ``leaf_<i>``
    <dir>/LATEST               text file holding the last committed step

A tree is a (nested) dict, named tuple, list or tuple whose leaves are
tensors or arrays.  Leaves are numbered in the order ``jax.tree``
flattens such a tree: dict keys sorted, fields and sequences in order.
The commit protocol (write
tmp, fsync, rename, update LATEST last) means a failure at any point
leaves the previous checkpoint intact.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch


def _flatten(tree, path=()) -> list[tuple[tuple, Any]]:
    """(path, leaf) pairs in ``jax.tree`` order: dict keys sorted,
    named-tuple fields, lists and tuples in order; anything else is a
    leaf.  Path parts name leaves as the reference's ``meta.json`` does."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _flatten(tree[k], path + (k,))]
    if hasattr(tree, "_fields"):
        return [pair for k in tree._fields
                for pair in _flatten(getattr(tree, k), path + (f".{k}",))]
    if isinstance(tree, (list, tuple)):
        return [pair for i, v in enumerate(tree) for pair in _flatten(v, path + (i,))]
    return [(path, tree)]


def _unflatten(tree, leaves) -> Any:
    """``tree``'s structure with its leaves replaced, in :func:`_flatten` order."""
    if isinstance(tree, dict):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(v, leaves) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(directory: str, step: int, tree: Any,
                    host_id: int = 0) -> str:
    """Write one checkpoint atomically; returns the committed path."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat = _flatten(tree)
    arrs = {f"leaf_{i}": _to_numpy(leaf) for i, (_, leaf) in enumerate(flat)}
    np.savez(os.path.join(tmp, f"shard_{host_id:05d}.npz"), **arrs)
    meta = {
        "step": step,
        "names": ["/".join(str(p) for p in path) for path, _ in flat],
        "shapes": [list(a.shape) for a in arrs.values()],
        "dtypes": [str(a.dtype) for a in arrs.values()],
    }
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, final)                     # atomic commit
    with open(os.path.join(directory, "LATEST.tmp"), "w") as f:
        f.write(str(step))
        f.flush()
        os.fsync(f.fileno())
    os.replace(os.path.join(directory, "LATEST.tmp"),
               os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> Optional[int]:
    p = os.path.join(directory, "LATEST")
    if not os.path.exists(p):
        return None
    with open(p) as f:
        return int(f.read().strip())


def _restore_leaf(like, arr: np.ndarray):
    """``arr`` in the form of ``like``: a tensor on ``like``'s device and
    dtype, an array of ``like``'s dtype, or the array itself."""
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(arr).to(device=like.device, dtype=like.dtype)
    if hasattr(like, "dtype"):
        return arr.astype(like.dtype)
    return arr


def restore_checkpoint(directory: str, tree_like: Any,
                       step: Optional[int] = None, host_id: int = 0) -> Any:
    """Restore into the structure of ``tree_like`` (shapes must match)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    flat = _flatten(tree_like)
    with np.load(os.path.join(path, f"shard_{host_id:05d}.npz")) as data:
        leaves = [_restore_leaf(like, data[f"leaf_{i}"]) for i, (_, like) in enumerate(flat)]
    return _unflatten(tree_like, iter(leaves))
