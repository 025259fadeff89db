"""Checkpoint/restore with a manifest, in the reference's on-disk format.

Layout:  <dir>/step_<N>/
            manifest.json        {step, treedef, n_shards, leaves}
            leaf_<i>.npy         one file per unsharded leaf
            leaf_<i>.shard_<j>.npy   row block j of a sharded leaf
            _COMMITTED           written LAST: restart only trusts committed
                                 snapshots (a crashed save is invisible)

The snapshot is written into ``step_<N>.tmp`` and renamed into place.
With ``n_shards > 1`` every array leaf with at least ``n_shards`` rows is
split into row blocks along axis 0, each its own file, listed in the
manifest as ``{"files": [...], "axis": 0}``; restore reassembles the full
leaf, so a snapshot written under one shard count restores under any.

Leaves are numbered in the order ``jax.tree_util.tree_flatten`` gives,
without JAX: dict keys sorted, lists and tuples in order, ``None`` and
empty containers no leaf, everything else one leaf.  So a snapshot
written by either package restores in the other.  ``treedef`` holds a
description of the structure that restore never parses; it checks only
the leaf count and rebuilds the template's structure from the leaves.
"""
from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch


def tree_flatten(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_flatten`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for sub in tree for leaf in tree_flatten(sub)]
    return [tree]


def tree_unflatten(template, leaves) -> object:
    """``template``'s structure with its leaves taken from ``leaves`` in
    :func:`tree_flatten` order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return type(node)(build(sub) for sub in node)
        return next(it)

    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def tree_description(tree) -> str:
    """The structure of ``tree`` with ``*`` for each leaf (for the
    manifest's ``treedef``; never parsed)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {tree_description(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return "[" + ", ".join(tree_description(s) for s in tree) + "]"
    if isinstance(tree, tuple):
        return "(" + ", ".join(tree_description(s) for s in tree) + ")"
    return "*"


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            # numpy has no bfloat16: its 2-byte words, as the reference's
            # files hold them (np.save writes ml_dtypes' bfloat16 as V2)
            return t.view(torch.int16).numpy().view(np.dtype("V2"))
        return t.numpy()
    return np.asarray(leaf)


def save_pytree(tree, path: str, step: int, *, n_shards: int = 1) -> str:
    d = os.path.join(path, f"step_{step:08d}")
    tmp = d + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    entries = []
    for i, leaf in enumerate(tree_flatten(tree)):
        arr = _host(leaf)
        base = f"leaf_{i:05d}"
        if n_shards > 1 and arr.ndim >= 1 and arr.shape[0] >= n_shards:
            files = []
            for j, block in enumerate(np.array_split(arr, n_shards, axis=0)):
                name = f"{base}.shard_{j:03d}.npy"
                np.save(os.path.join(tmp, name), block)
                files.append(name)
            entries.append({"files": files, "axis": 0})
        else:
            name = base + ".npy"
            np.save(os.path.join(tmp, name), arr)
            entries.append(name)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, "treedef": tree_description(tree),
                   "n_shards": n_shards, "leaves": entries}, f)
    with open(os.path.join(tmp, "_COMMITTED"), "w") as f:
        f.write("ok")
    if os.path.exists(d):
        shutil.rmtree(d)
    os.rename(tmp, d)
    return d


def _load_leaf(d: str, entry) -> np.ndarray:
    if isinstance(entry, str):
        return np.load(os.path.join(d, entry))
    blocks = [np.load(os.path.join(d, n)) for n in entry["files"]]
    return np.concatenate(blocks, axis=entry.get("axis", 0))


def restore_pytree(tree_like, path: str, step: int | None = None):
    """Restore into the structure of ``tree_like``; picks the latest
    committed snapshot if ``step`` is None.  Returns (tree, step) or
    (None, -1).  Sharded leaves come back whole whatever shard count they
    were written with."""
    if step is None:
        step = latest_step(path)
        if step < 0:
            return None, -1
    d = os.path.join(path, f"step_{step:08d}")
    if not os.path.exists(os.path.join(d, "_COMMITTED")):
        return None, -1
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    if len(tree_flatten(tree_like)) != len(manifest["leaves"]):
        raise ValueError(f"snapshot {d} holds {len(manifest['leaves'])} "
                         f"leaves; the template has "
                         f"{len(tree_flatten(tree_like))}: structure changed")
    leaves = [_load_leaf(d, e) for e in manifest["leaves"]]
    return tree_unflatten(tree_like, leaves), manifest["step"]


def _steps(path: str) -> list[int]:
    """Steps of the snapshot directories under ``path`` (committed or not;
    ``.tmp`` excluded)."""
    return [int(n.split("_")[1]) for n in os.listdir(path)
            if n.startswith("step_") and not n.endswith(".tmp")]


def latest_step(path: str) -> int:
    if not os.path.isdir(path):
        return -1
    steps = [s for s in _steps(path) if os.path.exists(
        os.path.join(path, f"step_{s:08d}", "_COMMITTED"))]
    return max(steps) if steps else -1


class CheckpointManager:
    """Periodic checkpointing with retention (keep the last ``keep``)."""

    def __init__(self, path: str, every: int = 100, keep: int = 3):
        self.path = path
        self.every = every
        self.keep = keep

    def save(self, tree, step: int, *, n_shards: int = 1) -> str:
        """Unconditionally snapshot at ``step`` (with retention gc)."""
        d = save_pytree(tree, self.path, step, n_shards=n_shards)
        self._gc()
        return d

    def maybe_save(self, tree, step: int, *, n_shards: int = 1) -> bool:
        if step % self.every:
            return False
        self.save(tree, step, n_shards=n_shards)
        return True

    def restore(self, tree_like):
        return restore_pytree(tree_like, self.path)

    def prune_after(self, step: int) -> None:
        """Delete snapshots with step > ``step`` (timeline rewind): after
        restoring an older snapshot, newer ones describe a discarded
        future and must not be picked up by a later latest-step restore."""
        if not os.path.isdir(self.path):
            return
        for s in _steps(self.path):
            if s > step:
                shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                              ignore_errors=True)

    def _gc(self):
        for s in sorted(_steps(self.path))[:-self.keep]:
            shutil.rmtree(os.path.join(self.path, f"step_{s:08d}"),
                          ignore_errors=True)
