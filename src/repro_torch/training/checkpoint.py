"""Checkpoint/restore — the counterpart of the reference's
``repro/training/checkpoint.py``, in the same format.

Atomic step-tagged snapshots of a nested dict of tensors: the leaves, in
sorted-key order (the order ``jax.tree_util`` flattens a dict tree in), go
into one ``leaves.npz`` beside a ``manifest.json``, written to a temp dir
and renamed to ``step_XXXXXXXXXX``.  A checkpoint the reference wrote
restores into the port's state of the same tree, and the port's into the
reference's.  bfloat16 leaves are stored as their uint16 bit patterns
(``weights.to_numpy``) and restored bit-exact.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.training.optimizer import tree_items, tree_unflatten
from repro_torch.weights import from_reference, to_numpy

_MANIFEST = "manifest.json"


def _ckpt_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def save(root: str, step: int, tree: Any, sh=None) -> str:
    """Atomically save a snapshot of ``tree`` for ``step``.  Returns the
    path.  ``sh`` (a ``ShardingCtx`` over a mesh): ``tree`` is a group's
    training state, saved unsharded — the solo state's tree, which the
    solo port, another group and the reference restore."""
    if sh is not None and sh.mesh is not None:
        tree = _layout(sh).unshard_state(tree)
    os.makedirs(root, exist_ok=True)
    items = list(tree_items(tree))
    arrays = {f"leaf_{i}": to_numpy(x) for i, (_, x) in enumerate(items)}
    final = _ckpt_dir(root, step)
    tmp = tempfile.mkdtemp(dir=root, prefix=".tmp_ckpt_")
    try:
        np.savez(os.path.join(tmp, "leaves.npz"), **arrays)
        manifest = {
            "step": step,
            "n_leaves": len(items),
            "treedef": "/".join(".".join(path) for path, _ in items),
            "dtypes": [str(x.dtype).replace("torch.", "") for _, x in items],
            "shapes": [list(x.shape) for _, x in items],
        }
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):  # overwrite an existing snapshot atomically
            os.rename(final, tmp + ".old")
        os.rename(tmp, final)
    finally:
        for stale in (tmp, tmp + ".old"):
            if os.path.exists(stale):
                shutil.rmtree(stale, ignore_errors=True)
    return final


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        m = re.fullmatch(r"step_(\d+)", name)
        if m and os.path.exists(os.path.join(root, name, _MANIFEST)):
            steps.append(int(m.group(1)))
    return max(steps) if steps else None


def _layout(sh):
    from repro_torch.training.train_step import GroupLayout

    return GroupLayout(sh.cfg, sh)


def restore(root: str, like: Any, step: Optional[int] = None, sh=None
            ) -> Tuple[Any, int]:
    """Restore into the structure of ``like``, each leaf on the device of
    ``like``'s leaf.  Returns (tree, step).  ``sh`` over a mesh: ``like``
    is a group's training state, restored from an unsharded checkpoint
    into each slot's shards."""
    if sh is not None and sh.mesh is not None:
        lay = _layout(sh)
        whole, step = restore(root, lay.unshard_state(like), step)
        return lay.shard_state(whole), step
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root}")
    path = _ckpt_dir(root, step)
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    items = list(tree_items(like))
    if manifest["n_leaves"] != len(items):
        raise ValueError(
            f"checkpoint has {manifest['n_leaves']} leaves, expected "
            f"{len(items)}")
    leaves = []
    with np.load(os.path.join(path, "leaves.npz")) as data:
        for i, (_, ref) in enumerate(items):
            a = data[f"leaf_{i}"]
            if ref.dtype == torch.bfloat16 and a.dtype == np.uint16:
                t = torch.from_numpy(a.copy()).view(torch.bfloat16)
                leaves.append(t.to(ref.device))
            else:
                leaves.append(from_reference(a, ref.device))
    return tree_unflatten(like, leaves), step
