"""Step-scoped checkpointing with atomic commit and an integrity manifest.

Port of ``repro/train/checkpoint.py``, with its on-disk format:

    <dir>/step_000123/
        manifest.json   — step, the tree's structure, each leaf's file,
                          shape, dtype and sha256 (first 16 hex digits)
        arr_00000.npy … — one file per leaf (host numpy)
    <dir>/LATEST        — name of the newest COMMITTED step dir

Leaves go in ``jax.tree.flatten`` order (``repro_torch.tree``), and the
manifest's ``treedef`` is spelled as JAX spells it, so a checkpoint
written by either package restores in the other.  Write protocol: stage
into ``step_X.tmp``, fsync every file, rename to ``step_X``, then
rewrite LATEST through a tmp file and a rename: a crash leaves either
the old or the new checkpoint whole.  ``restore`` verifies the checksums
(``IOError`` on a mismatch) and puts each leaf on the device of the
matching leaf of ``tree_like`` (the CPU where that leaf is no tensor):
the one-card counterpart of the reference's target shardings.
``reshard_tree`` and ``rescale_train_state`` move DTensor state between
meshes (elastic rescale): each leaf is gathered on its mesh and each
rank keeps its shard of the new placements, the values unchanged.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from repro_torch import tree as T


def _leaf_checksum(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()[:16]


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    """Checkpoint a tree of tensors (or arrays).  Returns the committed
    directory."""
    leaves = T.leaves(tree)
    name = f"step_{step:08d}"
    final = os.path.join(ckpt_dir, name)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "treedef": T.treedef_str(tree), "leaves": []}
    for i, leaf in enumerate(leaves):
        arr = _host(leaf)
        fname = f"arr_{i:05d}.npy"
        with open(os.path.join(tmp, fname), "wb") as f:
            np.save(f, arr)
            f.flush()
            os.fsync(f.fileno())
        manifest["leaves"].append({
            "file": fname, "shape": list(arr.shape), "dtype": str(arr.dtype),
            "sha256_16": _leaf_checksum(arr)})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit

    latest_tmp = os.path.join(ckpt_dir, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.rename(latest_tmp, os.path.join(ckpt_dir, "LATEST"))

    _gc(ckpt_dir, keep)
    return final


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    path = os.path.join(ckpt_dir, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return int(f.read().strip().split("_")[1])


def restore(ckpt_dir: str, tree_like: Any, *, step: Optional[int] = None,
            verify: bool = True) -> tuple[Any, int]:
    """Load the latest (or given) step into the structure of
    ``tree_like``: (tree of tensors, step)."""
    step = latest_step(ckpt_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    out = []
    for meta, like in zip(manifest["leaves"], T.leaves(tree_like)):
        arr = np.load(os.path.join(d, meta["file"]))
        if verify and _leaf_checksum(arr) != meta["sha256_16"]:
            raise IOError(f"checksum mismatch in {d}/{meta['file']}")
        dev = like.device if isinstance(like, torch.Tensor) else "cpu"
        out.append(torch.from_numpy(arr).to(dev))
    return T.unflatten(tree_like, out), manifest["step"]


# ------------------------------------------------------- elastic rescale
# (down-scale and up-scale are the same operation: build the new mesh,
# resolve the same *logical* specs against it, move every leaf)

def reshard_tree(tree: Any, new_shardings: Any) -> Any:
    """Every leaf moved to its new sharding (a ``NamedSharding`` on any
    mesh): gathered where it is, then this rank's shard of the new
    placements.  A leaf whose sharding is None is left as it is."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.params import shard_tensor

    def move(x, s):
        if s is None:
            return x
        full = x.full_tensor() if isinstance(x, DTensor) else x
        return shard_tensor(full, s)
    return T.tree_map(move, tree, new_shardings)


def rescale_train_state(params, opt_state, defs, new_mesh):
    """Re-resolve the params' logical specs on ``new_mesh`` and move."""
    from repro_torch.models.params import P, NamedSharding, param_shardings
    from repro_torch.train.adamw import AdamWState
    p_sh = param_shardings(defs, new_mesh)
    opt_sh = AdamWState(NamedSharding(new_mesh, P()), p_sh, p_sh)
    return reshard_tree(params, p_sh), reshard_tree(opt_state, opt_sh)
