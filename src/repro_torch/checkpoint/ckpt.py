"""Checkpoints in the reference's layout (``repro.checkpoint.ckpt``), so
either package restores the other's.

Layout:  <dir>/step_<n>/
             manifest.msgpack     {step, meta, process_count,
                                   keys: {key: {shape, dtype[, stored_as]}}}
             shard_0.npz          the arrays, npz keys with "/" -> "__"

* Keys are the reference's tree-path strings: dict keys, tuple indices and
  ``.field`` for a NamedTuple's fields, joined with "/" — e.g. a train
  state ``(params, OptState)`` gives ``0/embed``, ``0/g0/b0/attn/wq``,
  ``1/.m/embed``, ``1/.step``.  The training path hands over the
  reference's tree (``bridge.ref_tree`` / ``opt_state_to_jax``).
* Leaves are torch tensors or numpy arrays; bf16 is stored as float32
  (``stored_as``) and cast back on restore, exactly.
* save writes a ``.tmp`` directory and renames it into place, so a crash
  mid-save never leaves a partial checkpoint; ``latest_step`` skips
  ``.tmp`` directories.
* The manifest is MessagePack through ``checkpoint.codec`` (the
  ``msgpack`` package is not required).
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import codec


def _flatten(tree, prefix=()):
    """(key, leaf) pairs in the order ``jax.tree_util`` flattens the same
    tree: dict keys sorted, NamedTuple fields and tuple entries in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], prefix + (str(k),))
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for f in tree._fields:
            yield from _flatten(getattr(tree, f), prefix + ("." + f,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _flatten(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _unflatten(tree, leaves: Dict[str, Any], prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten(v, leaves, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, f), leaves,
                                       prefix + ("." + f,))
                            for f in tree._fields))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_unflatten(v, leaves, prefix + (str(i),))
                          for i, v in enumerate(tree))
    return leaves["/".join(prefix)]


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    meta: Optional[Dict] = None) -> str:
    """One process writes every leaf to ``shard_0.npz``."""
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)

    manifest = {"step": step, "meta": meta or {}, "process_count": 1,
                "keys": {}}
    arrays = {}
    for key, leaf in _flatten(tree):
        dtype = _dtype_name(leaf)
        arr = _to_numpy(leaf)
        manifest["keys"][key] = {"shape": list(arr.shape), "dtype": dtype}
        if dtype == "bfloat16":
            manifest["keys"][key]["stored_as"] = "float32"
        arrays[key.replace("/", "__")] = arr
    np.savez(os.path.join(tmp, "shard_0.npz"), **arrays)
    with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
        f.write(codec.packb(manifest))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic publish
    return final


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def read_manifest(ckpt_dir: str, step: int) -> dict:
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "manifest.msgpack")
    with open(path, "rb") as f:
        return codec.unpackb(f.read())


def restore_checkpoint(ckpt_dir: str, step: int, target: Any) -> Any:
    """``target``: a tree of torch tensors or numpy arrays giving the
    structure and each leaf's dtype.  Returns (tree, meta): the same
    structure with CPU torch tensors where ``target`` has tensors (cast
    to their dtype) and numpy arrays where it has arrays."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = read_manifest(ckpt_dir, step)
    data = {}
    for fn in os.listdir(path):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                for k in z.files:
                    data[k.replace("__", "/")] = z[k]
    leaves = {}
    for key, leaf in _flatten(target):
        arr = data[key]
        stored_bf16 = manifest["keys"][key].get("stored_as") == "float32"
        if isinstance(leaf, torch.Tensor):
            t = torch.as_tensor(arr)
            if stored_bf16:
                t = t.to(torch.bfloat16)
            leaves[key] = t.to(leaf.dtype)
        else:       # numpy has no bf16: a stored bf16 leaf stays float32
            leaves[key] = arr.astype(np.asarray(leaf).dtype)
    return _unflatten(target, leaves), manifest["meta"]
