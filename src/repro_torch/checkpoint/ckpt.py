"""Checkpoints in the reference's layout (``repro.checkpoint.ckpt``), so
either package restores the other's.

Layout:  <dir>/step_<n>/
             manifest.msgpack     {step, meta, process_count,
                                   keys: {key: {shape, dtype[, stored_as]}}}
             shard_<p>.npz        the arrays, npz keys with "/" -> "__"

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
* Over a rank mesh (``mesh=``): a leaf may be a ``Blocks`` — this rank's
  block of a leaf split under a spec.  Every key is written whole, by one
  rank: leaf ``i`` of the flattened tree by rank ``i % world``, which
  gathers its blocks (one whole leaf in flight at a time) into its
  ``shard_<rank>.npz``; ``process_count`` is the world size.  After a
  barrier has seen every rank's file, rank 0 writes the manifest and
  publishes the directory.  A restore onto a mesh reads each key from
  whichever shard holds it and keeps the rank's block of every ``Blocks``
  target, whatever mesh (or package: the reference reads every shard
  file) wrote it.
"""

from __future__ import annotations

import os
import shutil
import zipfile
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.checkpoint import codec
from repro_torch.sharding import rules as R


class Blocks:
    """A checkpoint leaf held as blocks over a rank mesh: its whole shape
    ``full``, its spec (``sharding.rules``) and its torch ``dtype``.  To
    save, ``block()`` makes this rank's block (a tensor); as a restore
    target it needs none."""

    def __init__(self, full, spec, dtype: torch.dtype,
                 block: Optional[Callable[[], torch.Tensor]] = None):
        self.full = tuple(full)
        self.spec = tuple(spec)
        self.dtype = dtype
        self.block = block

    def whole(self, mesh, dst: int) -> Optional[np.ndarray]:
        """The whole leaf on rank ``dst`` (numpy; bf16 as float32), from
        every rank's block; None on the other ranks.  Collective."""
        parts = mesh.gather_to(self.block(), dst)
        if parts is None:
            return None
        out = np.empty(self.full, dtype=parts[0].numpy().dtype)
        for r, part in enumerate(parts):
            out[R.block_slices(self.full, self.spec, mesh,
                               mesh.coords_of(r))] = part.numpy()
        return out


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
    if isinstance(leaf, (torch.Tensor, Blocks)):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def _shape(leaf) -> list:
    return list(leaf.full if isinstance(leaf, Blocks) else
                np.shape(leaf) if not isinstance(leaf, torch.Tensor)
                else leaf.shape)


class _NpzWriter:
    """An ``.npz`` written member by member (``np.savez``'s layout), so a
    rank holds one whole array at a time."""

    def __init__(self, path: str):
        self.zf = zipfile.ZipFile(path, "w", zipfile.ZIP_STORED,
                                  allowZip64=True)

    def write(self, key: str, arr: np.ndarray) -> None:
        with self.zf.open(key.replace("/", "__") + ".npy", "w",
                          force_zip64=True) as f:
            np.lib.format.write_array(f, np.asanyarray(arr),
                                      allow_pickle=False)

    def close(self) -> None:
        self.zf.close()


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    meta: Optional[Dict] = None, mesh=None) -> str:
    """Write ``tree`` as checkpoint ``step``.  One process (no ``mesh``,
    or a mesh of one rank) writes every leaf to ``shard_0.npz``; over a
    rank mesh every rank calls this with its blocks, and rank ``r`` writes
    the whole leaves ``i`` with ``i % world == r`` to ``shard_<r>.npz``.
    Leaves that are not ``Blocks`` are the same on every rank."""
    world = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if rank == 0:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
    if world > 1:
        mesh.barrier()

    manifest = {"step": step, "meta": meta or {}, "process_count": world,
                "keys": {}}
    out = _NpzWriter(os.path.join(tmp, f"shard_{rank}.npz"))
    try:
        for i, (key, leaf) in enumerate(_flatten(tree)):
            dtype = _dtype_name(leaf)
            manifest["keys"][key] = {"shape": _shape(leaf), "dtype": dtype}
            if dtype == "bfloat16":
                manifest["keys"][key]["stored_as"] = "float32"
            owner = i % world
            if isinstance(leaf, Blocks):
                arr = leaf.whole(mesh, owner) if world > 1 else \
                    _to_numpy(leaf.block())
            else:
                arr = _to_numpy(leaf) if rank == owner else None
            if rank == owner:
                out.write(key, arr)
            del arr
    finally:
        out.close()
    if world > 1:
        mesh.barrier()                     # every rank's shard is written
    if rank == 0:
        with open(os.path.join(tmp, "manifest.msgpack"), "wb") as f:
            f.write(codec.packb(manifest))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                  # atomic publish
    if world > 1:
        mesh.barrier()                     # published before any rank goes on
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


def restore_checkpoint(ckpt_dir: str, step: int, target: Any,
                       mesh=None) -> Any:
    """``target``: a tree of torch tensors, numpy arrays or (with
    ``mesh``, this rank's position) ``Blocks``, giving the structure and
    each leaf's dtype.  Returns (tree, meta): the same structure with CPU
    torch tensors where ``target`` has tensors (cast to their dtype),
    numpy arrays where it has arrays, and this rank's block (a CPU tensor
    of the leaf's dtype) where it has ``Blocks``.  Keys are read one at a
    time from whichever shard file holds them."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    manifest = read_manifest(ckpt_dir, step)
    files = [np.load(os.path.join(path, fn)) for fn in sorted(os.listdir(
        path)) if fn.startswith("shard_") and fn.endswith(".npz")]
    try:
        where = {k.replace("__", "/"): z for z in files for k in z.files}
        leaves = {}
        for key, leaf in _flatten(target):
            arr = where[key][key.replace("/", "__")]
            stored_bf16 = manifest["keys"][key].get("stored_as") == \
                "float32"
            if isinstance(leaf, Blocks):
                arr = arr[R.block_slices(arr.shape, leaf.spec, mesh,
                                         mesh.coords)]
                leaf = torch.empty((), dtype=leaf.dtype)
            if isinstance(leaf, torch.Tensor):
                t = torch.as_tensor(arr if arr.flags.c_contiguous
                                    else arr.copy())
                if stored_bf16:
                    t = t.to(torch.bfloat16)
                leaves[key] = t.to(leaf.dtype)
            else:       # numpy has no bf16: a stored bf16 leaf stays float32
                leaves[key] = arr.astype(np.asarray(leaf).dtype)
            del arr
    finally:
        for z in files:
            z.close()
    return _unflatten(target, leaves), manifest["meta"]
