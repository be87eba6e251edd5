"""Sharded checkpointing with atomic commit (the reference's on-disk format).

Layout, the same as ``repro/checkpoint/ckpt.py`` writes:
  <dir>/step_<N>/manifest.json       — tree structure, shapes, dtypes, step
  <dir>/step_<N>/shard_<i>.npz       — flat arrays (chunked by size)
  <dir>/LATEST                       — committed pointer (atomic rename)

Fault-tolerance contract: a crash at any point leaves either the previous
LATEST or the new one — never a torn checkpoint.

The reference flattens trees with ``jax.tree_util``; this package keeps its
own flattener, which walks dicts in sorted key order, NamedTuples in field
order and other lists and tuples in index order (``None`` holds no leaf) and
renders each leaf's path as ``jax.tree_util.keystr`` does (``['name']`` for
a dict key, ``.name`` for a NamedTuple field, ``[0]`` for a sequence item,
nested by concatenation): a training checkpoint's ``(Params, OptState)``
reads ``[0].layers.attn.wq``, ``[1].step``, ``[1].m.embed``.  Tensors are
written as numpy arrays (``.cpu().numpy()``), so a checkpoint written by
either package reads in the other.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile

import numpy as np
import torch

_MAX_SHARD_BYTES = 1 << 30


def _is_namedtuple(tree) -> bool:
    return isinstance(tree, tuple) and hasattr(type(tree), "_fields")


def _flatten_with_paths(tree, prefix: str = "") -> list:
    """[(path, leaf)] in ``jax.tree_util.tree_flatten_with_path`` order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten_with_paths(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [item for k, v in zip(tree._fields, tree)
                for item in _flatten_with_paths(v, f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in _flatten_with_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _unflatten(tree_like, leaves):
    """Rebuild ``tree_like``'s structure with ``leaves`` (an iterator, in
    :func:`_flatten_with_paths` order) in place of its leaves."""
    if tree_like is None:
        return None
    if isinstance(tree_like, dict):
        return {k: _unflatten(tree_like[k], leaves) for k in sorted(tree_like)}
    if _is_namedtuple(tree_like):
        return type(tree_like)(*(_unflatten(v, leaves) for v in tree_like))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(_unflatten(v, leaves) for v in tree_like)
    return next(leaves)


def _as_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save(directory: str, step: int, tree, extra: dict | None = None) -> str:
    """Write checkpoint for `step`; atomically commit LATEST."""
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, f"step_{step}")
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        entries = _flatten_with_paths(tree)
        manifest = {"step": step, "extra": extra or {}, "arrays": [],
                    "n_shards": 0}
        shard, shard_bytes, shard_idx = {}, 0, 0

        def flush():
            nonlocal shard, shard_bytes, shard_idx
            if shard:
                np.savez(os.path.join(tmp, f"shard_{shard_idx}.npz"), **shard)
                shard, shard_bytes = {}, 0
                shard_idx += 1

        for i, (path, arr) in enumerate(entries):
            a = _as_numpy(arr)
            key = f"a{i}"
            manifest["arrays"].append(
                {"path": path, "key": key, "shard": shard_idx,
                 "shape": list(a.shape), "dtype": str(a.dtype)}
            )
            shard[key] = a
            shard_bytes += a.nbytes
            if shard_bytes >= _MAX_SHARD_BYTES:
                flush()
        flush()
        manifest["n_shards"] = shard_idx
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    # atomic commit
    ptr_tmp = os.path.join(directory, ".LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(f"step_{step}")
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    return final


def latest_step(directory: str) -> int | None:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    return int(name.split("_")[1])


def restore(directory: str, tree_like, step: int | None = None):
    """Restore into the structure of `tree_like` (shapes must match).

    Arrays come back as numpy; the caller puts them on its device.
    Returns (tree, step, extra).
    """
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    base = os.path.join(directory, f"step_{step}")
    with open(os.path.join(base, "manifest.json")) as f:
        manifest = json.load(f)
    shards = {}
    by_path = {}
    for meta in manifest["arrays"]:
        si = meta["shard"]
        if si not in shards:
            shards[si] = np.load(os.path.join(base, f"shard_{si}.npz"))
        by_path[meta["path"]] = shards[si][meta["key"]]

    leaves = []
    for path, like in _flatten_with_paths(tree_like):
        if path not in by_path:
            raise KeyError(f"checkpoint missing leaf {path}")
        a = by_path[path]
        want = tuple(np.shape(like))
        if tuple(a.shape) != want:
            raise ValueError(f"{path}: ckpt shape {a.shape} != {want}")
        leaves.append(a)
    return (_unflatten(tree_like, iter(leaves)), manifest["step"],
            manifest["extra"])
