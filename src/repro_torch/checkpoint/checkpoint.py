"""Atomic checkpoints of a tree of tensors (port of
``repro/checkpoint/checkpoint.py``).

Layout per checkpoint:

    <dir>/step_000123.tmp/...      (written first)
    <dir>/step_000123/
        manifest.json              step, leaf index, the caller's extras
        arrays.npz                 every tensor leaf as a host array

Writes are atomic (tmp dir + ``os.rename``), so a preemption mid-write never
corrupts the latest checkpoint; ``keep`` prunes older ones after the new one
is published. A tree is nested dicts, lists, tuples and NamedTuples of
tensors (the engine's decode state: ``{"layers": [PagedMLAPool, ...]}``);
other leaves (None, numbers) are part of the structure and are not saved.

fp8 and bf16 tensors have no numpy dtype: they cross through a ``uint8`` /
``uint16`` view of their bytes, and the manifest names their dtype in
ml_dtypes spelling (``float8_e4m3fn``, ``bfloat16``), as the reference's
does. ``load_checkpoint(path, tree_like)`` puts each leaf on the device and
dtype of the matching ``tree_like`` leaf; with ``shardings`` (the output of
``launch.sharding.to_named`` over a mesh) each leaf comes back as a DTensor
with those placements: checkpoints are logical, so loading re-places them
on any mesh (the reference's elastic reshard on load). Every rank reads the
same file and keeps its own shard, with no collective.

A tree with DTensor leaves (the sharded train loop's) saves the same
checkpoint as its full tensors would: every rank gathers each leaf
(``full_tensor()``, a collective, so every rank of the mesh calls
``save_checkpoint``), rank 0 alone writes and publishes, and every rank
waits at a barrier until it has.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any

import numpy as np
import torch

# tensors numpy cannot hold: their bytes cross as an integer view of one width
_RAW = {torch.float8_e4m3fn: torch.uint8, torch.bfloat16: torch.uint16}


def dtype_name(dtype: torch.dtype) -> str:
    """A torch dtype in numpy / ml_dtypes spelling (``torch.bfloat16`` ->
    ``"bfloat16"``)."""
    return str(dtype).removeprefix("torch.")


def _is_dtensor(t) -> bool:
    return type(t).__name__ == "DTensor"


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``'s bytes (fp8 / bf16 as their integer view;
    a DTensor gathered whole first)."""
    if _is_dtensor(t):
        t = t.full_tensor()
    t = t.detach().cpu().contiguous()
    raw = _RAW.get(t.dtype)
    return (t.view(raw) if raw is not None else t).numpy()


def from_numpy(a: np.ndarray, dtype: str) -> torch.Tensor:
    """The tensor of dtype ``dtype`` (a ``dtype_name``) whose bytes ``a``
    holds (``to_numpy``'s inverse)."""
    dt = getattr(torch, dtype)
    t = torch.from_numpy(np.array(a, copy=True, order="C"))
    return t.view(dt) if dt in _RAW else t


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def flatten(tree: Any, path: str = "") -> list[tuple[str, torch.Tensor]]:
    """(path, tensor) for every tensor leaf, in a fixed traversal order."""
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        items = tree.items()
    elif _is_namedtuple(tree):
        items = zip(tree._fields, tree)
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return []
    return [leaf for k, v in items for leaf in flatten(v, f"{path}/{k}" if path else str(k))]


def unflatten(tree_like: Any, leaves) -> Any:
    """``tree_like`` with its tensor leaves replaced, in ``flatten`` order,
    by the next items of the iterator ``leaves``."""
    if isinstance(tree_like, torch.Tensor):
        return next(leaves)
    if isinstance(tree_like, dict):
        return {k: unflatten(v, leaves) for k, v in tree_like.items()}
    if _is_namedtuple(tree_like):
        return type(tree_like)(*(unflatten(v, leaves) for v in tree_like))
    if isinstance(tree_like, (list, tuple)):
        return type(tree_like)(unflatten(v, leaves) for v in tree_like)
    return tree_like


def _published(directory: str) -> list[str]:
    return sorted(d for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def save_checkpoint(directory: str, step: int, tree: Any,
                    extra_manifest: dict | None = None,
                    keep: int | None = None) -> str:
    """Write ``<directory>/step_<step>`` atomically and return its path.
    ``keep`` (when set) prunes the directory down to the newest ``keep``
    published checkpoints after the new one lands."""
    leaves = flatten(tree)
    sharded = any(_is_dtensor(t) for _, t in leaves)
    final = os.path.join(directory, f"step_{step:08d}")
    arrays = {f"leaf_{i:05d}": to_numpy(leaf) for i, (_, leaf) in enumerate(leaves)}
    if sharded:
        import torch.distributed as dist
        if dist.get_rank() != 0:
            dist.barrier()
            return final
    os.makedirs(directory, exist_ok=True)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    index = [{"key": f"leaf_{i:05d}", "path": name, "dtype": dtype_name(leaf.dtype),
              "shape": list(leaf.shape)} for i, (name, leaf) in enumerate(leaves)]
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {"step": step, "leaves": index}
    manifest.update(extra_manifest or {})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)       # atomic publish
    if keep is not None and keep >= 1:
        for stale in _published(directory)[:-keep]:
            shutil.rmtree(os.path.join(directory, stale))
    if sharded:
        import torch.distributed as dist
        dist.barrier()
    return final


def latest_checkpoint(directory: str) -> str | None:
    if not os.path.isdir(directory):
        return None
    steps = _published(directory)
    return os.path.join(directory, steps[-1]) if steps else None


def load_checkpoint(path: str, tree_like: Any, shardings: Any | None = None):
    """Restore into the structure of ``tree_like``: each leaf on the device
    and dtype of the matching ``tree_like`` leaf, or, with ``shardings`` (a
    tree of the same structure of ``sharding.NamedPlacements``), a DTensor
    placed by them. Returns (tree, manifest)."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    like = flatten(tree_like)
    if len(like) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, "
                         f"structure wants {len(like)}")
    with np.load(os.path.join(path, "arrays.npz")) as data:
        leaves = [from_numpy(data[e["key"]], e["dtype"]).to(device=t.device, dtype=t.dtype)
                  for e, (_, t) in zip(manifest["leaves"], like)]
    tree = unflatten(tree_like, iter(leaves))
    if shardings is not None:
        from repro_torch.launch.sharding import place
        tree = place(tree, shardings)
    return tree, manifest
