"""Carry the JAX package's parameters and MLA caches (contiguous and paged),
handed over as numpy, into the port's structures.

Input is the tree ``jax.tree.map(np.asarray, tree)`` gives: nested dicts,
lists and NamedTuples of numpy arrays. Fields are read by name; nothing of
``jax`` or ``repro`` is imported. fp8 (``ml_dtypes.float8_e4m3fn``) and bf16
arrays cross bit for bit, through their raw bytes.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.kvcache import MLACache, PagedMLAPool
from repro_torch.core.mla import MLAParams
from repro_torch.models.layers import MLPParams

_RAW = {"float8_e4m3fn": (np.uint8, torch.float8_e4m3fn),
        "bfloat16": (np.int16, torch.bfloat16)}


def to_torch(x: Any, device=None) -> Any:
    """numpy array (or a dict / list / tuple / NamedTuple of them) -> torch,
    keeping fp8 and bf16 bytes exact."""
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: to_torch(v, device) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: to_torch(v, device) for k, v in zip(x._fields, x)}
    if isinstance(x, (list, tuple)):
        return [to_torch(v, device) for v in x]
    a = np.array(x, copy=True, order="C")     # a writable copy torch may own
    raw = _RAW.get(a.dtype.name)
    t = torch.from_numpy(a.view(raw[0])).view(raw[1]) if raw else torch.from_numpy(a)
    return t.to(device) if device is not None else t


def _field(x: Any, name: str) -> Any:
    return x[name] if isinstance(x, dict) else getattr(x, name)


def _unstack(tree: Any, i: int) -> Any:
    """Slice index ``i`` of the leading (scanned) axis of every array."""
    if isinstance(tree, dict):
        return {k: _unstack(v, i) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unstack(v, i) for v in tree))
    if tree is None:
        return None
    return np.asarray(tree)[i]


def _mla_params(m: Any, device) -> MLAParams:
    return MLAParams(**{f: to_torch(_field(m, f), device) for f in MLAParams._fields})


def _mlp_params(m: Any, device) -> MLPParams:
    return MLPParams(**{f: to_torch(_field(m, f), device) for f in MLPParams._fields})


def params_from_jax(np_params: dict, device=None) -> dict[str, Any]:
    """The reference ``init_model`` tree of a dense MLA model with tied
    embeddings (one-kind ``layer_pattern``, layers stacked along the
    ``scanned`` axis) -> the port's ``{"embed", "ln_f", "layers": [...]}``."""
    scanned = np_params.get("scanned")
    layers = []
    if scanned:
        if len(scanned) != 1:
            raise ValueError("only a one-kind layer pattern ('mla',) is ported")
        stacked = scanned[0]
        n = np.asarray(stacked["ln1"]).shape[0]
        for i in range(n):
            layers.append(_unstack(stacked, i))
    layers += list(np_params.get("tail", []))
    return {
        "embed": to_torch(np_params["embed"], device),
        "ln_f": to_torch(np_params["ln_f"], device),
        "layers": [{"ln1": to_torch(lp["ln1"], device),
                    "mixer": _mla_params(lp["mixer"], device),
                    "ln2": to_torch(lp["ln2"], device),
                    "mlp": _mlp_params(lp["mlp"], device)} for lp in layers],
    }


def mla_params_from_jax(np_mla: Any, device=None) -> MLAParams:
    """One layer's reference ``MLAParams`` (as numpy) -> the port's."""
    return _mla_params(np_mla, device)


def pool_from_jax(np_pool: Any, device=None) -> PagedMLAPool:
    """A reference ``PagedMLAPool`` (as numpy) -> the port's, byte for byte."""
    return PagedMLAPool(**{f: to_torch(_field(np_pool, f), device)
                           for f in PagedMLAPool._fields})


def cache_from_jax(np_cache: Any, device=None) -> MLACache:
    """A reference contiguous ``MLACache`` (as numpy), sink guard included,
    -> the port's, byte for byte."""
    return MLACache(**{f: to_torch(_field(np_cache, f), device)
                       for f in MLACache._fields})
