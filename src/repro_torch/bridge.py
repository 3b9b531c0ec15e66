"""Carry the JAX package's parameters, AdamW state and caches (GQA, MLA
contiguous and paged), handed over as numpy, into the port's structures.

Input is the tree ``jax.tree.map(np.asarray, tree)`` gives: nested dicts,
lists and NamedTuples of numpy arrays. Fields are read by name; nothing of
``jax`` or ``repro`` is imported. fp8 (``ml_dtypes.float8_e4m3fn``) and bf16
arrays cross bit for bit, through their raw bytes.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.kvcache import GQACache, MLACache, PagedMLAPool
from repro_torch.core.mla import MLAParams
from repro_torch.models.layers import AttnParams, MLPParams
from repro_torch.models.moe import MoEParams
from repro_torch.models.rglru import RGLRUParams
from repro_torch.models.xlstm import MLSTMParams, SLSTMParams
from repro_torch.optim.adamw import AdamWState

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


_MIXERS = (AttnParams, MLAParams, RGLRUParams, MLSTMParams, SLSTMParams)


def _mixer_params(m: Any, device):
    """A layer's mixer, told apart by its field names: ``AttnParams``
    (``attn`` / ``swa``), ``MLAParams``, ``RGLRUParams``, ``MLSTMParams``
    or ``SLSTMParams``."""
    names = set(_fields(m))
    kind = next(k for k in _MIXERS if set(k._fields) == names)
    return kind(**{f: to_torch(_field(m, f), device) for f in kind._fields})


def _fields(m: Any):
    return m.keys() if isinstance(m, dict) else getattr(m, "_fields", ())


def _mlp_params(m: Any, device) -> MLPParams | MoEParams:
    """A dense MLP (``MLPParams``) or a MoE layer (``MoEParams``, which has
    ``w_router``; shared experts None unless the config has them)."""
    kind = MoEParams if "w_router" in _fields(m) else MLPParams
    return kind(**{f: to_torch(_field(m, f), device) for f in kind._fields})


def _layer_params(lp: dict, device) -> dict[str, Any]:
    out = {"ln1": to_torch(lp["ln1"], device), "mixer": _mixer_params(lp["mixer"], device)}
    if "xgate" in lp:                                   # 'cross'
        out["xgate"] = to_torch(lp["xgate"], device)
    if "cross" in lp:                                   # 'dec'
        out.update(ln_cross=to_torch(lp["ln_cross"], device),
                   cross=_mixer_params(lp["cross"], device))
    if "mlp" in lp:
        out.update(ln2=to_torch(lp["ln2"], device), mlp=_mlp_params(lp["mlp"], device))
    return out


def params_from_jax(np_params: dict, device=None) -> dict[str, Any]:
    """The reference ``init_model`` tree (transformer.py:112-145) of any
    model (layers ``attn``, ``swa``, ``mla`` with q-LoRA, ``cross``,
    ``dec``, ``rglru``, ``mlstm``, ``slstm``; a dense or MoE MLP or none;
    whisper's encoder) -> the port's ``{"embed", "ln_f", ("unembed",)
    "layers": [...], ("encoder": [...], "enc_ln_f")}``. ``scanned`` holds
    one entry per pattern slot, each stacked over the superblocks; the port's
    list interleaves them in layer order (superblock i, slot j is layer
    ``i * pattern_len + j``), then appends the ``tail`` (the remainder). The
    encoder's layers, stacked along their leading axis, become a list. Also
    converts any tree of the same structure, such as AdamW's moments."""
    scanned = np_params.get("scanned") or []
    layers = []
    if scanned:
        n = np.asarray(scanned[0]["ln1"]).shape[0]
        for i in range(n):
            layers += [_unstack(slot, i) for slot in scanned]
    layers += list(np_params.get("tail", []))
    out = {
        "embed": to_torch(np_params["embed"], device),
        "ln_f": to_torch(np_params["ln_f"], device),
        "layers": [_layer_params(lp, device) for lp in layers],
    }
    if "unembed" in np_params:
        out["unembed"] = to_torch(np_params["unembed"], device)
    if "encoder" in np_params:
        enc = np_params["encoder"]
        out["encoder"] = [_layer_params(_unstack(enc, i), device)
                          for i in range(np.asarray(enc["ln1"]).shape[0])]
        out["enc_ln_f"] = to_torch(np_params["enc_ln_f"], device)
    return out


def opt_state_from_jax(np_opt: Any, device=None):
    """The reference's ``AdamWState`` (adamw.py:25-28: ``step``, ``mu``,
    ``nu``, each moment a tree like the parameters), as numpy -> the port's
    ``optim.adamw.AdamWState``."""
    return AdamWState(step=to_torch(_field(np_opt, "step"), device),
                      mu=params_from_jax(_field(np_opt, "mu"), device),
                      nu=params_from_jax(_field(np_opt, "nu"), device))


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


def gqa_cache_from_jax(np_cache: Any, device=None) -> GQACache:
    """A reference ``GQACache`` (as numpy) -> the port's, byte for byte."""
    return GQACache(**{f: to_torch(_field(np_cache, f), device) for f in GQACache._fields})
