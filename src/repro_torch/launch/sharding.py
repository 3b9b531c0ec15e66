"""Sharding rules: parameter / optimizer / decode-state / batch specs, and
their DTensor placements (port of ``repro/launch/sharding.py``).

Policy, as in the reference: 2-D sharding — FSDP over the ('pod', 'data')
axes, tensor / expert parallelism over 'model'. Rules are keyed on
parameter *names* (the finite set the model modules emit). A spec ``P`` names,
for each tensor dimension, the mesh axis (or axes, major first) it is split
over, or None; ``sanitize_pspec`` drops an axis whose size does not divide
its dimension. KV-head axes smaller than the model axis are swapped for a
head-dim sharding where the policy says so.

The reference stacks each pattern slot's layers along a leading scanned
axis (and whisper's encoder along another) and prefixes those specs with
an unsharded dimension; the port's trees are lists of layers
(``bridge.params_from_jax``), so every leaf gets its rule's spec with no
prefix. The rules read only leaf shapes and the mesh's axis names and
sizes, so they run on ``meta`` tensors and on fake meshes.

``to_named`` binds each spec to a mesh as DTensor placements, one per mesh
dimension (``Shard(i)`` where tensor dimension i names that mesh axis,
``Replicate()`` elsewhere); ``place`` puts a tree of full tensors, the same
on every rank, onto the mesh by them without a collective.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.launch.mesh import axis_names, axis_sizes, data_axis_names, model_axis_size


class P(tuple):
    """Per-tensor-dimension spec: each entry a mesh axis name, a tuple of
    names (major first), or None (the counterpart of the reference's
    ``PartitionSpec``)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return "P(" + ", ".join(repr(p) for p in self) + ")"


def _rules(dp, model, model_size, attn_fallback="replicate"):
    """name -> function(shape) -> P (sharding.py:18-115).

    attn_fallback: what to do when a head count does not divide the model
    axis. "replicate" (train default): keep attention weights replicated
    over 'model'. "shard_dh" (decode default): shard the head dim."""
    def attn_qkv(shape):     # [d, H, dh]
        h = shape[-2]
        if h % model_size == 0:
            return P(dp, model, None)
        if attn_fallback == "shard_dh" and shape[-1] % model_size == 0:
            return P(dp, None, model)
        return P(dp, None, None)

    def attn_bias(shape):    # [H, dh]
        h = shape[-2]
        if h % model_size == 0:
            return P(model, None)
        if attn_fallback == "shard_dh" and shape[-1] % model_size == 0:
            return P(None, model)
        return P(None, None)

    def attn_wo(shape):      # [H, dh, d]
        h = shape[-3]
        if h % model_size == 0:
            return P(model, None, dp)
        if attn_fallback == "shard_dh" and shape[-2] % model_size == 0:
            return P(None, model, dp)
        return P(None, None, dp)

    def expert_in(s):        # dense [d, ff] or expert-stacked [E, d, ff]
        if len(s) == 3:
            return P(model, dp, None) if s[0] % model_size == 0 else P(None, dp, model)
        return P(dp, model)

    def expert_out(s):       # dense [ff, d] or expert-stacked [E, ff, d]
        if len(s) == 3:
            return P(model, None, dp) if s[0] % model_size == 0 else P(None, model, dp)
        return P(model, dp)

    def heads_or_none(s):    # w_uk / w_uv [d_c, H, dh]
        return P(None, model, None) if s[-2] % model_size == 0 else P(None, None, None)

    return {
        # embeddings
        "embed": lambda s: P(model, dp),
        "unembed": lambda s: P(model, dp),
        # attention
        "wq": attn_qkv, "wk": attn_qkv, "wv": attn_qkv,
        "bq": attn_bias, "bk": attn_bias, "bv": attn_bias,
        "wo": attn_wo,
        # dense MLP and MoE experts: EP on E when it divides, else TP on ff
        "w_gate": expert_in, "w_up": expert_in, "w_down": expert_out,
        "w_router": lambda s: P(dp, None),
        "shared_gate": lambda s: P(dp, model),
        "shared_up": lambda s: P(dp, model),
        "shared_down": lambda s: P(model, dp),
        # MLA
        "w_dq": lambda s: P(dp, None),
        "q_norm": lambda s: P(None),
        "w_uq": lambda s: P(dp, "model", None) if s[-2] % model_size == 0 else P(dp, None, None),
        "w_dkv": lambda s: P(dp, None),
        "kv_norm": lambda s: P(None),
        "w_kr": lambda s: P(dp, None),
        "w_uk": heads_or_none,
        "w_uv": heads_or_none,
        "w_o": attn_wo,
        # RG-LRU
        "w_gate_branch": lambda s: P(dp, model),
        "w_in": lambda s: P(dp, model),
        "conv_w": lambda s: P(None, model),
        "conv_b": lambda s: P(model),
        "w_a": lambda s: P(None, model),
        "b_a": lambda s: P(model),
        "w_x": lambda s: P(None, model),
        "b_x": lambda s: P(model),
        "log_lambda": lambda s: P(model),
        "w_out": lambda s: P(model, dp) if len(s) == 2 else P(None, model, dp),
        # xLSTM: w_q / w_k feed the dhk contraction, so they stay replicated
        # over 'model'; the value dim (dhv) is sharded instead
        "w_q": lambda s: P(dp, None, None),
        "w_k": lambda s: P(dp, None, None),
        "w_v": lambda s: P(dp, None, model),
        "w_i": lambda s: P(dp, None),
        "w_f": lambda s: P(dp, None),
        "b_i": lambda s: P(None),
        "b_f": lambda s: P(None),
        "w_o_gate": lambda s: P(dp, None, model),
        "gn_gain": lambda s: P(None, None),
        "w": lambda s: P(None, dp, None, model),       # slstm input proj [4,d,H,dh]
        "r": lambda s: P(None),                        # slstm recurrent (small)
        "b": lambda s: P(None),
        # norms / scalars
        "ln1": lambda s: P(None), "ln2": lambda s: P(None),
        "ln_cross": lambda s: P(None), "ln_f": lambda s: P(None),
        "enc_ln_f": lambda s: P(None), "xgate": lambda s: P(None),
    }


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    out = 1
    for a in data_axis_names(mesh):
        out *= sizes[a]
    return out


def dp_axes_for(batch_size: int, mesh):
    """Batch axes: ('pod', 'data') only when they divide the batch (a batch of
    one is replicated, the model axis still sharding heads)."""
    if batch_size % dp_size(mesh) != 0:
        return None
    dp = data_axis_names(mesh)
    return dp[0] if len(dp) == 1 else dp


def _axes_size(mesh, axes) -> int:
    if axes is None:
        return 1
    sizes = axis_sizes(mesh)
    if isinstance(axes, (tuple, list)):
        out = 1
        for a in axes:
            out *= sizes[a]
        return out
    return sizes[axes]


def sanitize_pspec(ps, shape, mesh) -> P:
    """Drop any axis whose mesh size does not divide its dimension (that
    dimension is then replicated; e.g. granite's 49155 vocab on a 16-way
    model axis)."""
    parts = list(ps) + [None] * (len(shape) - len(ps))
    return P(*(axes if axes is None or dim % _axes_size(mesh, axes) == 0 else None
               for dim, axes in zip(shape, parts)))


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn: Callable, tree: Any, leaf: type = torch.Tensor, path: tuple = ()) -> Any:
    """``fn(path, x)`` on every ``leaf``-typed node (a tensor by default) of
    nested dicts, lists, tuples and NamedTuples; ``path`` is the tuple of
    keys, field names and indices down to it. Other leaves (None, numbers)
    are kept."""
    if isinstance(tree, leaf):
        return fn(path, tree)
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, leaf, path + (k,)) for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, v, leaf, path + (k,))
                            for k, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, leaf, path + (i,)) for i, v in enumerate(tree))
    return tree


def _at(tree: Any, path: tuple) -> Any:
    """The node of ``tree`` at ``path`` (as ``map_with_path`` gives it)."""
    for k in path:
        tree = getattr(tree, k) if _is_namedtuple(tree) else tree[k]
    return tree


def _leaf_name(path) -> str:
    return path[-1] if path and isinstance(path[-1], str) else ""


def _fit(ps, shape, mesh) -> P:
    parts = list(ps)[: len(shape)]
    parts += [None] * (len(shape) - len(parts))
    return sanitize_pspec(P(*parts), shape, mesh)


def param_pspecs(params, mesh, weight_stationary: bool = False,
                 attn_fallback: str = "replicate"):
    """P tree for a model / optimizer parameter tree.

    ``weight_stationary`` replicates weights over the data axes and keeps
    only the 'model' (TP) sharding: the DP x TP serving layout. The default
    is the 2-D FSDP x TP training layout."""
    if weight_stationary:
        dp = None
    else:
        dp = data_axis_names(mesh)
        dp = dp[0] if len(dp) == 1 else dp
    rules = _rules(dp, "model", model_axis_size(mesh), attn_fallback)

    def spec(path, leaf):
        name, shape = _leaf_name(path), tuple(leaf.shape)
        ps = rules[name](shape) if name in rules and shape else P()
        return _fit(ps, shape, mesh)

    return map_with_path(spec, params)


def state_pspecs(state, mesh, cfg=None):
    """Decode-state specs: batch over dp; heads (or head dim) over model; the
    MLA latent replicated over model."""
    del cfg
    msize = model_axis_size(mesh)

    def spec(path, leaf):
        name, core = _leaf_name(path), tuple(leaf.shape)
        dp = dp_axes_for(core[0], mesh) if core else None
        if name in ("k", "v") and len(core) == 4:          # [B,N,Hkv,dh]
            ps = P(dp, None, "model", None) if core[2] % msize == 0 \
                else P(dp, None, None, "model")
        elif name in ("k_scale", "v_scale") and len(core) == 3:
            ps = P(dp, None, "model") if core[2] % msize == 0 else P(dp, None, None)
        elif name == "slot_pos":
            ps = P(dp, None)
        elif name == "seq_lens":
            ps = P(dp)
        elif name in ("content", "rope") and len(core) == 3:   # [B,N,d_c] / [B,N,d_r]
            ps = P(dp, None, None)
        elif name == "scale" and len(core) == 2:
            ps = P(dp, None)
        elif name == "h" and len(core) == 2:               # rglru [B, d_rnn]
            ps = P(dp, "model")
        elif name == "conv":                               # [B, W-1, d_rnn]
            ps = P(dp, None, "model")
        elif name == "c" and len(core) == 4:               # mlstm [B,H,dhk,dhv]
            ps = P(dp, "model", None, None) if core[1] % msize == 0 \
                else P(dp, None, "model", None)
        elif name in ("c", "n", "h") and len(core) == 3:   # [B,H,dh]
            ps = P(dp, None, "model")
        elif name == "m" and len(core) == 2:               # [B,H]
            ps = P(dp, None)
        elif core:
            ps = P(dp, *([None] * (len(core) - 1)))
        else:
            ps = P()
        return _fit(ps, core, mesh)

    return map_with_path(spec, state)


def batch_pspecs(batch, mesh):
    def spec(path, leaf):
        dp = dp_axes_for(leaf.shape[0], mesh) if leaf.dim() else None
        return P(dp, *([None] * (leaf.dim() - 1)))

    return map_with_path(spec, batch)


class NamedPlacements(NamedTuple):
    """A spec bound to a mesh: one DTensor placement per mesh dimension (the
    counterpart of the reference's ``NamedSharding``)."""

    mesh: Any
    placements: tuple
    spec: P


def placements_for(spec, mesh) -> tuple:
    """``spec`` as DTensor placements over ``mesh``'s dimensions: ``Shard(i)``
    on each mesh axis tensor dimension i names (a tuple of axes shards that
    dimension over each of them, major first, in mesh order), else
    ``Replicate()``. An axis of size 1 replicates (one rank holds the whole
    dimension either way, and DTensor then needs no rule to keep a sharding
    through a reshape)."""
    from torch.distributed.tensor import Replicate, Shard
    names = axis_names(mesh)
    sizes = axis_sizes(mesh)
    out = [Replicate()] * len(names)
    for dim, axes in enumerate(spec):
        if axes is None:
            continue
        group = axes if isinstance(axes, (tuple, list)) else (axes,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {group} must come in the mesh's order {names} "
                             "(major first)")
        for m in idx:
            if out[m] != Replicate():
                raise ValueError(f"{spec}: mesh axis {names[m]!r} shards two dimensions")
            out[m] = Shard(dim)
    return tuple(Replicate() if sizes[names[m]] == 1 else pl for m, pl in enumerate(out))


def to_named(pspecs, mesh):
    """Each ``P`` of the tree -> ``NamedPlacements`` over ``mesh``."""
    return map_with_path(lambda _, ps: NamedPlacements(mesh, placements_for(ps, mesh), ps),
                         pspecs, leaf=P)


def place(tree, named):
    """Every tensor leaf of ``tree`` as a DTensor with the ``NamedPlacements``
    at its path in ``named``. Each rank holds the same full tensor, so each
    takes its own shard: no broadcast, no collective (``src_data_rank=None``)."""
    from torch.distributed.tensor import distribute_tensor

    def one(path, t):
        n = _at(named, path)
        return distribute_tensor(t, n.mesh, n.placements, src_data_rank=None)
    return map_with_path(one, tree)
