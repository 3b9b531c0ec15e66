"""The ops DTensor cannot shard, and how they run on DTensors.

The model's code runs unchanged on plain tensors and on DTensors (the
multi-device train loop, the dry run): DTensor's sharding propagation picks
each op's output placement and inserts the collectives. Some ops it cannot
shard for the placements they meet, and each such call site goes through
one helper here, which redistributes explicitly:

* ``replicated`` / ``index_put``: every DTensor input gathered whole
  (``Replicate`` on all mesh dimensions), the op run on plain tensors, an
  in-place write put back into the destination's own placements (an
  indexed write into a batch-sharded cache, the MoE sort dispatch and
  combine, the sLSTM block, ``logsigmoid``, whose backward has no rule);
* ``gather_rows``: an embedding lookup, the table gathered whole, each rank
  looking up its own shard of the indices;
* ``unsharded`` / ``whole_grad``: the dimensions a reshape splits or merges
  made whole, in the forward and in the backward pass;
* ``local_scan``: a recurrence along time run on each rank's shard;
* ``einsum`` / ``local_einsum``: a contraction run on the local shards,
  with no view rule involved.

The collectives this costs are DTensor's own, so a collective counter sees
them; ``REPLICATED`` counts every redistributing call by its site's name,
so they can be traced to it. On plain tensors each helper is the op itself:
no copy, no check beyond a type test.
"""
from __future__ import annotations

import collections
from typing import Any, Callable

import torch

# site name -> calls that met a DTensor (cleared by the caller that reads it)
REPLICATED: collections.Counter = collections.Counter()


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


def has_dtensor(xs) -> bool:
    """Whether any item of ``xs`` (or of a tuple / list in it) is a DTensor."""
    for x in xs:
        if isinstance(x, (tuple, list)):
            if has_dtensor(x):
                return True
        elif isinstance(x, torch.Tensor) and type(x).__name__ == "DTensor":
            return True
    return False


def _mesh_of(xs):
    DT = _dtensor_type()
    for x in xs:
        if isinstance(x, (tuple, list)):
            m = _mesh_of(x)
            if m is not None:
                return m
        elif isinstance(x, DT):
            return x.device_mesh
    return None


def _remap(xs, fn):
    """A tuple / list / NamedTuple with ``fn`` applied to each item."""
    items = [fn(v) for v in xs]
    return type(xs)(*items) if hasattr(xs, "_fields") else type(xs)(items)


def _rep(mesh) -> list:
    from torch.distributed.tensor import Replicate
    return [Replicate()] * mesh.ndim


def _local_full(x, mesh):
    """The whole of ``x`` on this rank, as a plain tensor: a DTensor
    all-gathered to ``Replicate`` on every mesh dimension first (nothing to
    gather when it is replicated already; its local tensor is then ``x``'s
    own storage). Tuples / lists map; other objects pass."""
    if isinstance(x, (tuple, list)):
        return _remap(x, lambda v: _local_full(v, mesh))
    if isinstance(x, _dtensor_type()):
        return x.redistribute(mesh, _rep(mesh)).to_local()
    return x


def _wrap(x, mesh):
    """Plain tensors (the same on every rank) -> replicated DTensors."""
    if isinstance(x, (tuple, list)):
        return _remap(x, lambda v: _wrap(v, mesh))
    if isinstance(x, torch.Tensor):
        return _dtensor_type().from_local(x, mesh, _rep(mesh), run_check=False)
    return x


def replicated(name: str, fn: Callable[..., Any], *args: Any) -> Any:
    """``fn(*args)``. Where an argument (or a tensor in a tuple / list
    argument) is a DTensor, every DTensor argument is gathered whole, ``fn``
    runs on plain tensors, and each tensor it returns comes back as a
    replicated DTensor."""
    if not has_dtensor(args):
        return fn(*args)
    REPLICATED[name] += 1
    mesh = _mesh_of(args)
    return _wrap(fn(*(_local_full(a, mesh) for a in args)), mesh)


def index_put(name: str, dst: torch.Tensor, index: tuple, value: torch.Tensor) -> torch.Tensor:
    """``dst[index] = value`` in place (``index`` a tuple of tensors and
    slices); returns ``dst``. On a DTensor ``dst`` the write runs on its
    gathered whole, which then goes back into ``dst``'s own placements (a
    local slice: no collective)."""
    if not has_dtensor((dst, index, value)):
        dst[index] = value
        return dst
    REPLICATED[name] += 1
    mesh = dst.device_mesh
    full = _local_full(dst, mesh)
    full[_local_full(index, mesh)] = _local_full(value, mesh)
    if list(dst.placements) != _rep(mesh):
        dst.copy_(_wrap(full, mesh).redistribute(mesh, dst.placements))
    return dst


def unsharded(name: str, x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` with tensor dimensions ``dims`` whole on every rank: each mesh
    dimension of a DTensor that shards one of them is gathered
    (``Replicate``), the others keep their placements. For a reshape that
    splits or merges a dimension whose sharding the new shape cannot keep.
    A plain tensor, or a DTensor that shards none of ``dims``, passes
    unchanged (and is not counted)."""
    if not isinstance(x, torch.Tensor) or type(x).__name__ != "DTensor":
        return x
    new = _unshard_dims(x, dims)
    if new == list(x.placements):
        return x
    REPLICATED[name] += 1
    return x.redistribute(x.device_mesh, new)


def gather_rows(name: str, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (an embedding lookup). On DTensors the table is
    gathered whole and each rank looks up its own shard of ``idx``: the
    result takes ``idx``'s placements (a batch-sharded lookup stays batch
    sharded). Its gradient reaches the table as a partial sum over the mesh
    dimensions that shard ``idx``."""
    if not has_dtensor((table, idx)):
        return table[idx]
    from torch.distributed.tensor import DTensor, Partial, Replicate
    REPLICATED[name] += 1
    mesh = _mesh_of((table, idx))
    idx_pl = list(idx.placements) if isinstance(idx, DTensor) else _rep(mesh)
    if isinstance(table, DTensor):
        grad_pl = [Replicate() if p == Replicate() else Partial() for p in idx_pl]
        full = table.redistribute(mesh, _rep(mesh)).to_local(grad_placements=grad_pl)
    else:
        full = table
    local = full[idx.to_local() if isinstance(idx, DTensor) else idx]
    shape = tuple(idx.shape) + tuple(table.shape[1:])
    return DTensor.from_local(local, mesh, idx_pl, run_check=False, shape=torch.Size(shape),
                              stride=_stride_like(local, shape))


def _unshard_dims(x, dims):
    from torch.distributed.tensor import Replicate, Shard
    want = {d % x.ndim for d in dims}
    return [Replicate() if isinstance(p, Shard) and p.dim in want else p for p in x.placements]


class _WholeGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name, dims):
        ctx.name, ctx.dims = name, dims
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return unsharded(ctx.name, g, *ctx.dims), None, None


def whole_grad(name: str, x: torch.Tensor, *dims: int) -> torch.Tensor:
    """``x`` unchanged; its gradient made whole on ``dims`` (as
    ``unsharded`` does) before it flows back. Put after a reshape whose
    backward merges or splits ``dims`` of the gradient. A plain tensor, or
    one that needs no gradient, passes unchanged."""
    if type(x).__name__ != "DTensor" or not x.requires_grad:
        return x
    return _WholeGrad.apply(x, name, dims)


def local_scan(name: str, fn: Callable[..., Any], *xs: torch.Tensor):
    """``fn(*xs)`` for an ``fn`` that runs a recurrence along dimension 1
    (time) and is elementwise in every other dimension (every ``xs`` and
    every output of one shape). On DTensors each rank runs ``fn`` on its own
    shard: the inputs take the first one's placements with time whole, and the
    outputs come back in them. A step of the recurrence then costs no
    DTensor dispatch. ``None`` items pass through."""
    ts = [x for x in xs if x is not None]
    if not has_dtensor(ts):
        return fn(*xs)
    REPLICATED[name] += 1
    mesh = _mesh_of(ts)
    first = next(x for x in ts if isinstance(x, _dtensor_type()))
    pl = _unshard_dims(first, (1,))

    def local(x):
        if x is None:
            return None
        if not isinstance(x, _dtensor_type()):
            x = _wrap(x, mesh)
        return x.redistribute(mesh, pl).to_local()

    out = fn(*(local(x) for x in xs))
    DT = _dtensor_type()

    def back(y):
        return DT.from_local(y, mesh, pl, run_check=False, shape=first.shape,
                             stride=first.stride())
    return _remap(out, back) if isinstance(out, (tuple, list)) else back(out)


def _expand_ellipsis(eq: str, ops) -> tuple[list[str], str]:
    """``eq``'s operand terms and output with every ``...`` spelled out in
    letters the equation does not use (right-aligned across operands)."""
    lhs, out = eq.replace(" ", "").split("->")
    terms = lhs.split(",")
    free = [c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq]
    n = max((op.ndim - (len(t) - 3) for t, op in zip(terms, ops) if "..." in t), default=0)
    ell = "".join(free[:n])
    terms = [t.replace("...", ell[n - (op.ndim - (len(t) - 3)):]) if "..." in t else t
             for t, op in zip(terms, ops)]
    return terms, out.replace("...", ell)


def local_einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, *ops)`` on DTensors, run on each rank's shards.

    For each mesh dimension one index letter is chosen to stay sharded: the
    one the largest operand shards there (operands sharding another letter
    on it are gathered there). Every operand holding that letter takes its
    shard of it (a local slice when it was replicated), the others stay
    whole, and each rank contracts its local tensors: the output is
    sharded on that letter, or a partial sum over the mesh dimension when
    the letter is contracted. Each operand's gradient comes back as a
    partial sum over the mesh dimensions whose letter it does not hold.
    No view rule is involved, so no sharding has to survive a reshape (one
    that DTensor's einsum decomposition would need). Operands all
    replicated run the plain einsum on the DTensors."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = _mesh_of(ops)
    if all(not isinstance(o, DTensor) or list(o.placements) == _rep(mesh) for o in ops):
        return torch.einsum(eq, *ops)     # all replicated (a mesh of one): nothing to keep
    terms, out = _expand_ellipsis(eq, ops)
    ops = [o if isinstance(o, DTensor) else _wrap(o, mesh) for o in ops]
    ops = [o if not any(p.is_partial() for p in o.placements) else
           o.redistribute(mesh, [Replicate() if p.is_partial() else p for p in o.placements])
           for o in ops]
    size = {}
    for t, o in zip(terms, ops):
        for c, n in zip(t, o.shape):
            size[c] = max(size.get(c, 1), n)
    chosen = []
    for m in range(mesh.ndim):
        weight: dict = {}
        for t, o in zip(terms, ops):
            p = o.placements[m]
            if isinstance(p, Shard):
                c = t[p.dim]
                weight[c] = weight.get(c, 0) + o.numel() * o.element_size()
        chosen.append(max(weight, key=weight.get) if weight else None)
    locals_ = []
    for t, o in zip(terms, ops):
        want = [Shard(t.index(c)) if c is not None and c in t else Replicate() for c in chosen]
        if list(o.placements) != want:
            o = o.redistribute(mesh, want)
        grad = [Partial() if c is not None and c not in t else p for c, p in zip(chosen, want)]
        locals_.append(o.to_local(grad_placements=grad))
    y = torch.einsum(",".join(terms) + "->" + out, *locals_)
    placements = [Replicate() if c is None else Shard(out.index(c)) if c in out else Partial()
                  for c in chosen]
    shape = torch.Size(size[c] for c in out)
    return DTensor.from_local(y, mesh, placements, run_check=False, shape=shape,
                              stride=_stride_like(y, shape))


def _stride_like(local: torch.Tensor, shape) -> tuple:
    """The strides of a dense tensor of ``shape`` whose dimensions are laid
    out in the order of ``local``'s (an einsum's output may be permuted)."""
    order = sorted(range(local.ndim), key=lambda d: local.stride(d), reverse=True)
    stride, acc = [0] * local.ndim, 1
    for d in reversed(order):
        stride[d] = acc
        acc *= shape[d]
    return tuple(stride)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``torch.einsum``; with a DTensor operand, ``local_einsum``."""
    return local_einsum(eq, *ops) if has_dtensor(ops) else torch.einsum(eq, *ops)
