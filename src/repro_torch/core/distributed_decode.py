"""The collective-free distributed decode region (port of
``repro/core/distributed_decode.py``).

The attention of one decode step runs as a ``local_map`` region over a
``("data", "model")`` (or ``("pod", "data", "model")``) mesh with

    q     (batch over dp, heads over model)        P(dp, 'model', None)
    cache (batch over dp, replicated over model)   P(dp, None, None)
    out   (batch over dp, heads over model)        P(dp, 'model', None)

Each rank attends its batch shard x its head shard against its whole local
cache shard, so the region issues no collective. The parallel (einsum)
form ``ref.snapmla_decode_parallel_any`` runs inside, as the reference runs
its oracle there; ``num_splits > 1`` splits the rank-local KV axis. The
P-Cast sink substitution happens outside the region.

Eager PyTorch has no GSPMD around the region: every rank runs the rest of
the step replicated, on full tensors. The region takes each rank's shard of
them as a view (``_shard``: no copy, no collective) and returns DTensors;
the caller gathers (``DTensor.full_tensor()``) outside the region. The
append writes in place into the rank's own rows of the full cache (the
port's ``mla_append`` writes in place), so a rank's copy is current on the
rows of its dp shard, the only rows its region reads; the reference's
sharded state holds only those rows.

Needs B % dp == 0 and H % model == 0 (``shard_map_applicable``).
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch.core.kvcache import MLACache, mla_append, sink_patched_content
from repro_torch.kernels.mla_decode import ref as mla_ref
from repro_torch.launch.mesh import axis_sizes
from repro_torch.launch.sharding import P, placements_for


def shard_map_applicable(mesh, dp_axes, batch: int, n_heads: int) -> bool:
    sizes = axis_sizes(mesh)
    if dp_axes is None:
        dp_size = 1
    else:
        axes = dp_axes if isinstance(dp_axes, tuple) else (dp_axes,)
        dp_size = 1
        for a in axes:
            dp_size *= sizes[a]
    return (batch % dp_size == 0) and (n_heads % sizes["model"] == 0)


def _shard(t: torch.Tensor, mesh, placements):
    """``t`` (the same full tensor on every rank) as a DTensor whose local
    tensor is this rank's shard, a view of ``t``: no copy, no collective.
    Mesh dimensions sharding one tensor dimension split it major first. A
    DTensor (the dry run's sharded step) is redistributed to ``placements``
    instead, before the region."""
    from torch.distributed.tensor import DTensor, Shard
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == tuple(placements) else \
            t.redistribute(mesh, placements)
    coord = mesh.get_coordinate()
    local = t
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard):
            n = mesh.size(m)
            size = local.shape[pl.dim]
            if size % n:
                raise ValueError(f"dimension {pl.dim} of {tuple(t.shape)} does not divide "
                                 f"over {n} ranks")
            local = local.narrow(pl.dim, coord[m] * (size // n), size // n)
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


# entered around every region body: the dry run passes its collective
# counter's scope here, to count what a region issues (nothing)
_REGION_SCOPE = contextlib.nullcontext


@contextlib.contextmanager
def region_scope(scope):
    """Enter ``scope()`` around every region body while this is open."""
    global _REGION_SCOPE
    prev, _REGION_SCOPE = _REGION_SCOPE, scope
    try:
        yield
    finally:
        _REGION_SCOPE = prev


def _region(fn, mesh, specs, out_specs):
    """``fn`` as a ``local_map`` region: (tensors) -> DTensors, each placed
    by its spec."""
    from torch.distributed.tensor.experimental import local_map
    ins = tuple(placements_for(s, mesh) for s in specs)
    outs = tuple(placements_for(s, mesh) for s in out_specs)

    def body(*local):
        with _REGION_SCOPE():
            return fn(*local)
    mapped = local_map(body, out_placements=outs, in_placements=ins, device_mesh=mesh)

    def run(*tensors):
        return mapped(*(_shard(t, mesh, pl) for t, pl in zip(tensors, ins)))
    return run


def mla_decode_shard_map(mesh, dp_axes, q_c8: torch.Tensor, q_r: torch.Tensor,
                         sigma_q: torch.Tensor, cache: MLACache, *, softmax_scale: float,
                         block_n: int, fmt: str, num_splits: int = 1):
    """o_latent [B, H, d_c] f32 as a DTensor placed P(dp, 'model', None); the
    region issues no collective. q_c8 [B, H, d_c], q_r [B, H, d_r], sigma_q
    [B, H]."""
    dpa = dp_axes

    def local_attn(q_c8, q_r, sq, content, rope, scale, seq_lens):
        o, _lse = mla_ref.snapmla_decode_parallel_any(
            q_c8, q_r.float(), sq, content, rope.float(), scale, seq_lens,
            softmax_scale=softmax_scale, num_splits=num_splits, block_n=block_n, fmt=fmt)
        return (o,)

    f = _region(local_attn, mesh,
                (P(dpa, "model", None), P(dpa, "model", None), P(dpa, "model"),
                 P(dpa, None, None), P(dpa, None, None), P(dpa, None), P(dpa)),
                (P(dpa, "model", None),))
    # the sink substitution, outside the region (batch-major, elementwise)
    return f(q_c8, q_r, sigma_q, sink_patched_content(cache), cache.rope, cache.scale,
             cache.seq_lens)[0]


def mla_append_shard_map(mesh, dp_axes, cache: MLACache, cache_cfg, c_kv: torch.Tensor,
                         k_r: torch.Tensor, active: torch.Tensor | None = None) -> MLACache:
    """The collective-free quantized cache append: each rank appends its batch
    shard's rows into its own rows of the cache, in place. Returns the
    cache as DTensors placed batch-major (the sink shadow too, when armed).

    ``active`` [B] bool gates the append per row as in ``mla_append``; it is
    a batch-dim mask, so it shards over dp with the cache."""
    dpa = dp_axes
    specs = [P(dpa, None, None), P(dpa, None, None), P(dpa, None), P(dpa)]
    leaves = [cache.content, cache.rope, cache.scale, cache.seq_lens]
    if cache.sink is not None:
        specs.append(P(dpa, None, None))
        leaves.append(cache.sink)
    n = len(leaves)

    def local_append(*args):
        local = MLACache(*args[:4], sink=args[4] if n == 5 else None)
        out = mla_append(local, cache_cfg, args[n], args[n + 1],
                         active=args[n + 2] if active is not None else None)
        return tuple(out[:n])

    ins = specs + [P(dpa, None), P(dpa, None)] + ([P(dpa)] if active is not None else [])
    args = leaves + [c_kv, k_r] + ([active] if active is not None else [])
    out = _region(local_append, mesh, ins, specs)(*args)
    return MLACache(*out[:4], sink=out[4] if n == 5 else None)


def appended(cache: MLACache, sharded: MLACache) -> MLACache:
    """The full cache after ``mla_append_shard_map``: its content, rope,
    scale and sink took the rank's rows in place, so only the new
    ``seq_lens`` is gathered (outside the region)."""
    return cache._replace(seq_lens=sharded.seq_lens.full_tensor())
