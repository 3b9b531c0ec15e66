"""The port's decode-attention backend registry (the counterpart of
``repro/kernels/mla_decode/backends.py``, which stays untouched).

Every backend computes one step of SnapMLA decode attention with one
signature, ``backend.decode(q: DecodeQuery, cache, cfg, ctx=None) ->
o_latent [B, (q_len,) H, d_c] f32`` (a rank-4 query is the speculative
verify block; ``ctx`` is the mesh context ``{"mesh", "dp"}``, read only by
``shard_map``), plus ``supports(cfg, mesh, batch, *, paged, n_heads, dp,
q_len) -> (ok, reason)``; ``resolve_backend`` is the single selection
rule, with the reference's ``auto`` / ``ref`` / ``kernel`` / ``shard-map``
vocabulary mapped by the cache layout:

  torch_ref            MLACache, the parallel (einsum) form
                       (``ref.snapmla_decode_parallel_any``) over the
                       sink-patched content
  torch_paged_ref      PagedMLAPool, page-table gather + the parallel form
  torch_pipeline       MLACache, the kernels' plain version (the pipeline
                       form, ``ops.snapmla_decode(..., use_kernel=False)``)
  torch_paged_pipeline PagedMLAPool, the same through the page table
  cuda_splitkv         MLACache, the hand-written Hopper kernels (single pass,
                       or split-KV + combine)
  cuda_paged_splitkv   PagedMLAPool, the same kernels through the page table
  shard_map            MLACache, the collective-free ``local_map`` region
                       over a (dp, model) mesh running the parallel form
                       (``core/distributed_decode.py``; one query token per
                       slot, needs a mesh and divisible batch and heads)

The reference backends decode as the reference's ``jnp_ref`` /
``jnp_paged_ref`` do (backends.py:194-218): the parallel form, which has no
AMLA, so ``rescale`` does nothing there. The pipeline backends run the
kernels' plain version on any device, FMA or AMLA: what a model run on the
kernels is held to on the card (the reference has no plain AMLA backend;
its AMLA model runs go through its Pallas kernels). Every
backend resolves its split plan with the batch, the layout and the rescale
(the profile's keys). The kernel backends refuse a mesh of more than one
rank (they run per device), and ``auto`` then falls back to the reference.

``token_cost`` / ``dispatch_cost`` are the reference's analytic traffic
model of one decode dispatch (backends.py:278-326), which the serving
engine's roofline counters read; the modeled time uses the H100's data-sheet
rates (3.35 TB/s, 989 TFLOP/s bf16) where the reference uses its TPU's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.kvcache import paged_gather, sink_patched_content
from repro_torch.kernels.mla_decode import ops as _ops
from repro_torch.kernels.mla_decode import ref as _ref
from repro_torch.launch.mesh import mesh_size


class DecodeQuery(NamedTuple):
    """Decode query, prepared (after Fused-Q-Quant / ``ref.prepare_q``) or
    raw (``DecodeQuery.raw``: float32 ``q_lat``, ``q_rope`` in the first two
    fields, ``sigma_q`` None; fp8 / int8 caches). The kernel backends hand a
    raw query to the kernels, which quantize it in their prologue (D folded);
    the reference backends prepare it with ``prepare_q`` first. Rank-3
    ``[B, H, .]`` is one token per slot, rank-4 ``[B, q_len, H, .]`` the
    speculative-verify block (the last q_len positions of each sequence,
    causally masked)."""

    q_c8: torch.Tensor     # [B, (q_len,) H, d_c] quantized content query (raw: q_lat f32)
    q_r: torch.Tensor      # [B, (q_len,) H, d_r] rope query, / sigma_q (raw: q_rope f32)
    sigma_q: torch.Tensor | None  # [B, (q_len,) H]; None for a raw query

    @classmethod
    def raw(cls, q_lat: torch.Tensor, q_rope: torch.Tensor) -> "DecodeQuery":
        return cls(q_lat, q_rope, None)

    @property
    def q_len(self) -> int:
        return self.q_c8.shape[1] if self.q_c8.dim() == 4 else 1


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Decode-attention parameters shared by every backend. ``num_splits``
    None/0 = the context-length heuristic; ``block_n`` is the contiguous
    cache's decode block (0 = the resolution rule's default; a paged pool's
    block is its page); ``rescale`` "fma" = the exact per-block FMA rescale,
    "amla" = the AMLA exponent-add path with combine-free split partials."""

    softmax_scale: float
    block_n: int = 128
    fmt: str = "fp8_e4m3"
    num_splits: int | None = None
    rescale: str = "fma"


def _split_plan(cfg: BackendConfig, capacity: int, batch: int, layout: str,
                page_size: int | None = None) -> _ops.SplitConfig:
    """The one place every backend resolves its (num_splits, block_n) plan."""
    return _ops.resolve_split_config(
        cfg.num_splits, cfg.block_n if layout == "contiguous" else None, capacity,
        batch=batch, layout=layout, page_size=page_size, rescale=cfg.rescale)


@dataclasses.dataclass(frozen=True)
class DecodeBackend:
    name: str
    layout: str    # "contiguous" | "paged" — the cache type consumed
    kind: str      # "ref" | "kernel" | "shard_map"
    decode: Callable[..., torch.Tensor]
    supports: Callable[..., tuple[bool, str]]


_REGISTRY: dict[str, DecodeBackend] = {}


def register(backend: DecodeBackend) -> DecodeBackend:
    if backend.name in _REGISTRY:
        raise ValueError(f"decode backend {backend.name!r} already registered")
    _REGISTRY[backend.name] = backend
    return backend


def get_backend(name: str) -> DecodeBackend:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown decode backend {name!r}; registered: "
                         f"{sorted(_REGISTRY)}") from None


def backend_names() -> list[str]:
    return sorted(_REGISTRY)


def _layout_ok(layout: str, paged: bool) -> tuple[bool, str]:
    if paged != (layout == "paged"):
        have = "PagedMLAPool" if paged else "MLACache"
        need = "a paged pool" if layout == "paged" else "a contiguous MLACache"
        return False, f"consumes {need}, cache is a {have}"
    return True, ""


def _supports_ref(layout: str):
    def supports(cfg=None, mesh=None, batch=None, *, paged=False, n_heads=None, dp=None,
                 q_len=None) -> tuple[bool, str]:
        return _layout_ok(layout, paged)
    return supports


def _supports_kernel(layout: str):
    def supports(cfg=None, mesh=None, batch=None, *, paged=False, n_heads=None, dp=None,
                 q_len=None) -> tuple[bool, str]:
        ok, why = _layout_ok(layout, paged)
        if not ok:
            return ok, why
        if mesh is not None and mesh_size(mesh) > 1:
            return False, ("the CUDA decode kernels run per device; under a "
                           f"{mesh_size(mesh)}-rank mesh use the torch_ref twin (or the "
                           "shard_map backend)")
        return True, ""
    return supports


def _supports_shard_map(cfg=None, mesh=None, batch=None, *, paged=False, n_heads=None,
                        dp=None, q_len=None) -> tuple[bool, str]:
    ok, why = _layout_ok("contiguous", paged)
    if not ok:
        return ok, why
    if q_len is not None and q_len > 1:
        return False, ("the shard_map region computes one query token per slot; "
                       f"q_len={q_len} verify blocks need the kernel or torch_ref backends")
    if mesh is None:
        return False, "requires a device mesh (SHARD_CTX)"
    from repro_torch.core.distributed_decode import shard_map_applicable
    if batch is None or n_heads is None:
        return False, "requires static batch and n_heads for divisibility"
    if not shard_map_applicable(mesh, dp, batch, n_heads):
        return False, (f"batch={batch} / n_heads={n_heads} do not divide the "
                       "(dp, model) mesh axes")
    return True, ""


def _prepared(q: DecodeQuery, fmt: str):
    """The prepared query (``prepare_q`` on a raw one)."""
    return _ops._query(q.q_c8, q.q_r, q.sigma_q, fmt, use_kernel=False)


def _torch_ref_decode(q: DecodeQuery, cache, cfg: BackendConfig, ctx=None) -> torch.Tensor:
    plan = _split_plan(cfg, cache.capacity, q.q_c8.shape[0], "contiguous")
    o, _lse = _ref.snapmla_decode_parallel_any(
        *_prepared(q, cfg.fmt), sink_patched_content(cache), cache.rope.float(), cache.scale,
        cache.seq_lens, softmax_scale=cfg.softmax_scale, num_splits=plan.num_splits,
        block_n=plan.block_n, fmt=cfg.fmt)
    return o


def _torch_paged_ref_decode(q: DecodeQuery, pool, cfg: BackendConfig,
                            ctx=None) -> torch.Tensor:
    plan = _split_plan(cfg, pool.capacity, q.q_c8.shape[0], "paged", page_size=pool.page_size)
    content, rope, scale = paged_gather(pool)
    o, _lse = _ref.snapmla_decode_parallel_any(
        *_prepared(q, cfg.fmt), content, rope.float(), scale, pool.seq_lens,
        softmax_scale=cfg.softmax_scale, num_splits=plan.num_splits, block_n=plan.block_n,
        fmt=cfg.fmt)
    return o


def _contiguous_decode(use_kernel: bool):
    def decode(q: DecodeQuery, cache, cfg: BackendConfig, ctx=None) -> torch.Tensor:
        plan = _split_plan(cfg, cache.capacity, q.q_c8.shape[0], "contiguous")
        o, _lse = _ops.snapmla_decode(
            q.q_c8, q.q_r, q.sigma_q, cache, softmax_scale=cfg.softmax_scale,
            block_n=plan.block_n, fmt=cfg.fmt, num_splits=plan.num_splits,
            use_kernel=use_kernel, rescale=cfg.rescale)
        return o
    return decode


def _paged_decode(use_kernel: bool):
    def decode(q: DecodeQuery, pool, cfg: BackendConfig, ctx=None) -> torch.Tensor:
        # the pool's page is its block: snapmla_decode_paged resolves the
        # split count (an unset one by the design the call takes)
        o, _lse = _ops.snapmla_decode_paged(
            q.q_c8, q.q_r, q.sigma_q, pool, softmax_scale=cfg.softmax_scale, fmt=cfg.fmt,
            num_splits=cfg.num_splits, use_kernel=use_kernel, rescale=cfg.rescale)
        return o
    return decode


def _shard_map_decode(q: DecodeQuery, cache, cfg: BackendConfig, ctx=None) -> torch.Tensor:
    """The region's o_latent, gathered outside it (``full_tensor``)."""
    if q.q_c8.dim() == 4:
        raise ValueError("shard_map backend does not take q_len > 1 verify blocks; resolve "
                         "with q_len to route elsewhere")
    if not ctx or ctx.get("mesh") is None:
        raise ValueError("shard_map backend needs ctx={'mesh': ..., 'dp': ...}")
    from repro_torch.core.distributed_decode import mla_decode_shard_map
    plan = _split_plan(cfg, cache.capacity, q.q_c8.shape[0], "contiguous")
    o = mla_decode_shard_map(ctx["mesh"], ctx.get("dp"), *_prepared(q, cfg.fmt), cache,
                             softmax_scale=cfg.softmax_scale, block_n=plan.block_n,
                             fmt=cfg.fmt, num_splits=plan.num_splits)
    return o.full_tensor()


register(DecodeBackend("torch_ref", "contiguous", "ref", _torch_ref_decode,
                       _supports_ref("contiguous")))
register(DecodeBackend("torch_paged_ref", "paged", "ref", _torch_paged_ref_decode,
                       _supports_ref("paged")))
register(DecodeBackend("torch_pipeline", "contiguous", "ref", _contiguous_decode(False),
                       _supports_ref("contiguous")))
register(DecodeBackend("torch_paged_pipeline", "paged", "ref", _paged_decode(False),
                       _supports_ref("paged")))
register(DecodeBackend("cuda_splitkv", "contiguous", "kernel", _contiguous_decode(True),
                       _supports_kernel("contiguous")))
register(DecodeBackend("cuda_paged_splitkv", "paged", "kernel", _paged_decode(True),
                       _supports_kernel("paged")))
register(DecodeBackend("shard_map", "contiguous", "shard_map", _shard_map_decode,
                       _supports_shard_map))


# the H100's data-sheet rates (SXM, dense): the analytic model's time only
_H100_HBM = 3.35e12       # bytes/s
_H100_BF16 = 989e12       # FLOP/s


def token_cost(fmt: str, d_c: int, d_r: int, heads: int) -> tuple[int, int]:
    """(bytes streamed, FLOPs) per cached token of one decode dispatch:
    quantized content + bf16 rope + f32 scale, QK + PV per head."""
    if fmt == "none":
        bytes_tok = (d_c + d_r) * 2
    else:
        bytes_tok = d_c * 1 + d_r * 2 + 4
    flops_tok = (2 * (d_c + d_r) + 2 * d_c) * heads
    return bytes_tok, flops_tok


def dispatch_cost(backend: "DecodeBackend | str", *, tokens_visited: int,
                  tokens_full: int, heads: int, d_c: int, d_r: int, fmt: str) -> dict:
    """Analytic bytes / FLOPs of ONE decode dispatch: kernel backends stream
    the visited tokens, the paged reference backend gathers the whole
    page-table span (``tokens_full``). ``achieved_fraction`` = compulsory
    bytes over modeled bytes."""
    b = get_backend(backend) if isinstance(backend, str) else backend
    bytes_tok, flops_tok = token_cost(fmt, d_c, d_r, heads)
    streamed = tokens_full if (b.kind == "ref" and b.layout == "paged") else tokens_visited
    streamed = max(streamed, tokens_visited)
    model_bytes = streamed * bytes_tok
    min_bytes = tokens_visited * bytes_tok
    flops = tokens_visited * flops_tok
    return {
        "backend": b.name,
        "bytes": model_bytes,
        "bytes_min": min_bytes,
        "flops": flops,
        "achieved_fraction": min_bytes / model_bytes if model_bytes else 1.0,
        "t_model_us": max(model_bytes / _H100_HBM, flops / _H100_BF16) * 1e6,
    }


def canonical_name(request: str, paged: bool) -> str:
    """Map 'ref' / 'kernel' / 'shard-map' (or an exact registry name) to a
    registry name for the cache layout."""
    if request == "ref":
        return "torch_paged_ref" if paged else "torch_ref"
    if request == "kernel":
        return "cuda_paged_splitkv" if paged else "cuda_splitkv"
    if request == "shard-map":
        return "shard_map"
    return request


def resolve_backend(request: str = "auto", *, paged: bool = False,
                    batch: int | None = None, n_heads: int | None = None,
                    mesh=None, dp=None, use_kernels: bool = False,
                    prefer_shard_map: bool = False, cfg: BackendConfig | None = None,
                    q_len: int | None = None) -> DecodeBackend:
    """Pick the decode backend (backends.py:341-377). "auto" prefers, in
    order: the shard_map region (when a mesh context asked for it and the
    shapes divide), the kernels (when ``use_kernels`` and no multi-rank mesh
    is in the way), else the reference; auto never fails. An explicit
    request whose ``supports`` rejects the configuration raises with the
    reason. ``q_len`` > 1 (the verify block) routes away from shard_map,
    which takes one query token per slot."""
    kw = dict(paged=paged, n_heads=n_heads, dp=dp, q_len=q_len)
    if request in (None, "", "auto"):
        if prefer_shard_map:
            sm = get_backend("shard_map")
            if sm.supports(cfg, mesh, batch, **kw)[0]:
                return sm
        if use_kernels:
            k = get_backend(canonical_name("kernel", paged))
            if k.supports(cfg, mesh, batch, **kw)[0]:
                return k
        return get_backend(canonical_name("ref", paged))
    backend = get_backend(canonical_name(request, paged))
    ok, why = backend.supports(cfg, mesh, batch, **kw)
    if not ok:
        raise ValueError(f"decode backend {backend.name!r} (requested "
                         f"{request!r}) unsupported here: {why}")
    return backend
