"""The port's decode-attention backend registry (the counterpart of
``repro/kernels/mla_decode/backends.py``, which stays untouched).

Every backend computes one step of SnapMLA decode attention with one
signature, ``backend.decode(q: DecodeQuery, cache, cfg) -> o_latent
[B, H, d_c] f32``, and ``resolve_backend`` is the single selection rule,
with the reference's ``auto`` / ``ref`` / ``kernel`` vocabulary mapped by the
cache layout:

  torch_ref            MLACache, the plain PyTorch pipeline (ref.py) over the
                       sink-patched content
  torch_paged_ref      PagedMLAPool, page-table gather + the plain PyTorch
                       split-KV pipeline
  cuda_splitkv         MLACache, the hand-written Hopper kernels (single pass,
                       or split-KV + combine)
  cuda_paged_splitkv   PagedMLAPool, the same kernels through the page table

The reference's ``jnp_ref`` / ``jnp_paged_ref`` are the parallel (einsum)
form; the port's reference backends are the pipeline form (the kernels'
plain version) and honour ``rescale``. The shard_map region is not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.mla_decode import ops as _ops


class DecodeQuery(NamedTuple):
    """Prepared decode query (after Fused-Q-Quant / ``ref.prepare_q``)."""

    q_c8: torch.Tensor     # [B, H, d_c] quantized content query
    q_r: torch.Tensor      # [B, H, d_r] rope query, / sigma_q
    sigma_q: torch.Tensor  # [B, H]


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


def _split_plan(cfg: BackendConfig, capacity: int, layout: str,
                page_size: int | None = None) -> _ops.SplitConfig:
    """The one place every backend resolves its (num_splits, block_n) plan."""
    return _ops.resolve_split_config(
        cfg.num_splits, cfg.block_n if layout == "contiguous" else None, capacity,
        layout=layout, page_size=page_size)


@dataclasses.dataclass(frozen=True)
class DecodeBackend:
    name: str
    layout: str    # "contiguous" | "paged" — the cache type consumed
    kind: str      # "ref" | "kernel"
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


def _supports(layout: str):
    def supports(paged: bool = False) -> tuple[bool, str]:
        if paged != (layout == "paged"):
            have = "PagedMLAPool" if paged else "MLACache"
            need = "a paged pool" if layout == "paged" else "a contiguous MLACache"
            return False, f"consumes {need}, cache is a {have}"
        return True, ""
    return supports


def _contiguous_decode(use_kernel: bool):
    def decode(q: DecodeQuery, cache, cfg: BackendConfig) -> torch.Tensor:
        plan = _split_plan(cfg, cache.capacity, "contiguous")
        o, _lse = _ops.snapmla_decode(
            q.q_c8, q.q_r, q.sigma_q, cache, softmax_scale=cfg.softmax_scale,
            block_n=plan.block_n, fmt=cfg.fmt, num_splits=plan.num_splits,
            use_kernel=use_kernel, rescale=cfg.rescale)
        return o
    return decode


def _paged_decode(use_kernel: bool):
    def decode(q: DecodeQuery, pool, cfg: BackendConfig) -> torch.Tensor:
        plan = _split_plan(cfg, pool.capacity, "paged", page_size=pool.page_size)
        o, _lse = _ops.snapmla_decode_paged(
            q.q_c8, q.q_r, q.sigma_q, pool, softmax_scale=cfg.softmax_scale,
            fmt=cfg.fmt, num_splits=plan.num_splits, use_kernel=use_kernel,
            rescale=cfg.rescale)
        return o
    return decode


register(DecodeBackend("torch_ref", "contiguous", "ref", _contiguous_decode(False),
                       _supports("contiguous")))
register(DecodeBackend("torch_paged_ref", "paged", "ref", _paged_decode(False),
                       _supports("paged")))
register(DecodeBackend("cuda_splitkv", "contiguous", "kernel", _contiguous_decode(True),
                       _supports("contiguous")))
register(DecodeBackend("cuda_paged_splitkv", "paged", "kernel", _paged_decode(True),
                       _supports("paged")))


def canonical_name(request: str, paged: bool) -> str:
    """Map 'ref' / 'kernel' (or an exact registry name) to a registry name
    for the cache layout."""
    if request == "ref":
        return "torch_paged_ref" if paged else "torch_ref"
    if request == "kernel":
        return "cuda_paged_splitkv" if paged else "cuda_splitkv"
    return request


def resolve_backend(request: str = "auto", *, paged: bool = False,
                    use_kernels: bool = False) -> DecodeBackend:
    """Pick the decode backend. "auto" takes the kernels when ``use_kernels``
    else the reference; an explicit request whose ``supports`` rejects the
    configuration raises with the reason."""
    if request in (None, "", "auto"):
        request = "kernel" if use_kernels else "ref"
    backend = get_backend(canonical_name(request, paged))
    ok, why = backend.supports(paged=paged)
    if not ok:
        raise ValueError(f"decode backend {backend.name!r} (requested "
                         f"{request!r}) unsupported here: {why}")
    return backend
