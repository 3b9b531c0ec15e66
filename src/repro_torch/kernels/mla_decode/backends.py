"""The port's decode-attention backend registry (the counterpart of
``repro/kernels/mla_decode/backends.py``, which stays untouched).

Every backend computes one step of SnapMLA decode attention with one
signature, ``backend.decode(q: DecodeQuery, cache, cfg) -> o_latent
[B, (q_len,) H, d_c] f32`` (a rank-4 query is the speculative verify
block), and ``resolve_backend`` is the single selection rule,
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

``token_cost`` / ``dispatch_cost`` are the reference's analytic traffic
model of one decode dispatch (backends.py:278-326), which the serving
engine's roofline counters read; the modeled time uses the H100's data-sheet
rates (3.35 TB/s, 989 TFLOP/s bf16) where the reference uses its TPU's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.kernels.mla_decode import ops as _ops


class DecodeQuery(NamedTuple):
    """Prepared decode query (after Fused-Q-Quant / ``ref.prepare_q``):
    rank-3 ``[B, H, .]`` is one token per slot, rank-4 ``[B, q_len, H, .]``
    the speculative-verify block (the last q_len positions of each
    sequence, causally masked)."""

    q_c8: torch.Tensor     # [B, (q_len,) H, d_c] quantized content query
    q_r: torch.Tensor      # [B, (q_len,) H, d_r] rope query, / sigma_q
    sigma_q: torch.Tensor  # [B, (q_len,) H]

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
    """Map 'ref' / 'kernel' (or an exact registry name) to a registry name
    for the cache layout."""
    if request == "ref":
        return "torch_paged_ref" if paged else "torch_ref"
    if request == "kernel":
        return "cuda_paged_splitkv" if paged else "cuda_splitkv"
    return request


def resolve_backend(request: str = "auto", *, paged: bool = False,
                    use_kernels: bool = False, q_len: int | None = None) -> DecodeBackend:
    """Pick the decode backend. "auto" takes the kernels when ``use_kernels``
    else the reference; an explicit request whose ``supports`` rejects the
    configuration raises with the reason. ``q_len`` (the verify block) is
    accepted by every registered backend: the reference's only q_len = 1
    backend, shard_map, is not ported."""
    del q_len
    if request in (None, "", "auto"):
        request = "kernel" if use_kernels else "ref"
    backend = get_backend(canonical_name(request, paged))
    ok, why = backend.supports(paged=paged)
    if not ok:
        raise ValueError(f"decode backend {backend.name!r} (requested "
                         f"{request!r}) unsupported here: {why}")
    return backend
