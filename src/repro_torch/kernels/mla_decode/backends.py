"""The port's decode-attention backend registry (the counterpart of
``repro/kernels/mla_decode/backends.py``, which stays untouched).

Every backend computes one step of SnapMLA decode attention with one
signature, ``backend.decode(q: DecodeQuery, cache, cfg) -> o_latent
[B, H, d_c] f32``, and ``resolve_backend`` is the single selection rule,
with the reference's ``auto`` / ``ref`` / ``kernel`` vocabulary:

  torch_paged_ref      PagedMLAPool, page-table gather + the plain PyTorch
                       split-KV pipeline (ref.py)
  cuda_paged_splitkv   PagedMLAPool, the hand-written Hopper kernels
                       (single pass, or split-KV + LSE combine)

The contiguous-cache backends and the shard_map region are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core.kvcache import PagedMLAPool
from repro_torch.kernels.mla_decode import ops as _ops


class DecodeQuery(NamedTuple):
    """Prepared decode query (after Fused-Q-Quant / ``ref.prepare_q``)."""

    q_c8: torch.Tensor     # [B, H, d_c] quantized content query
    q_r: torch.Tensor      # [B, H, d_r] rope query, / sigma_q
    sigma_q: torch.Tensor  # [B, H]


@dataclasses.dataclass(frozen=True)
class BackendConfig:
    """Decode-attention parameters shared by every backend. ``num_splits``
    None/0 = the context-length heuristic."""

    softmax_scale: float
    fmt: str = "fp8_e4m3"
    num_splits: int | None = None


@dataclasses.dataclass(frozen=True)
class DecodeBackend:
    name: str
    layout: str    # "paged" (the only layout ported)
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


def _supports_paged(paged: bool = False) -> tuple[bool, str]:
    if not paged:
        return False, ("consumes a paged pool; the contiguous MLACache is not "
                       "ported yet")
    return True, ""


def _paged_decode(use_kernel: bool):
    def decode(q: DecodeQuery, pool: PagedMLAPool, cfg: BackendConfig) -> torch.Tensor:
        o, _lse = _ops.snapmla_decode_paged(
            q.q_c8, q.q_r, q.sigma_q, pool, softmax_scale=cfg.softmax_scale,
            fmt=cfg.fmt, num_splits=cfg.num_splits, use_kernel=use_kernel)
        return o
    return decode


register(DecodeBackend("torch_paged_ref", "paged", "ref", _paged_decode(False),
                       _supports_paged))
register(DecodeBackend("cuda_paged_splitkv", "paged", "kernel", _paged_decode(True),
                       _supports_paged))


def canonical_name(request: str, paged: bool) -> str:
    """Map 'ref' / 'kernel' (or an exact registry name) to a registry name."""
    if not paged and request in ("ref", "kernel"):
        raise ValueError("the contiguous MLACache backends are not ported yet; "
                         "use a paged pool")
    if request == "ref":
        return "torch_paged_ref"
    if request == "kernel":
        return "cuda_paged_splitkv"
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
