"""Quantization primitives for SnapMLA (port of ``repro/core/quant.py``).

The paper's toolbox (Appendix C granularities) plus the two SnapMLA
operations: RoPE-aware per-token KV quantization with domain alignment
(§3.1, Eq. 6) and scale-fused block-wise dynamic P quantization (§3.2).

FP8 is stored as ``torch.float8_e4m3fn`` (clipped to ±448 before the
round-to-nearest-even cast), INT8 as ``torch.int8`` after ``torch.round``
(half to even, like ``jnp.round``).

Scale arithmetic follows the reference as XLA compiles it: ``x / qmax`` with
the constant ``qmax`` is computed as ``x * f32(1 / qmax)``, which is what
every jitted JAX path and every Pallas kernel (interpret mode included)
produces. The port's CUDA kernels use the same product, so kernel and plain
version agree bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Tuple

import torch

FP8_DTYPE = torch.float8_e4m3fn
FP8_MAX = 448.0  # max finite magnitude of e4m3fn
INT8_MAX = 127.0
EPS = 1e-12  # lower bound for dynamic scales (paper App. D)

QuantFormat = Literal["fp8_e4m3", "int8", "none"]


def qmax_for(fmt: QuantFormat) -> float:
    if fmt == "fp8_e4m3":
        return FP8_MAX
    if fmt == "int8":
        return INT8_MAX
    raise ValueError(f"no qmax for format {fmt!r}")


def qdtype_for(fmt: QuantFormat) -> torch.dtype:
    if fmt == "fp8_e4m3":
        return FP8_DTYPE
    if fmt == "int8":
        return torch.int8
    raise ValueError(f"no dtype for format {fmt!r}")


def dynamic_scale(amax: torch.Tensor, qmax: float) -> torch.Tensor:
    """``max(amax, EPS) / qmax`` as the reference's compiled form computes it
    (multiplication by the float32 reciprocal of the constant)."""
    return torch.clamp(amax, min=EPS) * (1.0 / qmax)


def _cast(x: torch.Tensor, fmt: QuantFormat) -> torch.Tensor:
    """Cast a pre-scaled tensor into the storage format (with round/clip)."""
    if fmt == "fp8_e4m3":
        return torch.clamp(x, -FP8_MAX, FP8_MAX).to(FP8_DTYPE)
    if fmt == "int8":
        return torch.clamp(torch.round(x), -INT8_MAX, INT8_MAX).to(torch.int8)
    raise ValueError(fmt)


@dataclasses.dataclass(frozen=True)
class Quantized:
    """A quantized tensor: ``real ≈ q.float() * scale`` (scale broadcast)."""

    q: torch.Tensor
    scale: torch.Tensor

    def dequant(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q.float() * self.scale.float()).to(dtype)

    @property
    def shape(self):
        return self.q.shape


# ---------------------------------------------------------------------------
# Granularities (paper Appendix C)
# ---------------------------------------------------------------------------

def quantize_per_token(x: torch.Tensor, fmt: QuantFormat = "fp8_e4m3") -> Quantized:
    """Per-token (Eq. 8): one scale per leading-index row; scale shape
    ``x.shape[:-1] + (1,)``."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    scale = dynamic_scale(amax, qmax_for(fmt))
    return Quantized(_cast(xf / scale, fmt), scale)


def quantize_per_channel(x: torch.Tensor, fmt: QuantFormat = "fp8_e4m3") -> Quantized:
    """Per-channel (Eq. 9): one scale per last-axis channel."""
    xf = x.float()
    red = tuple(range(x.ndim - 1))
    amax = torch.amax(torch.abs(xf), dim=red, keepdim=True)
    scale = dynamic_scale(amax, qmax_for(fmt))
    return Quantized(_cast(xf / scale, fmt), scale)


def quantize_per_tensor(x: torch.Tensor, fmt: QuantFormat = "fp8_e4m3",
                        static_scale: float | None = None) -> Quantized:
    """Per-tensor (Eq. 7). ``static_scale`` reproduces paper Config B."""
    xf = x.float()
    if static_scale is not None:
        scale = torch.full((1,) * x.ndim, static_scale, dtype=torch.float32,
                           device=x.device)
    else:
        amax = torch.amax(torch.abs(xf))
        scale = dynamic_scale(amax, qmax_for(fmt)).reshape((1,) * x.ndim)
    return Quantized(_cast(xf / scale, fmt), scale)


def quantize_per_block(x: torch.Tensor, block: Tuple[int, int] = (64, 64),
                       fmt: QuantFormat = "fp8_e4m3") -> Quantized:
    """Per-block (Eq. 10-11) over the last two axes; both must be divisible
    by ``block`` (callers pad)."""
    *lead, m, n = x.shape
    bm, bn = block
    if m % bm or n % bn:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by block {block}")
    xb = x.float().reshape(*lead, m // bm, bm, n // bn, bn)
    amax = torch.amax(torch.abs(xb), dim=(-3, -1), keepdim=True)
    scale = dynamic_scale(amax, qmax_for(fmt))
    q = _cast(xb / scale, fmt).reshape(x.shape)
    scale_full = torch.broadcast_to(scale, xb.shape).reshape(x.shape)
    return Quantized(q, scale_full)


# ---------------------------------------------------------------------------
# SnapMLA Key Step 1: RoPE-aware per-token quantization with domain alignment
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RopeAwareQuantized:
    """An MLA KV entry (or Q row) split as [content | rope]: real content ≈
    ``q_content * scale``, real rope = ``rope_scaled * scale`` (rope stored
    pre-divided by the content scale — Eq. 6 domain alignment)."""

    q_content: torch.Tensor    # [..., d_c] storage dtype
    rope_scaled: torch.Tensor  # [..., d_r] high precision, pre-divided by scale
    scale: torch.Tensor        # [..., 1] f32

    def dequant_content(self, dtype=torch.float32) -> torch.Tensor:
        return (self.q_content.float() * self.scale).to(dtype)

    def dequant_rope(self, dtype=torch.float32) -> torch.Tensor:
        return (self.rope_scaled.float() * self.scale).to(dtype)

    def dequant_concat(self, dtype=torch.float32) -> torch.Tensor:
        return torch.cat([self.dequant_content(dtype), self.dequant_rope(dtype)],
                         dim=-1)


def quantize_rope_aware(content: torch.Tensor, rope: torch.Tensor,
                        fmt: QuantFormat = "fp8_e4m3",
                        rope_dtype: torch.dtype = torch.bfloat16) -> RopeAwareQuantized:
    """Paper §3.1 + Eq. 6: per-token scale from the content part only; the
    rope part is kept in high precision, divided by the content scale."""
    qc = quantize_per_token(content, fmt)
    rope_scaled = (rope.float() / qc.scale).to(rope_dtype)
    return RopeAwareQuantized(qc.q, rope_scaled, qc.scale)


def quantize_rope_unaware(content: torch.Tensor, rope: torch.Tensor,
                          fmt: QuantFormat = "fp8_e4m3") -> RopeAwareQuantized:
    """Paper Config A ablation: quantize content AND rope per token jointly."""
    full = torch.cat([content.float(), rope.float()], dim=-1)
    qf = quantize_per_token(full, fmt)
    d_c = content.shape[-1]
    return RopeAwareQuantized(qf.q[..., :d_c], qf.q[..., d_c:].float(), qf.scale)


# ---------------------------------------------------------------------------
# SnapMLA Key Step 2 helper: scale fusion + block-wise dynamic P quantization
# ---------------------------------------------------------------------------

def fuse_and_quantize_p(p: torch.Tensor, v_scale: torch.Tensor,
                        fmt: QuantFormat = "fp8_e4m3"
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fuse the per-token V scale into a probability block and quantize it:
    returns ``(p_q, sigma_p)`` with ``p * v_scale ≈ p_q * sigma_p``, one
    sigma_p per row (``[..., 1]``)."""
    p_fused = p.float() * v_scale.float()
    amax = torch.amax(torch.abs(p_fused), dim=-1, keepdim=True)
    sigma_p = dynamic_scale(amax, qmax_for(fmt))
    return _cast(p_fused / sigma_p, fmt), sigma_p


# ---------------------------------------------------------------------------
# Analysis helpers (paper Fig. 3: value ranges + quantization MSE)
# ---------------------------------------------------------------------------

def quant_mse(x: torch.Tensor, fmt: QuantFormat = "fp8_e4m3",
              granularity: str = "per_token") -> torch.Tensor:
    """Round-trip MSE of a tensor under a given quantization config."""
    fn = {
        "per_token": quantize_per_token,
        "per_channel": quantize_per_channel,
        "per_tensor": quantize_per_tensor,
        "per_block": lambda t, fmt: quantize_per_block(t, (64, 64), fmt),
    }[granularity]
    q = fn(x, fmt)
    err = q.dequant(torch.float32) - x.float()
    return torch.mean(err * err)


def dynamic_range(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    xf = torch.abs(x.float())
    return torch.amin(xf), torch.amax(xf)
