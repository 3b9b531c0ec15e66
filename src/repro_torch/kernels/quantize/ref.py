"""Plain PyTorch versions of the fused token-preparation kernels (port of
``repro/kernels/quantize/ref.py``, paper §3.3.1)."""
from __future__ import annotations

import torch

from repro_torch.core import quant


def fused_q_quant_ref(q: torch.Tensor, d_c: int, fmt: str = "fp8_e4m3"):
    """q [B, H, d_c + d_r] f32 -> (q_c8 [B, H, d_c], q_r_scaled [B, H, d_r]
    f32, sigma_q [B, H] f32): per-(token, head) scale, cast, and RoPE-domain
    alignment in one logical step."""
    q_c, q_r = q[..., :d_c], q[..., d_c:]
    raq = quant.quantize_rope_aware(q_c, q_r, fmt, rope_dtype=torch.float32)
    return raq.q_content, raq.rope_scaled, raq.scale[..., 0]


def fused_k_append_ref(content: torch.Tensor, rope: torch.Tensor, scale: torch.Tensor,
                       c_kv: torch.Tensor, k_r: torch.Tensor, seq_lens: torch.Tensor,
                       fmt: str = "fp8_e4m3"):
    """Fused-K-Append: quantize c_kv [B, d_c] / k_r [B, d_r] per token
    (RoPE-aware, Eq. 6) and write them IN PLACE at row ``seq_lens[b]`` of the
    contiguous cache (content [B, N, d_c], rope [B, N, d_r], scale [B, N]),
    the row clamped to the last one as ``dynamic_update_slice`` clamps it.
    Returns the (same) content, rope and scale tensors."""
    raq = quant.quantize_rope_aware(c_kv, k_r, fmt, rope_dtype=torch.float32)
    rows = torch.arange(c_kv.shape[0], device=content.device)
    idx = torch.clamp(seq_lens.long(), 0, content.shape[1] - 1)
    content[rows, idx] = raq.q_content.to(content.dtype)
    rope[rows, idx] = raq.rope_scaled.to(rope.dtype)
    scale[rows, idx] = raq.scale[..., 0]
    return content, rope, scale
