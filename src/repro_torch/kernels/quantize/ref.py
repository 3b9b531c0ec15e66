"""Plain PyTorch version of Fused-Q-Quant (port of
``repro/kernels/quantize/ref.py::fused_q_quant_ref``, paper §3.3.1)."""
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
