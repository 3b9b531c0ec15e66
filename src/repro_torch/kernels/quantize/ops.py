"""Fused token preparation (port of ``repro/kernels/quantize/ops.py``, the
Fused-Q-Quant half; Fused-K-Append into a contiguous cache is not ported —
the paged append is a scatter, ``core.kvcache.paged_mla_append``)."""
from __future__ import annotations

import torch

from repro_torch.kernels.quantize import kernel as _k
from repro_torch.kernels.quantize import ref as _ref


def fused_q_quant(q: torch.Tensor, d_c: int, *, fmt: str = "fp8_e4m3",
                  use_kernel: bool = True):
    """q [B, H, d_c + d_r] f32 -> (q_c8, q_r_scaled f32, sigma_q)."""
    if use_kernel:
        return _k.fused_q_quant_cuda(q, d_c, fmt=fmt)
    return _ref.fused_q_quant_ref(q, d_c, fmt=fmt)
