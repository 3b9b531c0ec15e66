"""Wrapper of the Fused-Q-Quant kernel (CUDA source in
``repro_torch/csrc/q_quant.cu``); replaces
``repro/kernels/quantize/kernel.py::fused_q_quant_pallas``. On CPU tensors it
runs its plain version, ``ref.fused_q_quant_ref``."""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import _lib
from repro_torch.kernels.quantize import ref as R

FMT_CODES = {"fp8_e4m3": 0, "int8": 1}


def fused_q_quant_cuda(q: torch.Tensor, d_c: int, *, fmt: str = "fp8_e4m3"):
    """q [B, H, d_c + d_r] f32 -> (q_c8 [B, H, d_c], q_r_scaled [B, H, d_r] f32,
    sigma_q [B, H] f32)."""
    if q.device.type == "cpu":
        return R.fused_q_quant_ref(q, d_c, fmt=fmt)
    if fmt not in FMT_CODES:
        raise ValueError(f"fused_q_quant takes fp8_e4m3 or int8, not {fmt!r}")
    B, H, d = q.shape
    d_r = d - d_c
    _lib.check(q, "q", torch.float32, (B, H, d), q.device)
    q_c8 = torch.empty((B, H, d_c), dtype=quant.qdtype_for(fmt), device=q.device)
    q_r = torch.empty((B, H, d_r), dtype=torch.float32, device=q.device)
    sigma_q = torch.empty((B, H), dtype=torch.float32, device=q.device)
    _lib.launch("fused_q_quant", "snapmla_fused_q_quant", FMT_CODES[fmt], q.data_ptr(),
                q_c8.data_ptr(), q_r.data_ptr(), sigma_q.data_ptr(), B, H, d_c, d_r)
    return q_c8, q_r, sigma_q
