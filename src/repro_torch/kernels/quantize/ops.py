"""Fused token preparation (port of ``repro/kernels/quantize/ops.py``):
Fused-Q-Quant, and Fused-K-Append into a contiguous cache (the paged append
is a scatter, ``core.kvcache.paged_mla_append``)."""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import MLACache, sink_append
from repro_torch.kernels.quantize import kernel as _k
from repro_torch.kernels.quantize import ref as _ref


def fused_q_quant(q: torch.Tensor, d_c: int, *, fmt: str = "fp8_e4m3",
                  use_kernel: bool = True):
    """q [B, H, d_c + d_r] f32 -> (q_c8, q_r_scaled f32, sigma_q)."""
    if use_kernel:
        return _k.fused_q_quant_cuda(q, d_c, fmt=fmt)
    return _ref.fused_q_quant_ref(q, d_c, fmt=fmt)


def fused_k_append(cache: MLACache, c_kv: torch.Tensor, k_r: torch.Tensor, *,
                   fmt: str = "fp8_e4m3", use_kernel: bool = True) -> MLACache:
    """Append one token per sequence to a quantized contiguous cache (in
    place): row ``seq_lens[b]`` gets the quantized entry, ``seq_lens`` grows
    by one and the sink guard takes the raw latent where the row is guarded."""
    c_kv, k_r = c_kv.float().contiguous(), k_r.float().contiguous()
    fn = _k.fused_k_append_cuda if use_kernel else _ref.fused_k_append_ref
    fn(cache.content, cache.rope, cache.scale, c_kv, k_r, cache.seq_lens, fmt=fmt)
    return cache._replace(seq_lens=cache.seq_lens + 1,
                          sink=sink_append(cache, c_kv, cache.seq_lens.long(), None))
