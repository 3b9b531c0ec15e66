"""FP8 quantized GQA decode over a ``GQACache`` (port of
``repro/kernels/gqa_decode/ops.py``)."""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import GQACache
from repro_torch.kernels.gqa_decode import kernel as _k


def gqa_decode(q: torch.Tensor, cache: GQACache, positions: torch.Tensor, *,
               window: int = 0, block_n: int = 128, fmt: str = "fp8_e4m3",
               use_kernel: bool = True) -> torch.Tensor:
    """q [B, H, dh] (RoPE applied), positions [B] -> o [B, H, dh] f32.

    ``use_kernel``: #7 on CUDA tensors (a failed build or launch raises),
    its plain version on CPU tensors; ``use_kernel=False``: the plain
    version on either device. The plain version pads the cache to a multiple
    of ``block_n`` with empty slots (unit scales, ``slot_pos = -1``), as the
    reference does; the kernel masks those slots instead."""
    args = (q.float().contiguous(), cache.k, cache.v, cache.k_scale, cache.v_scale,
            cache.slot_pos, positions.to(torch.int32).contiguous())
    kw = dict(window=window, block_n=block_n, fmt=fmt)
    if use_kernel:
        return _k.gqa_decode_cuda(*args, **kw)
    return _k.gqa_decode_plain(*args, **kw)
