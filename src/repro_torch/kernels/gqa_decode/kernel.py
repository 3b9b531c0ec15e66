"""Wrapper of the FP8 GQA decode kernel (CUDA source in
``repro_torch/csrc/gqa_decode.cu``): ``gqa_decode_cuda`` — #7; replaces
``repro/kernels/gqa_decode/kernel.py::gqa_decode_pallas``.

On CPU tensors it runs its plain version (``ref.gqa_decode_pipeline_ref``
over the cache padded to a multiple of ``block_n``, as the reference's op
pads it); on CUDA tensors it launches the kernel, which masks the slots past
N itself instead of copying the cache, or raises.

Each launch computes ``gqa_head_width(...)`` query heads of one kv head per
CUDA block, one of the two widths the kernel is instantiated for; the width
changes which block computes a query row, never a bit of the result. Head
sizes up to 128 and 256 (recurrentgemma-9b's) run separate instantiations
(``kGqaMaxDhSmall``, ``kGqaMaxDhLarge``)."""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.gqa_decode import ref as R

FMT_CODES = {"fp8_e4m3": 0, "int8": 1, "none": 2}
STORAGE = {"fp8_e4m3": torch.float8_e4m3fn, "int8": torch.int8, "none": torch.bfloat16}
HEAD_DIMS = (16, 32, 64, 128, 256)          # the head sizes the kernel takes
BLOCK_SIZES = (16, 32, 64, 128, 256, 512)   # the KV block sizes the kernel takes
LAUNCH_KEY = "gqa_decode"                   # the launch counter of #7
# head-tile widths instantiated in gqa_decode.cu (kGqaWide, kGqaNarrow), widest first
GQA_HEAD_WIDTHS = (4, 1)
_TILES = _lib.HeadTiles("GQA head", GQA_HEAD_WIDTHS)


def gqa_head_width(batch: int, kv_heads: int, g: int, sms: int) -> int:
    """Query heads per CUDA block of one #7 launch: the widest instantiated
    width whose grid, ``batch * kv_heads * ceil(g / width)`` blocks, covers
    the card's ``sms`` SMs (a wider tile reads each K/V block once for more
    query rows), else the narrowest (the most blocks)."""
    return _TILES.pick(lambda w: batch * kv_heads * -(-g // w), sms)


def forced_gqa_head_width(width: int):
    """Launch #7 inside the block at ``width`` query heads per CUDA block in
    place of ``gqa_head_width``'s pick (to compare the widths); raises on a
    width that is not instantiated."""
    return _TILES.forcing(width)


def gqa_decode_plain(q, k8, v8, k_scale, v_scale, slot_pos, positions, *, window: int,
                     block_n: int, fmt: str) -> torch.Tensor:
    """The kernel's plain version: pad N to a multiple of ``block_n`` with
    empty slots, then the pipeline."""
    padded = R.pad_to_block(k8, v8, k_scale, v_scale, slot_pos, block_n)
    return R.gqa_decode_pipeline_ref(q.float(), *padded, positions, window=window,
                                     block_n=block_n, fmt=fmt)


def gqa_decode_cuda(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                    k_scale: torch.Tensor, v_scale: torch.Tensor, slot_pos: torch.Tensor,
                    positions: torch.Tensor, *, window: int = 0, block_n: int = 128,
                    fmt: str = "fp8_e4m3") -> torch.Tensor:
    """q [B, H, dh] f32, k8 / v8 [B, N, Hkv, dh] (storage format), k_scale /
    v_scale [B, N, Hkv] f32, slot_pos [B, N] int32, positions [B] int32 ->
    o [B, H, dh] f32."""
    args = (q, k8, v8, k_scale, v_scale, slot_pos, positions)
    devices = {t.device for t in args}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return gqa_decode_plain(*args, window=window, block_n=block_n, fmt=fmt)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    if fmt not in FMT_CODES:
        raise ValueError(f"fmt must be one of {sorted(FMT_CODES)}, not {fmt!r}")
    B, H, dh = q.shape
    N, Hkv = k8.shape[1], k8.shape[2]
    if dh not in HEAD_DIMS or block_n not in BLOCK_SIZES or H % Hkv or window < 0:
        raise ValueError(f"the kernel takes dh in {HEAD_DIMS} (got {dh}), a KV block "
                         f"of {BLOCK_SIZES} slots (got {block_n}), H a multiple of Hkv "
                         f"(got {H}, {Hkv}) and window >= 0 (got {window})")
    _lib.check(q, "q", torch.float32, (B, H, dh), dev)
    _lib.check(k8, "k8", STORAGE[fmt], (B, N, Hkv, dh), dev)
    _lib.check(v8, "v8", STORAGE[fmt], (B, N, Hkv, dh), dev)
    _lib.check(k_scale, "k_scale", torch.float32, (B, N, Hkv), dev)
    _lib.check(v_scale, "v_scale", torch.float32, (B, N, Hkv), dev)
    _lib.check(slot_pos, "slot_pos", torch.int32, (B, N), dev)
    _lib.check(positions, "positions", torch.int32, (B,), dev)
    if k8.data_ptr() % 16 or v8.data_ptr() % 16:
        raise ValueError("k8 and v8 must be 16-byte aligned")
    o = torch.empty((B, H, dh), dtype=torch.float32, device=dev)
    g = H // Hkv
    width = _TILES.forced or gqa_head_width(B, Hkv, g, _lib.sm_count(dev.index or 0))
    _lib.launch(LAUNCH_KEY, "snapmla_gqa_decode", FMT_CODES[fmt], q.data_ptr(), k8.data_ptr(),
                v8.data_ptr(), k_scale.data_ptr(), v_scale.data_ptr(), slot_pos.data_ptr(),
                positions.data_ptr(), o.data_ptr(), B, N, Hkv, g, dh, block_n, window,
                1.0 / math.sqrt(dh), width)
    return o
