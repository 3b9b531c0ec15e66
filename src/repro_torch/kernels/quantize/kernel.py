"""Wrappers of the fused token-preparation kernels (CUDA sources in
``repro_torch/csrc/q_quant.cu`` and ``k_append.cu``):

  * ``fused_q_quant_cuda`` — kernel D; replaces
    ``repro/kernels/quantize/kernel.py::fused_q_quant_pallas``;
  * ``fused_k_append_cuda`` — #9; replaces ``fused_k_append_pallas``.

Each kernel has two instantiations: one at the MLA configs' widths
(``FULL_WIDTHS``, compile-time: 16-byte loads and stores, every loop
unrolled) and one at runtime widths that assumes no alignment.
``token_prep_plan`` picks the instantiation and gives the grid of a launch.
On CPU tensors each wrapper runs its plain version (``ref.py``); on CUDA
tensors it launches its kernel."""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.kernels import _lib
from repro_torch.kernels.quantize import ref as R

FMT_CODES = {"fp8_e4m3": 0, "int8": 1}
# (d_c, d_r) of the compile-time instantiation: common.cuh's kTokenDc, kTokenDr
FULL_WIDTHS = (512, 64)
# D's rows (one warp each) per CUDA block: q_quant.cu's kQuantRows
Q_ROWS_PER_BLOCK = 4


def _check_fmt(name: str, fmt: str) -> None:
    if fmt not in FMT_CODES:
        raise ValueError(f"{name} takes fp8_e4m3 or int8, not {fmt!r}")


def token_prep_plan(kernel: str, rows: int, d_c: int, d_r: int,
                    aligned: bool) -> tuple[bool, int]:
    """(full, blocks) of one launch of ``kernel`` ("q_quant": D, a row per
    (token, head); "k_append": #9, a row per batch row) over ``rows`` rows.
    ``full``: the instantiation at ``FULL_WIDTHS``, taken when the widths are
    those and ``aligned`` (every pointer 16-byte aligned); else the
    runtime-width one. D puts ``Q_ROWS_PER_BLOCK`` rows in a block, #9 one."""
    if kernel not in ("q_quant", "k_append"):
        raise ValueError(f"token_prep_plan: no kernel {kernel!r}")
    full = aligned and (d_c, d_r) == FULL_WIDTHS
    return full, -(-rows // Q_ROWS_PER_BLOCK) if kernel == "q_quant" else rows


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in ts)


def fused_q_quant_cuda(q: torch.Tensor, d_c: int, *, fmt: str = "fp8_e4m3"):
    """q [B, H, d_c + d_r] f32 -> (q_c8 [B, H, d_c], q_r_scaled [B, H, d_r] f32,
    sigma_q [B, H] f32)."""
    if q.device.type == "cpu":
        return R.fused_q_quant_ref(q, d_c, fmt=fmt)
    _check_fmt("fused_q_quant", fmt)
    B, H, d = q.shape
    d_r = d - d_c
    _lib.check(q, "q", torch.float32, (B, H, d), q.device)
    q_c8 = torch.empty((B, H, d_c), dtype=quant.qdtype_for(fmt), device=q.device)
    q_r = torch.empty((B, H, d_r), dtype=torch.float32, device=q.device)
    sigma_q = torch.empty((B, H), dtype=torch.float32, device=q.device)
    full, _ = token_prep_plan("q_quant", B * H, d_c, d_r, _aligned(q, q_c8, q_r, sigma_q))
    _lib.launch("fused_q_quant", "snapmla_fused_q_quant", FMT_CODES[fmt], q.data_ptr(),
                q_c8.data_ptr(), q_r.data_ptr(), sigma_q.data_ptr(), B, H, d_c, d_r, int(full))
    return q_c8, q_r, sigma_q


def fused_k_append_cuda(content: torch.Tensor, rope: torch.Tensor, scale: torch.Tensor,
                        c_kv: torch.Tensor, k_r: torch.Tensor, seq_lens: torch.Tensor, *,
                        fmt: str = "fp8_e4m3"):
    """Quantize c_kv [B, d_c] / k_r [B, d_r] (f32) per token and write them
    in place at row ``seq_lens[b]`` of content [B, N, d_c], rope [B, N, d_r]
    bf16 and scale [B, N] f32. Returns (content, rope, scale)."""
    devices = {t.device for t in (content, rope, scale, c_kv, k_r, seq_lens)}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    if content.device.type == "cpu":
        return R.fused_k_append_ref(content, rope, scale, c_kv, k_r, seq_lens, fmt=fmt)
    _check_fmt("fused_k_append", fmt)
    B, N, d_c = content.shape
    d_r = rope.shape[-1]
    dev = content.device
    _lib.check(content, "content", quant.qdtype_for(fmt), (B, N, d_c), dev)
    _lib.check(rope, "rope", torch.bfloat16, (B, N, d_r), dev)
    _lib.check(scale, "scale", torch.float32, (B, N), dev)
    _lib.check(c_kv, "c_kv", torch.float32, (B, d_c), dev)
    _lib.check(k_r, "k_r", torch.float32, (B, d_r), dev)
    _lib.check(seq_lens, "seq_lens", torch.int32, (B,), dev)
    full, _ = token_prep_plan("k_append", B, d_c, d_r,
                              _aligned(c_kv, k_r, content, rope, scale, seq_lens))
    _lib.launch("fused_k_append", "snapmla_fused_k_append", FMT_CODES[fmt], c_kv.data_ptr(),
                k_r.data_ptr(), content.data_ptr(), rope.data_ptr(), scale.data_ptr(),
                seq_lens.data_ptr(), B, N, d_c, d_r, int(full))
    return content, rope, scale
