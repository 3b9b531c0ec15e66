"""Wrappers of the SnapMLA paged decode kernels (CUDA sources in
``repro_torch/csrc/mla_decode.cu``).

  * ``mla_decode_paged_splitkv_cuda`` — kernel A (paged split-KV, FMA
    rescale, q_len = 1) then kernel C; replaces
    ``repro/kernels/mla_decode/kernel.py::mla_decode_paged_splitkv_pallas``;
  * ``mla_decode_paged_cuda`` — kernel B (the same kernel in single-pass
    mode); replaces ``mla_decode_paged_pallas``;
  * ``lse_combine_cuda`` — kernel C; replaces ``lse_combine_pallas``.

A wrapper runs its plain PyTorch version (``ref.py``) only when it is handed
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import ref as R

FMT_CODES = {"fp8_e4m3": 0, "int8": 1, "none": 2}
STORAGE = {"fp8_e4m3": torch.float8_e4m3fn, "int8": torch.int8, "none": torch.bfloat16}


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check_decode_inputs(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool,
                         page_table, seq_lens, fmt):
    B, H, d_c = q_c8.shape
    d_r = q_r.shape[-1]
    n_pages, page, _ = content_pool.shape
    P = page_table.shape[1]
    dev = q_c8.device
    _lib.check(q_c8, "q_c8", STORAGE[fmt], (B, H, d_c), dev)
    _lib.check(q_r, "q_r", torch.float32, (B, H, d_r), dev)
    _lib.check(sigma_q, "sigma_q", torch.float32, (B, H), dev)
    _lib.check(content_pool, "content_pool", STORAGE[fmt], (n_pages, page, d_c), dev)
    _lib.check(rope_pool, "rope_pool", torch.bfloat16, (n_pages, page, d_r), dev)
    _lib.check(scale_pool, "scale_pool", torch.float32, (n_pages, page), dev)
    _lib.check(page_table, "page_table", torch.int32, (B, P), dev)
    _lib.check(seq_lens, "seq_lens", torch.int32, (B,), dev)
    if d_c % 4 or d_r % 2 or page not in (16, 32, 64, 128, 256, 512):
        raise ValueError(f"the kernel takes d_c % 4 == 0 (got {d_c}), even d_r "
                         f"(got {d_r}) and a power-of-two page in [16, 512] "
                         f"(got {page})")
    return B, H, d_c, d_r, page, P


def paged_decode_partials_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool,
                               scale_pool, page_table, seq_lens, *,
                               softmax_scale: float, num_splits: int, fmt: str,
                               single_pass: bool):
    """Launch kernel A (``single_pass=False``) or B: per-split partials
    (o [B, S, H, d_c], lse [B, S, H], sigma_p [B, S, H] — sigma_p only for A)."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        if single_pass:
            o, lse = R.snapmla_decode_paged_ref(*args, softmax_scale=softmax_scale,
                                                fmt=fmt)
            return o[:, None], lse[:, None], None
        return R.snapmla_decode_paged_splitkv_ref(
            *args, softmax_scale=softmax_scale, num_splits=num_splits, fmt=fmt,
            return_partials=True)[2]
    B, H, d_c, d_r, page, P = _check_decode_inputs(
        q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
        seq_lens, fmt)
    if not 1 <= num_splits <= P:
        raise ValueError(f"num_splits={num_splits} outside [1, {P}]")
    pages_per_split = -(-P // num_splits)
    dev = q_c8.device
    o_p = torch.empty((B, num_splits, H, d_c), dtype=torch.float32, device=dev)
    lse_p = torch.empty((B, num_splits, H), dtype=torch.float32, device=dev)
    sp_p = None if single_pass else torch.empty_like(lse_p)
    _lib.launch(
        "paged_single_pass_decode" if single_pass else "paged_splitkv_decode",
        "snapmla_paged_decode", FMT_CODES[fmt], int(single_pass),
        q_c8.data_ptr(), q_r.data_ptr(), sigma_q.data_ptr(), content_pool.data_ptr(),
        rope_pool.data_ptr(), scale_pool.data_ptr(), page_table.data_ptr(),
        seq_lens.data_ptr(), o_p.data_ptr(), lse_p.data_ptr(),
        None if sp_p is None else sp_p.data_ptr(), B, H, d_c, d_r, page, P,
        num_splits, pages_per_split, float(softmax_scale))
    return o_p, lse_p, sp_p


def lse_combine_cuda(o_partial: torch.Tensor, lse_partial: torch.Tensor):
    """Kernel C: o_partial [B, S, H, d_c] f32, lse_partial [B, S, H] f32 ->
    (o [B, H, d_c], lse [B, H])."""
    if _on_cpu(o_partial, lse_partial):
        return R.lse_combine_ref(o_partial, lse_partial)
    B, S, H, d_c = o_partial.shape
    dev = o_partial.device
    _lib.check(o_partial, "o_partial", torch.float32, (B, S, H, d_c), dev)
    _lib.check(lse_partial, "lse_partial", torch.float32, (B, S, H), dev)
    o = torch.empty((B, H, d_c), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    _lib.launch("lse_combine", "snapmla_lse_combine", o_partial.data_ptr(),
                lse_partial.data_ptr(), o.data_ptr(), lse.data_ptr(), B, S, H, d_c)
    return o, lse


def mla_decode_paged_splitkv_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool,
                                  scale_pool, page_table, seq_lens, *,
                                  softmax_scale: float, num_splits: int,
                                  fmt: str = "fp8_e4m3",
                                  return_partials: bool = False):
    """Paged split-KV SnapMLA decode (kernel A, then kernel C). Returns
    (o [B, H, d_c] f32, lse [B, H]) — plus (o, lse, sigma_p) partials when
    ``return_partials``."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        return R.snapmla_decode_paged_splitkv_ref(
            *args, softmax_scale=softmax_scale, num_splits=num_splits, fmt=fmt,
            return_partials=return_partials)
    o_p, lse_p, sp_p = paged_decode_partials_cuda(
        *args, softmax_scale=softmax_scale, num_splits=num_splits, fmt=fmt,
        single_pass=False)
    o, lse = lse_combine_cuda(o_p, lse_p)
    if return_partials:
        return o, lse, (o_p, lse_p, sp_p)
    return o, lse


def mla_decode_paged_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool,
                          page_table, seq_lens, *, softmax_scale: float,
                          fmt: str = "fp8_e4m3"):
    """Paged single-pass SnapMLA decode (kernel B, no early exit). Returns
    (o [B, H, d_c] f32, lse [B, H])."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        return R.snapmla_decode_paged_ref(*args, softmax_scale=softmax_scale, fmt=fmt)
    o_p, lse_p, _ = paged_decode_partials_cuda(
        *args, softmax_scale=softmax_scale, num_splits=1, fmt=fmt, single_pass=True)
    return o_p[:, 0], lse_p[:, 0]
