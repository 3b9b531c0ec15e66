"""Wrappers of the SnapMLA decode kernels (CUDA sources in
``repro_torch/csrc/mla_decode.cu``). Each takes ``rescale`` ("fma" or
"amla", the two modes of the reference's ``_block_pipeline``):

  * ``mla_decode_paged_splitkv_cuda`` — kernel A (paged split-KV, q_len = 1)
    then kernel C (FMA) or #4 (AMLA); replaces
    ``repro/kernels/mla_decode/kernel.py::mla_decode_paged_splitkv_pallas``;
  * ``mla_decode_paged_cuda`` — kernel B (the same kernel in single-pass
    mode); replaces ``mla_decode_paged_pallas``;
  * ``mla_decode_splitkv_cuda`` — #2, kernel A over a contiguous cache, then
    the combine; replaces ``mla_decode_splitkv_pallas``;
  * ``mla_decode_cuda`` — #1, kernel B over a contiguous cache; replaces
    ``mla_decode_pallas``;
  * ``lse_combine_cuda`` — kernel C; replaces ``lse_combine_pallas``;
  * ``amla_combine_cuda`` — #4; replaces ``amla_combine_pallas``.

The contiguous wrappers take the cache's ``sink`` guard shadow: the kernel
substitutes ``sink / max(scale, tiny)`` on rows below ``S_k``.

The two split-KV wrappers also take a rank-4 query block ``[B, q_len, H, .]``
(the speculative verify, the q_len > 1 mode of #6 / #2): ``_flatten_q`` turns
it into ``R = q_len*H`` head-major rows (row = t*H + h) that the kernel's
verify instantiation masks per row at ``seq_len - (q_len - 1) + t``; C or #4
merges R rows, and ``_unflatten_rows`` gives o [B, q_len, H, d_c], lse
[B, q_len, H] back. A rank-4 query with q_len = 1 runs the ordinary kernel
and comes back rank-4. The verify mode takes no sink guard.

A wrapper runs its plain PyTorch version (``ref.py``) only when it is handed
CPU tensors; for CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import patch_sink_rows
from repro_torch.kernels import _lib
from repro_torch.kernels.mla_decode import ref as R

FMT_CODES = {"fp8_e4m3": 0, "int8": 1, "none": 2}
STORAGE = {"fp8_e4m3": torch.float8_e4m3fn, "int8": torch.int8, "none": torch.bfloat16}
BLOCK_SIZES = (16, 32, 64, 128, 256, 512)   # the KV block sizes the kernel takes
RESCALES = ("fma", "amla")


def _on_cpu(*tensors: torch.Tensor) -> bool:
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev.type == "cpu"


def _check_common(q_c8, q_r, sigma_q, seq_lens, fmt, B, d_r, block):
    H, d_c = q_c8.shape[1:]
    dev = q_c8.device
    _lib.check(q_c8, "q_c8", STORAGE[fmt], (B, H, d_c), dev)
    _lib.check(q_r, "q_r", torch.float32, (B, H, d_r), dev)
    _lib.check(sigma_q, "sigma_q", torch.float32, (B, H), dev)
    _lib.check(seq_lens, "seq_lens", torch.int32, (B,), dev)
    if d_c % 4 or d_r % 2 or block not in BLOCK_SIZES:
        raise ValueError(f"the kernel takes d_c % 4 == 0 (got {d_c}), even d_r "
                         f"(got {d_r}) and a KV block of {BLOCK_SIZES} tokens "
                         f"(got {block})")
    return H, d_c


def _flatten_q(q_c8, q_r, sigma_q):
    """[B, q_len, H, .] -> head-major rows [B, q_len*H, .], with (q_len, H);
    a rank-3 query passes through with q_len None (kernel.py:485-497)."""
    if q_c8.dim() == 3:
        return q_c8, q_r, sigma_q, None, q_c8.shape[1]
    B, q_len, H = q_c8.shape[:3]
    return (q_c8.reshape(B, q_len * H, -1), q_r.reshape(B, q_len * H, -1),
            sigma_q.reshape(B, q_len * H), q_len, H)


def _unflatten_rows(q_len, H, o, lse, partials):
    """Undo ``_flatten_q`` on the outputs and partials (kernel.py:500-513)."""
    if q_len is None:
        return o, lse, partials
    B = o.shape[0]
    o, lse = o.reshape(B, q_len, H, -1), lse.reshape(B, q_len, H)
    if partials is not None:
        o_p, lse_p, sp_p = partials
        S = o_p.shape[1]
        partials = (o_p.reshape(B, S, q_len, H, -1), lse_p.reshape(B, S, q_len, H),
                    sp_p.reshape(B, S, q_len, H))
    return o, lse, partials


def _launch_decode(kernel: str, fmt: str, single_pass: bool, rescale: str, q_c8, q_r,
                   sigma_q, content, rope, scale, page_table, seq_lens, sink, *, B, H,
                   d_c, d_r, block, P, num_splits, softmax_scale, q_len=1):
    """Allocate the partials and launch one decode kernel: o [B, S, H, d_c],
    lse [B, S, H] and (split mode) sigma_p or, under AMLA, g [B, S, H]."""
    if rescale not in RESCALES:
        raise ValueError(f"rescale must be one of {RESCALES}, not {rescale!r}")
    if not 1 <= num_splits <= P:
        raise ValueError(f"num_splits={num_splits} outside [1, {P}]")
    dev = q_c8.device
    o_p = torch.empty((B, num_splits, H, d_c), dtype=torch.float32, device=dev)
    lse_p = torch.empty((B, num_splits, H), dtype=torch.float32, device=dev)
    sp_p = None if single_pass else torch.empty_like(lse_p)
    amla = rescale == "amla"
    if q_len > 1:
        kernel += "_verify"
    _lib.launch(
        kernel + ("_amla" if amla else ""), "snapmla_decode", FMT_CODES[fmt],
        int(single_pass), int(amla), q_c8.data_ptr(), q_r.data_ptr(), sigma_q.data_ptr(),
        content.data_ptr(), rope.data_ptr(), scale.data_ptr(),
        None if page_table is None else page_table.data_ptr(), seq_lens.data_ptr(),
        None if sink is None else sink.data_ptr(), 0 if sink is None else sink.shape[1],
        o_p.data_ptr(), lse_p.data_ptr(), None if sp_p is None else sp_p.data_ptr(),
        B, H, d_c, d_r, block, P, num_splits, -(-P // num_splits), float(softmax_scale),
        q_len)
    return o_p, lse_p, sp_p


def paged_decode_partials_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool,
                               scale_pool, page_table, seq_lens, *,
                               softmax_scale: float, num_splits: int, fmt: str,
                               single_pass: bool, rescale: str = "fma", q_len: int = 1):
    """Launch kernel A (``single_pass=False``) or B: per-split partials
    (o [B, S, H, d_c], lse [B, S, H], sigma_p [B, S, H] — sigma_p only for A;
    under AMLA, A's partials are the raw (acc, l, g)). ``q_len > 1``: A's
    verify mode over flattened rows (H is then q_len * heads; CUDA only)."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        if single_pass:
            o, lse = R.snapmla_decode_paged_ref(*args, softmax_scale=softmax_scale,
                                                fmt=fmt, rescale=rescale)
            return o[:, None], lse[:, None], None
        return R.snapmla_decode_paged_splitkv_ref(
            *args, softmax_scale=softmax_scale, num_splits=num_splits, fmt=fmt,
            return_partials=True, rescale=rescale)[2]
    B, P = page_table.shape
    n_pages, page, _ = content_pool.shape
    d_r = q_r.shape[-1]
    H, d_c = _check_common(q_c8, q_r, sigma_q, seq_lens, fmt, B, d_r, page)
    dev = q_c8.device
    _lib.check(content_pool, "content_pool", STORAGE[fmt], (n_pages, page, d_c), dev)
    _lib.check(rope_pool, "rope_pool", torch.bfloat16, (n_pages, page, d_r), dev)
    _lib.check(scale_pool, "scale_pool", torch.float32, (n_pages, page), dev)
    _lib.check(page_table, "page_table", torch.int32, (B, P), dev)
    return _launch_decode(
        "paged_single_pass_decode" if single_pass else "paged_splitkv_decode", fmt,
        single_pass, rescale, q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool,
        page_table, seq_lens, None, B=B, H=H, d_c=d_c, d_r=d_r, block=page, P=P,
        num_splits=num_splits, softmax_scale=softmax_scale, q_len=q_len)


def decode_partials_cuda(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, *,
                         softmax_scale: float, block_n: int, num_splits: int, fmt: str,
                         single_pass: bool, rescale: str = "fma",
                         sink: torch.Tensor | None = None, q_len: int = 1):
    """Launch #2 (``single_pass=False``) or #1 over a contiguous cache
    (content [B, N, d_c], rope [B, N, d_r] bf16, scale [B, N]) in blocks of
    ``block_n`` tokens: per-split partials as ``paged_decode_partials_cuda``."""
    args = (q_c8, q_r, sigma_q, content, rope, scale, seq_lens)
    if _on_cpu(*args, sink):
        ref_args = (q_c8, q_r, sigma_q, patch_sink_rows(content, scale, sink),
                    rope.float(), scale, seq_lens)
        if single_pass:
            o, lse = R.snapmla_decode_pipeline_ref(
                *ref_args, softmax_scale=softmax_scale, block_n=block_n, fmt=fmt,
                rescale=rescale)
            return o[:, None], lse[:, None], None
        return R.snapmla_decode_splitkv_ref(
            *ref_args, softmax_scale=softmax_scale, num_splits=num_splits,
            block_n=block_n, fmt=fmt, return_partials=True, rescale=rescale)[2]
    B, N, _ = content.shape
    d_r = q_r.shape[-1]
    H, d_c = _check_common(q_c8, q_r, sigma_q, seq_lens, fmt, B, d_r, block_n)
    if N % block_n:
        raise ValueError(f"cache capacity {N} is not a multiple of block_n={block_n}")
    dev = q_c8.device
    _lib.check(content, "content", STORAGE[fmt], (B, N, d_c), dev)
    _lib.check(rope, "rope", torch.bfloat16, (B, N, d_r), dev)
    _lib.check(scale, "scale", torch.float32, (B, N), dev)
    if sink is not None:
        if q_len > 1:
            raise NotImplementedError("the verify mode (q_len > 1) takes no sink guard")
        _lib.check(sink, "sink", torch.float32, (B, sink.shape[1], d_c), dev)
    return _launch_decode(
        "single_pass_decode" if single_pass else "splitkv_decode", fmt, single_pass,
        rescale, q_c8, q_r, sigma_q, content, rope, scale, None, seq_lens, sink, B=B, H=H,
        d_c=d_c, d_r=d_r, block=block_n, P=N // block_n, num_splits=num_splits,
        softmax_scale=softmax_scale, q_len=q_len)


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


def amla_combine_cuda(acc_partial: torch.Tensor, l_partial: torch.Tensor,
                      g_partial: torch.Tensor):
    """#4: raw AMLA partials acc [B, S, H, d_c], l [B, S, H], g [B, S, H]
    (all f32) -> (o [B, H, d_c], lse [B, H])."""
    if _on_cpu(acc_partial, l_partial, g_partial):
        return R.amla_combine_ref(acc_partial, l_partial, g_partial)
    B, S, H, d_c = acc_partial.shape
    dev = acc_partial.device
    _lib.check(acc_partial, "acc_partial", torch.float32, (B, S, H, d_c), dev)
    _lib.check(l_partial, "l_partial", torch.float32, (B, S, H), dev)
    _lib.check(g_partial, "g_partial", torch.float32, (B, S, H), dev)
    o = torch.empty((B, H, d_c), dtype=torch.float32, device=dev)
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    _lib.launch("amla_combine", "snapmla_amla_combine", acc_partial.data_ptr(),
                l_partial.data_ptr(), g_partial.data_ptr(), o.data_ptr(), lse.data_ptr(),
                B, S, H, d_c)
    return o, lse


def combine_cuda(partials, rescale: str = "fma"):
    """Merge split partials with kernel C (FMA) or #4 (AMLA)."""
    o_p, lse_p, sp_p = partials
    if rescale == "amla":
        return amla_combine_cuda(o_p, lse_p, sp_p)
    return lse_combine_cuda(o_p, lse_p)


def mla_decode_paged_splitkv_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool,
                                  scale_pool, page_table, seq_lens, *,
                                  softmax_scale: float, num_splits: int,
                                  fmt: str = "fp8_e4m3",
                                  return_partials: bool = False, rescale: str = "fma"):
    """Paged split-KV SnapMLA decode (kernel A, then kernel C or #4). Returns
    (o [B, (q_len,) H, d_c] f32, lse [B, (q_len,) H]) — plus the partials
    when ``return_partials``."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        return R.snapmla_decode_paged_splitkv_ref(
            *args, softmax_scale=softmax_scale, num_splits=num_splits, fmt=fmt,
            return_partials=return_partials, rescale=rescale)
    qc, qr, sq, q_len, H = _flatten_q(q_c8, q_r, sigma_q)
    parts = paged_decode_partials_cuda(
        qc, qr, sq, *args[3:], softmax_scale=softmax_scale, num_splits=num_splits,
        fmt=fmt, single_pass=False, rescale=rescale, q_len=q_len or 1)
    o, lse = combine_cuda(parts, rescale)
    o, lse, parts = _unflatten_rows(q_len, H, o, lse, parts)
    return (o, lse, parts) if return_partials else (o, lse)


def mla_decode_paged_cuda(q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool,
                          page_table, seq_lens, *, softmax_scale: float,
                          fmt: str = "fp8_e4m3", rescale: str = "fma"):
    """Paged single-pass SnapMLA decode (kernel B, no early exit). Returns
    (o [B, H, d_c] f32, lse [B, H])."""
    args = (q_c8, q_r, sigma_q, content_pool, rope_pool, scale_pool, page_table,
            seq_lens)
    if _on_cpu(*args):
        return R.snapmla_decode_paged_ref(*args, softmax_scale=softmax_scale, fmt=fmt,
                                          rescale=rescale)
    o_p, lse_p, _ = paged_decode_partials_cuda(
        *args, softmax_scale=softmax_scale, num_splits=1, fmt=fmt, single_pass=True,
        rescale=rescale)
    return o_p[:, 0], lse_p[:, 0]


def mla_decode_splitkv_cuda(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, *,
                            softmax_scale: float, num_splits: int, block_n: int = 128,
                            fmt: str = "fp8_e4m3", return_partials: bool = False,
                            rescale: str = "fma", sink: torch.Tensor | None = None):
    """Contiguous split-KV SnapMLA decode (#2, then kernel C or #4). Returns
    (o [B, (q_len,) H, d_c] f32, lse [B, (q_len,) H]) — plus the partials
    when ``return_partials``."""
    if _on_cpu(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, sink):
        return R.snapmla_decode_splitkv_ref(
            q_c8, q_r, sigma_q, patch_sink_rows(content, scale, sink), rope.float(), scale,
            seq_lens, softmax_scale=softmax_scale, num_splits=num_splits, block_n=block_n,
            fmt=fmt, return_partials=return_partials, rescale=rescale)
    qc, qr, sq, q_len, H = _flatten_q(q_c8, q_r, sigma_q)
    parts = decode_partials_cuda(
        qc, qr, sq, content, rope, scale, seq_lens, softmax_scale=softmax_scale,
        block_n=block_n, num_splits=num_splits, fmt=fmt, single_pass=False,
        rescale=rescale, sink=sink, q_len=q_len or 1)
    o, lse = combine_cuda(parts, rescale)
    o, lse, parts = _unflatten_rows(q_len, H, o, lse, parts)
    return (o, lse, parts) if return_partials else (o, lse)


def mla_decode_cuda(q_c8, q_r, sigma_q, content, rope, scale, seq_lens, *,
                    softmax_scale: float, block_n: int = 128, fmt: str = "fp8_e4m3",
                    rescale: str = "fma", sink: torch.Tensor | None = None):
    """Contiguous single-pass SnapMLA decode (#1, no early exit). Returns
    (o [B, H, d_c] f32, lse [B, H])."""
    o_p, lse_p, _ = decode_partials_cuda(
        q_c8, q_r, sigma_q, content, rope, scale, seq_lens, softmax_scale=softmax_scale,
        block_n=block_n, num_splits=1, fmt=fmt, single_pass=True, rescale=rescale,
        sink=sink)
    return o_p[:, 0], lse_p[:, 0]
