"""SnapMLA paged decode dispatch (port of the paged half of
``repro/kernels/mla_decode/ops.py``).

``num_splits`` resolves by the context-length heuristic or an explicit count;
the port has no measured split profile (the reference's is a TPU timing).
``splits == 1`` takes the single-pass kernel, anything else the split-KV
kernel plus the LSE combine (ops.py:268-283).
"""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import PagedMLAPool
from repro_torch.kernels.mla_decode import kernel as _k
from repro_torch.kernels.mla_decode import ref as _ref

SPLIT_TARGET_TOKENS = 4096
MAX_SPLITS = 8


def default_num_splits(context_len: int, block_n: int = 128,
                       target_tokens: int = SPLIT_TARGET_TOKENS,
                       max_splits: int = MAX_SPLITS) -> int:
    """Short contexts (< 2 * target) stay single-pass; longer contexts get the
    largest power of two <= context/target, capped at ``max_splits`` and at
    the block count."""
    nblocks = max(1, -(-context_len // block_n))
    s = 1
    while s * 2 <= min(max_splits, context_len // target_tokens, nblocks):
        s *= 2
    return s


def resolve_num_splits(requested: int | None, capacity: int, block_n: int) -> int:
    """None/0 = the heuristic; a fixed count is clamped to the block count."""
    nblocks = max(1, capacity // block_n)
    splits = requested if requested else default_num_splits(capacity, block_n)
    return max(1, min(splits, nblocks))


def snapmla_decode_paged(q_c8: torch.Tensor, q_r: torch.Tensor,
                         sigma_q: torch.Tensor, pool: PagedMLAPool, *,
                         softmax_scale: float, fmt: str = "fp8_e4m3",
                         num_splits: int | None = None, use_kernel: bool = True):
    """Decode one token per sequence against a paged pool. Returns
    (o_latent [B, H, d_c] f32, lse [B, H])."""
    page = pool.page_size
    splits = resolve_num_splits(num_splits, pool.capacity, page)
    args = (q_c8, q_r.float(), sigma_q, pool.content, pool.rope, pool.scale,
            pool.page_table, pool.seq_lens)
    if use_kernel:
        if splits == 1:
            return _k.mla_decode_paged_cuda(*args, softmax_scale=softmax_scale,
                                            fmt=fmt)
        return _k.mla_decode_paged_splitkv_cuda(
            *args, softmax_scale=softmax_scale, num_splits=splits, fmt=fmt)
    return _ref.snapmla_decode_paged_splitkv_ref(
        *args, softmax_scale=softmax_scale, num_splits=splits, fmt=fmt)
