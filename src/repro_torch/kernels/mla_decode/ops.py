"""SnapMLA decode dispatch (port of ``repro/kernels/mla_decode/ops.py``).

``snapmla_decode`` consumes a contiguous ``MLACache``, ``snapmla_decode_paged``
a ``PagedMLAPool``. ``num_splits`` resolves by the context-length heuristic
or an explicit count; the port loads no split profile (the reference's is a
TPU timing), so ``resolve_split_config`` keeps the reference's heuristic and
fallback rules and drops its ``tuned_*`` lookups. ``splits == 1`` takes the
single-pass kernel, anything else the split-KV kernel plus the combine
(ops.py:195-211, 268-283). A rank-4 ``[B, q_len, H, .]`` query (the
speculative verify) always takes the split-KV kernel, even at one split: it
carries the per-row causal limit.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.kvcache import MLACache, PagedMLAPool, sink_patched_content
from repro_torch.kernels.mla_decode import kernel as _k
from repro_torch.kernels.mla_decode import ref as _ref

SPLIT_TARGET_TOKENS = 4096
MAX_SPLITS = 8
# contiguous-cache default KV block (a paged pool's block is its page)
DEFAULT_BLOCK_N = 128


class SplitConfig(NamedTuple):
    """A resolved split-KV plan (``repro/kernels/mla_decode/autotune.py``)."""

    num_splits: int
    block_n: int


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


def resolve_split_config(num_splits: int | None, block_n: int | None, capacity: int,
                         *, layout: str = "contiguous",
                         page_size: int | None = None) -> SplitConfig:
    """Joint (num_splits, block_n) resolution (ops.py:85-129 without the
    profile lookups): a paged pool's block is its page; an explicit
    ``block_n`` is kept; ``block_n`` None/0 takes 128 when it divides the
    capacity, else the largest of 64, 32, ..., 1 that does."""
    if layout == "paged":
        if page_size is None:
            raise ValueError("paged split resolution needs page_size "
                             "(block_n is structurally the physical page)")
        if block_n and block_n != page_size:
            raise ValueError(
                f"paged caches fix block_n to the page size ({page_size}); "
                f"got block_n={block_n} — repage the pool instead")
        return SplitConfig(resolve_num_splits(num_splits, capacity, page_size), page_size)
    if not block_n:
        block_n = DEFAULT_BLOCK_N if capacity % DEFAULT_BLOCK_N == 0 \
            else max(b for b in (64, 32, 16, 8, 4, 2, 1) if capacity % b == 0)
    return SplitConfig(resolve_num_splits(num_splits, capacity, block_n), block_n)


def _check_alignment(n: int, block_n: int) -> None:
    if n % block_n:
        raise ValueError(
            f"cache capacity {n} is not a multiple of block_n={block_n}; "
            "allocate caches with init_mla_cache (it rounds max_len up to the "
            "page size) so the decode kernel never re-pads the cache per step")


def snapmla_decode(q_c8: torch.Tensor, q_r: torch.Tensor, sigma_q: torch.Tensor,
                   cache: MLACache, *, softmax_scale: float, block_n: int = 128,
                   fmt: str = "fp8_e4m3", num_splits: int | None = None,
                   use_kernel: bool = True, rescale: str = "fma"):
    """Decode one token (rank-3 query) or a verify block (rank-4) per
    sequence against a contiguous cache. Returns (o_latent [B, (q_len,) H,
    d_c] f32, lse [B, (q_len,) H]). The sink guard's rows enter as
    ``sink / max(scale, tiny)``: the kernels substitute them row by row, the
    plain path reads ``sink_patched_content``."""
    N = cache.capacity
    _check_alignment(N, block_n)
    splits = resolve_num_splits(num_splits, N, block_n)
    q = (q_c8.contiguous(), q_r.float().contiguous(), sigma_q.contiguous())
    kw = dict(softmax_scale=softmax_scale, block_n=block_n, fmt=fmt, rescale=rescale)
    if use_kernel:
        args = q + (cache.content, cache.rope, cache.scale, cache.seq_lens)
        if splits == 1 and q_c8.dim() == 3:
            return _k.mla_decode_cuda(*args, sink=cache.sink, **kw)
        return _k.mla_decode_splitkv_cuda(*args, sink=cache.sink, num_splits=splits, **kw)
    args = q + (sink_patched_content(cache), cache.rope.float(), cache.scale,
                cache.seq_lens)
    if splits == 1 and q_c8.dim() == 3:
        return _ref.snapmla_decode_pipeline_ref(*args, **kw)
    return _ref.snapmla_decode_splitkv_ref(*args, num_splits=splits, **kw)


def snapmla_decode_paged(q_c8: torch.Tensor, q_r: torch.Tensor,
                         sigma_q: torch.Tensor, pool: PagedMLAPool, *,
                         softmax_scale: float, fmt: str = "fp8_e4m3",
                         num_splits: int | None = None, use_kernel: bool = True,
                         rescale: str = "fma"):
    """Decode one token (rank-3 query) or a verify block (rank-4) per
    sequence against a paged pool. Returns (o_latent [B, (q_len,) H, d_c]
    f32, lse [B, (q_len,) H])."""
    page = pool.page_size
    splits = resolve_num_splits(num_splits, pool.capacity, page)
    args = (q_c8.contiguous(), q_r.float().contiguous(), sigma_q.contiguous(),
            pool.content, pool.rope, pool.scale, pool.page_table, pool.seq_lens)
    kw = dict(softmax_scale=softmax_scale, fmt=fmt, rescale=rescale)
    if use_kernel:
        if splits == 1 and q_c8.dim() == 3:
            return _k.mla_decode_paged_cuda(*args, **kw)
        return _k.mla_decode_paged_splitkv_cuda(*args, num_splits=splits, **kw)
    return _ref.snapmla_decode_paged_splitkv_ref(*args, num_splits=splits, **kw)
