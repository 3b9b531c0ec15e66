"""Quantized KV caches (port of ``repro/core/kvcache.py``).

The GQA cache (``GQACache``): K and V per-token quantized per kv head
(post-RoPE), with per-slot absolute positions; a sliding-window layer keeps a
ring buffer of ``min(max_len, window)`` slots (rounded up to the page), the
token at position ``p`` in slot ``p % capacity``.

The MLA caches, in two layouts, as in the reference:

  * ``MLACache`` — the contiguous per-slot cache (the reference's default):
    content ``[B, N, d_c]`` in the storage format (fp8 / int8, or bf16 when
    ``fmt == "none"``), rope ``[B, N, d_r]`` bf16 pre-divided by the
    per-token content scale, scale ``[B, N]`` f32, ``seq_lens`` ``[B]`` int32,
    and the optional P-Cast sink guard shadow ``sink`` ``[B, S_k, d_c]`` f32
    (the first ``S_k`` tokens' raw latent);
  * ``PagedMLAPool`` — content ``[n_pages, page, d_c]``, rope
    ``[n_pages, page, d_r]``, scale ``[n_pages, page]``, page table ``[B, P]``
    int32 and ``seq_lens``; batch-owned, or the serving engine's shared pool
    (``init_paged_mla_cache(n_pages=...)``, ``pool_with_tables``,
    ``paged_mla_prefill_at``), and ``pool_read_page`` / ``pool_write_page``,
    the unit of the host tier's page moves.

Unlike the functional JAX caches, writes land IN PLACE in the cache tensors
(``index_put_`` / slice assignment) — a decode step does not copy the whole
cache; the returned cache carries the same storage and the new ``seq_lens``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.core import quant
from repro_torch.core.placement import index_put


@dataclasses.dataclass(frozen=True)
class CacheConfig:
    fmt: str = "fp8_e4m3"        # "fp8_e4m3" | "int8" | "none" (bf16 baseline)
    page_size: int = 128          # kernel KV-block granularity (§3.3.2: 128)
    window: int = 0               # >0: GQA ring buffer of this many tokens (SWA)
    # P-Cast sink guard: >0 keeps the first ``sink_tokens`` tokens' latent
    # content in full precision beside the quantized rows (``MLACache.sink``),
    # substituted at the decode boundary. Contiguous caches only.
    sink_tokens: int = 0

    @property
    def quantized(self) -> bool:
        return self.fmt != "none"

    def storage_dtype(self) -> torch.dtype:
        return quant.qdtype_for(self.fmt) if self.quantized else torch.bfloat16


def _round_up(n: int, m: int) -> int:
    return (n + m - 1) // m * m


def page_aligned_capacity(n_tokens: int, page_size: int) -> int:
    """Cache capacity for ``n_tokens`` tokens: rounded up to the page size."""
    return _round_up(max(int(n_tokens), 1), page_size)


class MLACache(NamedTuple):
    """Contiguous per-slot MLA latent cache."""

    content: torch.Tensor     # [B, N, d_c] storage dtype
    rope: torch.Tensor        # [B, N, d_r] bf16, pre-divided by ``scale``
    scale: torch.Tensor       # [B, N] f32 per-token content scale (ones if none)
    seq_lens: torch.Tensor    # [B] int32 valid tokens
    sink: torch.Tensor | None = None  # [B, S_k, d_c] f32 raw latent of the first S_k tokens

    @property
    def capacity(self) -> int:
        return self.content.shape[1]

    @property
    def sink_tokens(self) -> int:
        return 0 if self.sink is None else self.sink.shape[1]


def patch_sink_rows(content: torch.Tensor, scale: torch.Tensor,
                    sink: torch.Tensor | None) -> torch.Tensor:
    """``content`` with rows ``< S_k`` replaced by ``sink / max(scale, tiny)``
    as float32 (the whole tensor widened to float32); ``content`` itself
    when ``sink`` is None. Downstream the pipeline multiplies content by
    ``scale``, so the guarded rows reconstruct the raw latent."""
    if sink is None:
        return content
    S_k = sink.shape[1]
    tiny = torch.finfo(torch.float32).tiny
    out = content.float().clone()
    out[:, :S_k] = sink / torch.clamp(scale[:, :S_k, None], min=tiny)
    return out


def sink_patched_content(cache: MLACache) -> torch.Tensor:
    """The content the decode pipeline reads: the sink guard's rows in full
    precision, every other row as stored (kvcache.py:94). The CUDA kernels
    substitute the same values row by row instead of copying the cache."""
    return patch_sink_rows(cache.content, cache.scale, cache.sink)


def init_mla_cache(cfg: CacheConfig, batch: int, max_len: int, d_c: int, d_r: int,
                   device=None) -> MLACache:
    """Contiguous cache with capacity rounded up to the page size (the decode
    kernels need a block-aligned capacity) and ``S_k = min(sink_tokens, N)``
    sink rows."""
    n = page_aligned_capacity(max_len, cfg.page_size)
    S_k = min(cfg.sink_tokens, n)
    return MLACache(
        content=torch.zeros((batch, n, d_c), dtype=cfg.storage_dtype(), device=device),
        rope=torch.zeros((batch, n, d_r), dtype=torch.bfloat16, device=device),
        scale=torch.ones((batch, n), dtype=torch.float32, device=device),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
        sink=(torch.zeros((batch, S_k, d_c), dtype=torch.float32, device=device)
              if S_k > 0 else None),
    )


def mla_append(cache: MLACache, cfg: CacheConfig, c_kv: torch.Tensor,
               k_r: torch.Tensor, active: torch.Tensor | None = None) -> MLACache:
    """Append one token per sequence at row ``seq_lens[b]`` (in place).

    c_kv [B, d_c], k_r [B, d_r]. The row index is clamped to the last row,
    as the reference's ``dynamic_update_slice`` clamps it. ``active`` [B]
    bool gates the append per row: inactive rows rewrite their current row
    with its old value and keep ``seq_lens`` frozen."""
    B = c_kv.shape[0]
    content, rope, scale = mla_quantize_entry(cfg, c_kv, k_r)
    idx = cache.seq_lens.long()
    row = torch.clamp(idx, 0, cache.capacity - 1)
    rows = torch.arange(B, device=c_kv.device)
    content = content.to(cache.content.dtype)
    rope = rope.to(torch.bfloat16)
    if active is not None:
        content = _where_rows(active, content, cache.content[rows, row])
        rope = _where_rows(active, rope, cache.rope[rows, row])
        scale = torch.where(active, scale, cache.scale[rows, row])
    index_put("mla_append", cache.content, (rows, row), content)
    index_put("mla_append", cache.rope, (rows, row), rope)
    index_put("mla_append", cache.scale, (rows, row), scale.float())
    step = 1 if active is None else active.to(cache.seq_lens.dtype)
    return cache._replace(seq_lens=cache.seq_lens + step,
                          sink=sink_append(cache, c_kv, idx, active))


def sink_append(cache: MLACache, c_kv: torch.Tensor, idx: torch.Tensor,
                active: torch.Tensor | None) -> torch.Tensor | None:
    """Shadow-write the raw latent row into the sink guard (in place) where
    the append position lands inside the guarded prefix (``idx < S_k``, and
    ``active``); shared by ``mla_append`` and ``fused_k_append``."""
    if cache.sink is None:
        return None
    S_k = cache.sink.shape[1]
    ok = idx < S_k
    if active is not None:
        ok = ok & active
    rows = torch.arange(c_kv.shape[0], device=c_kv.device)
    i = torch.clamp(idx, max=S_k - 1)
    index_put("sink_append", cache.sink, (rows, i),
              torch.where(ok[:, None], c_kv.float(), cache.sink[rows, i]))
    return cache.sink


def mla_prefill(cache: MLACache, cfg: CacheConfig, c_kv: torch.Tensor,
                k_r: torch.Tensor) -> MLACache:
    """Bulk-write a prefix: c_kv [B, S, d_c], k_r [B, S, d_r] at positions
    [0, S) (in place)."""
    content, rope, scale = mla_quantize_entry(cfg, c_kv, k_r)
    S = c_kv.shape[1]
    cache.content[:, :S] = content.to(cache.content.dtype)
    cache.rope[:, :S] = rope.to(torch.bfloat16)
    cache.scale[:, :S] = scale.float()
    if cache.sink is not None:
        W = min(S, cache.sink.shape[1])
        cache.sink[:, :W] = c_kv[:, :W].float()
    return cache._replace(seq_lens=torch.full_like(cache.seq_lens, S))


class GQACache(NamedTuple):
    """Per-slot GQA cache; a sliding-window layer's is a ring buffer."""

    k: torch.Tensor           # [B, N, Hkv, dh] storage dtype
    v: torch.Tensor           # [B, N, Hkv, dh]
    k_scale: torch.Tensor     # [B, N, Hkv] f32 (ones if none)
    v_scale: torch.Tensor     # [B, N, Hkv] f32
    slot_pos: torch.Tensor    # [B, N] int32 absolute position in the slot, -1 = empty
    seq_lens: torch.Tensor    # [B] int32 tokens seen (not capped by the window)

    @property
    def capacity(self) -> int:
        return self.k.shape[1]


def init_gqa_cache(cfg: CacheConfig, batch: int, max_len: int, n_kv: int, d_h: int,
                   device=None) -> GQACache:
    """Capacity ``min(max_len, window)`` (``max_len`` without a window),
    rounded up to the page size."""
    cap = min(max_len, cfg.window) if cfg.window else max_len
    cap = _round_up(cap, cfg.page_size)
    return GQACache(
        k=torch.zeros((batch, cap, n_kv, d_h), dtype=cfg.storage_dtype(), device=device),
        v=torch.zeros((batch, cap, n_kv, d_h), dtype=cfg.storage_dtype(), device=device),
        k_scale=torch.ones((batch, cap, n_kv), dtype=torch.float32, device=device),
        v_scale=torch.ones((batch, cap, n_kv), dtype=torch.float32, device=device),
        slot_pos=torch.full((batch, cap), -1, dtype=torch.int32, device=device),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def gqa_quantize_entry(cfg: CacheConfig, k: torch.Tensor, v: torch.Tensor):
    """k, v [..., Hkv, dh] -> (k storage, v storage, k scales, v scales
    [..., Hkv]); bf16 storage and unit scales when ``fmt == "none"``."""
    if not cfg.quantized:
        ones = torch.ones(k.shape[:-1], dtype=torch.float32, device=k.device)
        return k.to(torch.bfloat16), v.to(torch.bfloat16), ones, ones
    qk = quant.quantize_per_token(k, cfg.fmt)
    qv = quant.quantize_per_token(v, cfg.fmt)
    return qk.q, qv.q, qk.scale[..., 0], qv.scale[..., 0]


def gqa_append(cache: GQACache, cfg: CacheConfig, k: torch.Tensor, v: torch.Tensor,
               active: torch.Tensor | None = None) -> GQACache:
    """Append one token per sequence (in place): k, v [B, Hkv, dh] (RoPE
    applied) land in slot ``seq_lens % capacity`` of a ring buffer, else in
    slot ``seq_lens`` clamped to the last slot (as the reference's
    ``dynamic_update_slice`` clamps it); the slot records the absolute
    position. ``active`` [B] bool gates the append per row: inactive rows
    rewrite their slot with its old value and keep ``seq_lens`` frozen."""
    B = k.shape[0]
    kq, vq, ks, vs = gqa_quantize_entry(cfg, k, v)
    pos = cache.seq_lens.long()
    slot = pos % cache.capacity if cfg.window else torch.clamp(pos, 0, cache.capacity - 1)
    rows = torch.arange(B, device=k.device)
    kq, vq = kq.to(cache.k.dtype), vq.to(cache.v.dtype)
    sp = cache.seq_lens.to(torch.int32)
    if active is not None:
        kq = _where_rows(active, kq, cache.k[rows, slot])
        vq = _where_rows(active, vq, cache.v[rows, slot])
        ks = _where_rows(active, ks, cache.k_scale[rows, slot])
        vs = _where_rows(active, vs, cache.v_scale[rows, slot])
        sp = torch.where(active, sp, cache.slot_pos[rows, slot])
    index_put("gqa_append", cache.k, (rows, slot), kq)
    index_put("gqa_append", cache.v, (rows, slot), vq)
    index_put("gqa_append", cache.k_scale, (rows, slot), ks.float())
    index_put("gqa_append", cache.v_scale, (rows, slot), vs.float())
    index_put("gqa_append", cache.slot_pos, (rows, slot), sp)
    step = 1 if active is None else active.to(cache.seq_lens.dtype)
    return cache._replace(seq_lens=cache.seq_lens + step)


def gqa_prefill(cache: GQACache, cfg: CacheConfig, k: torch.Tensor,
                v: torch.Tensor) -> GQACache:
    """Bulk-write a prefix (in place): k, v [B, S, Hkv, dh] at positions
    [0, S). With a window only the last ``capacity`` tokens are kept, at
    slot ``pos % capacity``; without one, positions past the capacity are
    dropped, as the reference's scatter drops them."""
    B, S = k.shape[:2]
    cap = cache.capacity
    kq, vq, ks, vs = gqa_quantize_entry(cfg, k, v)
    positions = torch.arange(S, dtype=torch.int32, device=k.device)
    keep = slice(S - cap, S) if cfg.window and S > cap else slice(0, min(S, cap))
    kq, vq, ks, vs = kq[:, keep], vq[:, keep], ks[:, keep], vs[:, keep]
    positions = positions[keep]
    slots = (positions % cap if cfg.window else positions).long()
    every = slice(None)
    index_put("gqa_prefill", cache.k, (every, slots), kq.to(cache.k.dtype))
    index_put("gqa_prefill", cache.v, (every, slots), vq.to(cache.v.dtype))
    index_put("gqa_prefill", cache.k_scale, (every, slots), ks.float())
    index_put("gqa_prefill", cache.v_scale, (every, slots), vs.float())
    index_put("gqa_prefill", cache.slot_pos, (every, slots), positions.expand(B, -1))
    return cache._replace(seq_lens=torch.full_like(cache.seq_lens, S))


class PagedMLAPool(NamedTuple):
    """Global page pool addressed through a per-slot page table."""

    content: torch.Tensor     # [n_pages, page_size, d_c]
    rope: torch.Tensor        # [n_pages, page_size, d_r] bf16
    scale: torch.Tensor       # [n_pages, page_size] f32
    page_table: torch.Tensor  # [B, max_pages] int32
    seq_lens: torch.Tensor    # [B] int32

    @property
    def page_size(self) -> int:
        return self.content.shape[1]

    @property
    def capacity(self) -> int:
        """Per-sequence token capacity (the page-table span)."""
        return self.page_table.shape[1] * self.page_size


def init_paged_mla_pool(cfg: CacheConfig, n_pages: int, max_pages_per_seq: int,
                        batch: int, d_c: int, d_r: int, device=None) -> PagedMLAPool:
    return PagedMLAPool(
        content=torch.zeros((n_pages, cfg.page_size, d_c), dtype=cfg.storage_dtype(),
                            device=device),
        rope=torch.zeros((n_pages, cfg.page_size, d_r), dtype=torch.bfloat16,
                         device=device),
        scale=torch.ones((n_pages, cfg.page_size), dtype=torch.float32, device=device),
        page_table=torch.zeros((batch, max_pages_per_seq), dtype=torch.int32,
                               device=device),
        seq_lens=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def init_paged_mla_cache(cfg: CacheConfig, batch: int, max_len: int, d_c: int,
                         d_r: int, device=None, n_pages: int = 0) -> PagedMLAPool:
    """``n_pages == 0``: the batch-owned layout, row b owns pages
    [b*P, (b+1)*P). ``n_pages > 0``: the serving engine's shared multi-tenant
    pool of ``n_pages`` pages with an all-zero page table (every entry on
    the scratch page 0) and zero ``seq_lens``; the engine's allocator writes
    the rows (kvcache.py:379-401)."""
    n = page_aligned_capacity(max_len, cfg.page_size)
    pages_per_seq = n // cfg.page_size
    if n_pages:
        return init_paged_mla_pool(cfg, n_pages, pages_per_seq, batch, d_c, d_r, device)
    pool = init_paged_mla_pool(cfg, batch * pages_per_seq, pages_per_seq, batch,
                               d_c, d_r, device)
    table = torch.arange(batch * pages_per_seq, dtype=torch.int32,
                         device=device).reshape(batch, pages_per_seq)
    return pool._replace(page_table=table)


def pool_with_tables(pool: PagedMLAPool, table, seq_lens) -> PagedMLAPool:
    """The pool with a host-owned page table [B, P] and ``seq_lens`` [B]
    (numpy or tensors) in place of its own — how the serving engine pushes
    its slot assignments into the decode state each step. The page data is
    shared, not copied."""
    dev = pool.content.device
    return pool._replace(
        page_table=torch.as_tensor(table, dtype=torch.int32).to(dev),
        seq_lens=torch.as_tensor(seq_lens, dtype=torch.int32).to(dev))


def pool_read_page(pool: PagedMLAPool, page_id: int):
    """One physical page's payload ``(content, rope, scale)`` — the unit the
    serving engine's host tier offloads (kvcache.py:420-431). Views into the
    pool, not copies: the tier copies them out."""
    return pool.content[page_id], pool.rope[page_id], pool.scale[page_id]


def pool_write_page(pool: PagedMLAPool, page_id: int, payload) -> PagedMLAPool:
    """Write ``(content, rope, scale)`` (shapes from ``pool_read_page``, on
    any device) into physical page ``page_id`` in place — the host-tier
    restore (kvcache.py:434-452). The bytes are copied as they are, so a
    restored page is byte-identical to the page that was offloaded. A host
    source is copied without blocking; the caller keeps it alive until the
    copy is done."""
    for dst, src in zip((pool.content, pool.rope, pool.scale), payload):
        dst[page_id].copy_(src, non_blocking=True)
    return pool


def mla_quantize_entry(cfg: CacheConfig, c_kv: torch.Tensor, k_r: torch.Tensor):
    """c_kv [..., d_c], k_r [..., d_r] -> (content_store, rope_store, scale[...])."""
    if not cfg.quantized:
        ones = torch.ones(c_kv.shape[:-1], dtype=torch.float32, device=c_kv.device)
        return c_kv.to(torch.bfloat16), k_r.to(torch.bfloat16), ones
    raq = quant.quantize_rope_aware(c_kv, k_r, cfg.fmt)
    return raq.q_content, raq.rope_scaled, raq.scale[..., 0]


def paged_gather(pool: PagedMLAPool):
    """Contiguous view [B, max_pages*page, ...] (reference only)."""
    c = pool.content[pool.page_table.long()]
    r = pool.rope[pool.page_table.long()]
    s = pool.scale[pool.page_table.long()]
    B, P, page, d_c = c.shape
    return c.reshape(B, P * page, d_c), r.reshape(B, P * page, -1), s.reshape(B, P * page)


def _write(pool: PagedMLAPool, pids, offs, content, rope, scale) -> None:
    pool.content.index_put_((pids, offs), content.to(pool.content.dtype))
    pool.rope.index_put_((pids, offs), rope.to(torch.bfloat16))
    pool.scale.index_put_((pids, offs), scale.float())


def paged_mla_prefill(pool: PagedMLAPool, cfg: CacheConfig, c_kv: torch.Tensor,
                      k_r: torch.Tensor) -> PagedMLAPool:
    """Bulk-write a prefix through the page table: c_kv [B, S, d_c],
    k_r [B, S, d_r] land in page ``page_table[b, t // page]`` at slot
    ``t % page`` (in place)."""
    B, S = c_kv.shape[:2]
    page = pool.page_size
    content, rope, scale = mla_quantize_entry(cfg, c_kv, k_r)
    t = torch.arange(S, device=c_kv.device)
    pids = pool.page_table[:, t // page].long()                # [B, S]
    offs = (t % page).expand(B, S)
    _write(pool, pids, offs, content, rope, scale)
    return pool._replace(seq_lens=torch.full_like(pool.seq_lens, S))


def paged_mla_append(pool: PagedMLAPool, cfg: CacheConfig, c_kv: torch.Tensor,
                     k_r: torch.Tensor, active: torch.Tensor | None = None
                     ) -> PagedMLAPool:
    """Append one token per sequence into its current page (in place).

    Writes past capacity are clamped to the FINAL slot (kvcache.py:479-491).
    ``active`` [B] bool gates the append per row: inactive rows rewrite their
    current slot with its old value and keep ``seq_lens`` frozen."""
    B = c_kv.shape[0]
    page = pool.page_size
    content, rope, scale = mla_quantize_entry(cfg, c_kv, k_r)
    t = torch.clamp(pool.seq_lens, max=pool.capacity - 1).long()
    rows = torch.arange(B, device=c_kv.device)
    pid = pool.page_table[rows, t // page].long()             # [B]
    off = t % page
    if active is not None:
        content = _where_rows(active, content, pool.content[pid, off])
        rope = _where_rows(active, rope.to(torch.bfloat16), pool.rope[pid, off])
        scale = torch.where(active, scale, pool.scale[pid, off])
    _write(pool, pid, off, content, rope, scale)
    step = 1 if active is None else active.to(pool.seq_lens.dtype)
    return pool._replace(seq_lens=pool.seq_lens + step)


def paged_mla_prefill_at(pool: PagedMLAPool, cfg: CacheConfig, c_kv: torch.Tensor,
                         k_r: torch.Tensor, start: torch.Tensor,
                         valid: torch.Tensor) -> PagedMLAPool:
    """Write a chunk through the page table at positions ``start + t`` (in
    place): c_kv [B, C, d_c], k_r [B, C, d_r], ``start`` [B], ``valid``
    [B, C] bool. Padded positions (``~valid``) and positions at or past the
    table span go to the scratch page 0, which is never read back
    (kvcache.py:508-539); ``seq_lens`` becomes ``start + sum(valid)``.

    Several rows may land on page 0; which one's bytes stay there is
    unspecified, as in the reference's scatter, and nothing reads them."""
    B, C = c_kv.shape[:2]
    page = pool.page_size
    P = pool.page_table.shape[-1]
    content, rope, scale = mla_quantize_entry(cfg, c_kv, k_r)
    dev = c_kv.device
    t = start.to(dev).long()[:, None] + torch.arange(C, device=dev)[None, :]   # [B, C]
    logical = torch.clamp(t // page, 0, P - 1)
    pids = torch.gather(pool.page_table.long(), 1, logical)
    pids = torch.where(valid & (t // page < P), pids, 0)
    _write(pool, pids, t % page, content, rope, scale)
    lens = start.to(dev).to(pool.seq_lens.dtype) + valid.sum(dim=1).to(pool.seq_lens.dtype)
    return pool._replace(seq_lens=lens)


def _where_rows(active: torch.Tensor, new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Row select (``active`` [B] against [B, ...] rows) that also works for
    fp8 tensors (``torch.where`` has no float8 kernel): pick on the raw bytes."""
    mask = active.reshape(active.shape + (1,) * (new.dim() - 1))
    if new.dtype == torch.float8_e4m3fn:
        picked = torch.where(mask, new.view(torch.uint8), old.view(torch.uint8))
        return picked.view(torch.float8_e4m3fn)
    return torch.where(mask, new.to(old.dtype), old)
