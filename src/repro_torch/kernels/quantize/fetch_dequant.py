"""Fused fetch + dequantise of the FP8 latent cache, and the attentions that
read it (port of ``repro/kernels/quantize/fetch_dequant.py``, paper §3.3.1).

  * ``paged_fetch_dequant`` — gathers pages through the page table and
    dequantises them into each row's logical order, ``[B, P*page, d_c + d_r]``
    bf16 (content·σ | rope·σ). With ``chunk_start`` only pages holding
    positions below ``chunk_start[b]`` are read; the others come back zero.
    On CUDA tensors it launches the hand-written kernel
    (``csrc/fetch_dequant.cu``), which replaces ``paged_fetch_dequant_pallas``;
  * ``fetch_dequant`` — the same over a contiguous ``MLACache`` (the kernel's
    contiguous mode), which replaces ``fetch_dequant_pallas``;
  * ``fetch_dequant_ref`` / ``paged_fetch_dequant_ref`` — their plain
    versions, which the wrappers run on CPU tensors;
  * ``paged_chunked_prefill_attention``, ``paged_verify_attention`` and
    ``chunked_prefill_attention`` — a prompt chunk (or a draft block)
    attending [quantized prefix] + [itself] through one softmax. Their
    einsums and softmax are plain PyTorch, as the reference computes them
    outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.core.kvcache import MLACache, PagedMLAPool
from repro_torch.kernels import _lib

FMT_CODES = {torch.float8_e4m3fn: 0, torch.int8: 1, torch.bfloat16: 2}


def _dequant(content: torch.Tensor, rope: torch.Tensor, scale: torch.Tensor,
             out_dtype=torch.bfloat16) -> torch.Tensor:
    """content [..., d_c], rope [..., d_r], scale [...] -> [..., d_c + d_r]:
    one float32 product per value, then the cast."""
    s = scale.float()[..., None]
    return torch.cat([content.float() * s, rope.float() * s], dim=-1).to(out_dtype)


def fetch_dequant_ref(cache: MLACache, out_dtype=torch.bfloat16) -> torch.Tensor:
    """Plain version of the contiguous fetch: [B, N, d_c + d_r]."""
    return _dequant(cache.content, cache.rope, cache.scale, out_dtype)


def paged_fetch_dequant_ref(pool: PagedMLAPool, out_dtype=torch.bfloat16,
                            chunk_start: torch.Tensor | None = None) -> torch.Tensor:
    """Plain version of the paged fetch: the page-table gather, dequantised,
    laid out [B, P*page, d_c + d_r]; with ``chunk_start`` the pages wholly at
    or past it are zero (a straddling page is fetched whole)."""
    idx = pool.page_table.long()
    kv = _dequant(pool.content[idx], pool.rope[idx], pool.scale[idx], torch.float32)
    B, P, page, d = kv.shape
    if chunk_start is not None:
        live = (torch.arange(P, device=kv.device)[None, :] * page
                < chunk_start.to(kv.device).long()[:, None])           # [B, P]
        kv = torch.where(live[:, :, None, None], kv, 0.0)
    return kv.reshape(B, P * page, d).to(out_dtype)


def _launch(kernel: str, content, rope, scale, page_table, chunk_start, *, B, P, page):
    d_c, d_r = content.shape[-1], rope.shape[-1]
    dev = content.device
    if content.dtype not in FMT_CODES:
        raise ValueError(f"content dtype {content.dtype} is not a cache format")
    if d_c % 16 or d_r % 8:
        raise ValueError(f"the fetch kernel takes d_c % 16 == 0 and d_r % 8 == 0 "
                         f"(got {d_c}, {d_r})")
    _lib.check(content, "content", content.dtype, tuple(content.shape), dev)
    _lib.check(rope, "rope", torch.bfloat16, tuple(content.shape[:-1]) + (d_r,), dev)
    _lib.check(scale, "scale", torch.float32, tuple(content.shape[:-1]), dev)
    if page_table is not None:
        _lib.check(page_table, "page_table", torch.int32, (B, P), dev)
    if chunk_start is not None:
        _lib.check(chunk_start, "chunk_start", torch.int32, (B,), dev)
    for t in (content, rope):
        if t.data_ptr() % 16:
            raise ValueError("the fetch kernel needs 16-byte aligned content and rope")
    out = torch.empty((B, P * page, d_c + d_r), dtype=torch.bfloat16, device=dev)
    _lib.launch(kernel, "snapmla_fetch_dequant", FMT_CODES[content.dtype],
                content.data_ptr(), rope.data_ptr(), scale.data_ptr(),
                None if page_table is None else page_table.data_ptr(),
                None if chunk_start is None else chunk_start.data_ptr(),
                out.data_ptr(), B, P, page, d_c, d_r)
    return out


def paged_fetch_dequant(pool: PagedMLAPool, *, chunk_start: torch.Tensor | None = None
                        ) -> torch.Tensor:
    """The paged fetch: the plain version on CPU tensors, the kernel (one
    launch) on CUDA tensors. Returns bf16 [B, P*page, d_c + d_r]."""
    if pool.content.device.type == "cpu":
        return paged_fetch_dequant_ref(pool, chunk_start=chunk_start)
    B, P = pool.page_table.shape
    cs = None if chunk_start is None else chunk_start.to(torch.int32).contiguous()
    return _launch("paged_fetch_dequant", pool.content, pool.rope, pool.scale,
                   pool.page_table, cs, B=B, P=P, page=pool.page_size)


def fetch_dequant(cache: MLACache, *, page: int = 128) -> torch.Tensor:
    """The contiguous fetch (``page`` tokens per kernel block; the result does
    not depend on it): the plain version on CPU tensors, the kernel on CUDA
    tensors. Returns bf16 [B, N, d_c + d_r]."""
    if cache.content.device.type == "cpu":
        return fetch_dequant_ref(cache)
    B, N, _ = cache.content.shape
    if N % page:
        raise ValueError(f"cache capacity {N} is not a multiple of page={page}")
    return _launch("fetch_dequant", cache.content, cache.rope, cache.scale, None, None,
                   B=B, P=N // page, page=page)


def paged_chunked_prefill_attention(
    q_lat: torch.Tensor,        # [B, C, H, d_c] absorbed queries of the chunk
    q_rope: torch.Tensor,       # [B, C, H, d_r]
    pool: PagedMLAPool,         # quantized prefix pages
    chunk_c_kv: torch.Tensor,   # [B, C, d_c] the chunk's latents (full precision)
    chunk_k_r: torch.Tensor,    # [B, C, d_r] the chunk's rope keys
    chunk_start: torch.Tensor,  # [B] first absolute position of the chunk
    valid: torch.Tensor,        # [B, C] False on the padded tail of a bucket
    *,
    softmax_scale: float,
    use_kernel: bool = False,
) -> torch.Tensor:
    """Attend a prompt chunk against [quantized paged prefix] + [itself]
    through one softmax (fetch_dequant.py:191-247): the prefix pages below
    ``chunk_start`` are read back by the bounded fetch, the chunk's own keys
    take part at full precision, causal within the chunk with the padded
    keys masked. Returns o_latent [B, C, H, d_c] f32."""
    B, C, H, d_c = q_lat.shape
    kv = (paged_fetch_dequant(pool, chunk_start=chunk_start) if use_kernel
          else paged_fetch_dequant_ref(pool, chunk_start=chunk_start)).float()
    dev = kv.device
    q = torch.cat([q_lat, q_rope], dim=-1).float()
    n = kv.shape[1]
    s_pre = torch.einsum("bchd,bnd->bchn", q, kv) * softmax_scale
    pre_ok = torch.arange(n, device=dev)[None, :] < chunk_start.to(dev).long()[:, None]
    s_pre = torch.where(pre_ok[:, None, None, :], s_pre, float("-inf"))
    k_chunk = torch.cat([chunk_c_kv, chunk_k_r], dim=-1).float()
    s_chk = torch.einsum("bchd,bkd->bchk", q, k_chunk) * softmax_scale
    ar = torch.arange(C, device=dev)
    chk_ok = (ar[:, None] >= ar[None, :])[None] & valid[:, None, :]       # [B, C, C]
    s_chk = torch.where(chk_ok[:, :, None, :], s_chk, float("-inf"))
    p = torch.softmax(torch.cat([s_pre, s_chk], dim=-1), dim=-1)
    o = torch.einsum("bchn,bnd->bchd", p[..., :n], kv[..., :d_c])
    return o + torch.einsum("bchk,bkd->bchd", p[..., n:], chunk_c_kv.float())


def paged_verify_attention(q_lat, q_rope, pool: PagedMLAPool, draft_c_kv, draft_k_r,
                           start, *, softmax_scale: float, use_kernel: bool = False):
    """Verify attention as the chunked-prefill shape: [FP8 prefix] + [the
    draft block at full precision], one softmax (fetch_dequant.py:250-279).
    Returns o_latent [B, K, H, d_c] f32."""
    valid = torch.ones(draft_c_kv.shape[:2], dtype=torch.bool, device=draft_c_kv.device)
    return paged_chunked_prefill_attention(
        q_lat, q_rope, pool, draft_c_kv, draft_k_r, start, valid,
        softmax_scale=softmax_scale, use_kernel=use_kernel)


def chunked_prefill_attention(q_lat, q_rope, cache: MLACache, chunk_start: int, *,
                              softmax_scale: float, page: int = 128,
                              use_kernel: bool = True) -> torch.Tensor:
    """Attend a prompt chunk against [quantized contiguous prefix] (tokens
    below ``seq_lens``) causally (fetch_dequant.py:282-311); fully masked
    rows give 0. Returns o_latent [B, C, H, d_c] f32."""
    B, C, H, d_c = q_lat.shape
    kv = (fetch_dequant(cache, page=page) if use_kernel
          else fetch_dequant_ref(cache)).float()
    dev = kv.device
    q = torch.cat([q_lat, q_rope], dim=-1).float()
    s = torch.einsum("bchd,bnd->bchn", q, kv) * softmax_scale
    n = kv.shape[1]
    qpos = torch.as_tensor(chunk_start, device=dev) + torch.arange(C, device=dev)   # [C]
    ar = torch.arange(n, device=dev)
    valid = ((ar[None, :] < cache.seq_lens.to(dev).long()[:, None])[:, None, :]
             & (ar[None, None, :] <= qpos[None, :, None]))
    s = torch.where(valid[:, :, None, :], s, float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.where(torch.isnan(p), 0.0, p)
    return torch.einsum("bchn,bnd->bchd", p, kv[..., :d_c])
