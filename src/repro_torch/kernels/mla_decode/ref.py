"""Plain PyTorch versions of the SnapMLA FP8 decode pipeline (port of the
FMA, q_len = 1 half of ``repro/kernels/mla_decode/ref.py``).

These are the oracles of the CUDA kernels in ``kernel.py`` and the arithmetic
of the ``torch_paged_ref`` backend:

  * ``snapmla_decode_pipeline_ref`` — online softmax, per-token V-scale
    fusion, block-wise dynamic P quantization and implicit dequantization
    (paper §3.2.3, Eqs. 12-13), one KV block at a time;
  * ``snapmla_decode_splitkv_ref`` / ``snapmla_decode_paged_splitkv_ref`` —
    the split-KV form: the pipeline per split with the dead-block early exit,
    merged by ``lse_combine_ref``;
  * ``snapmla_decode_paged_ref`` — the single pass over the page table
    without early exit (the plain version of the single-pass kernel).

Two choices make kernel and plain version agree bit for bit on the card:

  * the QK logits are accumulated in float64 and rounded once to float32
    (``_qk_logits``). A product of two fp8 (or int8) values is exact and the
    float64 sum of ``d_c`` of them is exact in any order, so the content dot
    does not depend on summation order; the reference's float32 dot differs
    from it by a few ulp at most. This keeps P's fp8 rounding decisions —
    which a one-ulp change in a logit can flip — identical between the CUDA
    kernel and this version;
  * masking uses the kernel's finite ``NEG_INF`` sentinel
    (kernel.py:86) rather than the JAX ref's ``-inf``. Wherever the JAX ref
    is finite the two agree exactly; on an empty row without early exit
    this version gives the single-pass kernel's ``(NaN, -inf)``.

fp8 is widened to float32 before every product, as the Pallas body does.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant

NEG_INF = -1e30


def _qk_logits(q_c8: torch.Tensor, q_r: torch.Tensor, content: torch.Tensor,
               rope: torch.Tensor) -> torch.Tensor:
    """``q_c8·C + q_r·R`` for every (batch, head, token): [B, H, N] f32.

    Each dot is accumulated in float64 and rounded once to float32; the two
    rounded dots are then added in float32, as the reference's
    ``s = dot_c; s += dot_r`` does."""
    qc = q_c8.float().double()
    c = content.float().double()
    s_c = torch.matmul(qc, c.transpose(-1, -2)).float()
    s_r = torch.matmul(q_r.float().double(),
                       rope.float().double().transpose(-1, -2)).float()
    return s_c + s_r


def _quantize_p(p_fused: torch.Tensor, fmt: str):
    """Block-wise dynamic P quantization: (P8 as f32, sigma_p [B, H]);
    ``"none"`` keeps P unquantized with sigma_p = 1."""
    if fmt != "none":
        amax = torch.amax(torch.abs(p_fused), dim=-1)
        sp_new = quant.dynamic_scale(amax, quant.qmax_for(fmt))
        p8 = quant._cast(p_fused / sp_new[..., None], fmt).float()
        return p8, sp_new
    return p_fused, torch.ones(p_fused.shape[:-1], dtype=torch.float32,
                               device=p_fused.device)


def snapmla_decode_pipeline_ref(
    q_c8: torch.Tensor,     # [B, H, d_c] quantized content query (storage dtype)
    q_r: torch.Tensor,      # [B, H, d_r] rope query, PRE-DIVIDED by sigma_q
    sigma_q: torch.Tensor,  # [B, H]
    content: torch.Tensor,  # [B, N, d_c] quantized latent cache
    rope: torch.Tensor,     # [B, N, d_r] rope keys, PRE-DIVIDED by sigma_k
    sigma_k: torch.Tensor,  # [B, N]
    seq_lens: torch.Tensor,  # [B]
    *,
    softmax_scale: float,
    block_n: int = 128,
    fmt: str = "fp8_e4m3",
    return_sigma_p: bool = False,
    skip_dead_blocks: bool = False,
):
    """Returns (o [B, H, d_c] f32, lse [B, H] f32) — plus the final sigma_p
    [B, H] when ``return_sigma_p``. ``skip_dead_blocks`` freezes the carried
    state on blocks with no valid token (the split-KV kernel's early exit)."""
    B, H, d_c = q_c8.shape
    N = content.shape[1]
    if N % block_n:
        raise ValueError(f"cache length {N} is not a multiple of block_n={block_n}")
    dev = q_c8.device
    s_all = _qk_logits(q_c8, q_r, content, rope)
    s_all = s_all * (sigma_q.float()[:, :, None] * sigma_k.float()[:, None, :]) \
        * softmax_scale
    valid_all = (torch.arange(N, device=dev)[None, :]
                 < seq_lens.to(dev).long()[:, None])[:, None, :]   # [B, 1, N]
    s_all = torch.where(valid_all, s_all, NEG_INF)
    sk_all = sigma_k.float()[:, None, :]
    cf = content.float()

    m = torch.full((B, H), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H), dtype=torch.float32, device=dev)
    sp = torch.ones((B, H), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, d_c), dtype=torch.float32, device=dev)
    for j in range(N // block_n):
        blk = slice(j * block_n, (j + 1) * block_n)
        s, valid = s_all[..., blk], valid_all[..., blk]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        e = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        # Key Step 2: fuse the per-token V scale, block-wise dynamic quantization
        p8, sp_new = _quantize_p(e * sk_all[..., blk], fmt)
        corr = torch.exp(m - m_new) * (sp / sp_new)                  # Eq. 12/13
        l_new = l * corr + torch.sum(e, dim=-1) / sp_new
        acc_new = acc * corr[..., None] + torch.matmul(p8, cf[:, blk])
        if skip_dead_blocks:
            live = (j * block_n < seq_lens.to(dev).long())[:, None]  # [B, 1]
            m_new = torch.where(live, m_new, m)
            l_new = torch.where(live, l_new, l)
            sp_new = torch.where(live, sp_new, sp)
            acc_new = torch.where(live[..., None], acc_new, acc)
        m, l, sp, acc = m_new, l_new, sp_new, acc_new
    o = acc / l[..., None]                                          # sigma_p cancels
    lse = m + torch.log(sp * l)
    if return_sigma_p:
        return o, lse, sp
    return o, lse


def lse_combine_ref(o_partial: torch.Tensor, lse_partial: torch.Tensor):
    """Max-shift LSE combine of split-KV partials: o_partial [B, S, H, d_c],
    lse_partial [B, S, H] -> (o [B, H, d_c], lse [B, H])."""
    m_star = torch.amax(lse_partial, dim=1)                        # [B, H]
    w = torch.exp(lse_partial - m_star[:, None, :])                # [B, S, H]
    den = torch.sum(w, dim=1)
    num = torch.einsum("bsh,bshc->bhc", w, o_partial)
    return num / den[..., None], m_star + torch.log(den)


def _split_partials(decode_one_split, content, rope, sigma_k, seq_lens,
                    num_splits: int, block_n: int):
    """Cut the KV axis into ``num_splits`` slices of whole blocks (padding the
    tail slice), run ``decode_one_split`` per slice and neutralize empty
    slices with (o = 0, lse = NEG_INF, sigma_p = 1)."""
    N = content.shape[1]
    nblocks = N // block_n
    if not 1 <= num_splits <= nblocks:
        raise ValueError(f"num_splits={num_splits} outside [1, {nblocks}]")
    blocks_per_split = -(-nblocks // num_splits)
    split_tokens = blocks_per_split * block_n
    pad = num_splits * split_tokens - N
    if pad:
        content = torch.cat([content, torch.zeros(
            (content.shape[0], pad, content.shape[2]), dtype=content.dtype,
            device=content.device)], dim=1)
        rope = torch.cat([rope, torch.zeros(
            (rope.shape[0], pad, rope.shape[2]), dtype=rope.dtype,
            device=rope.device)], dim=1)
        sigma_k = torch.cat([sigma_k, torch.ones(
            (sigma_k.shape[0], pad), dtype=sigma_k.dtype, device=sigma_k.device)],
            dim=1)
    lens = seq_lens.to(content.device).long()
    o_parts, lse_parts, sp_parts = [], [], []
    for s in range(num_splits):
        lo = s * split_tokens
        local_len = torch.clamp(lens - lo, 0, split_tokens)
        o_s, lse_s, sp_s = decode_one_split(
            content[:, lo:lo + split_tokens], rope[:, lo:lo + split_tokens],
            sigma_k[:, lo:lo + split_tokens], local_len)
        empty = local_len <= 0
        lse_s = torch.nan_to_num(lse_s, nan=0.0, neginf=NEG_INF)
        o_parts.append(torch.where(empty[:, None, None], 0.0, o_s))
        lse_parts.append(torch.where(empty[:, None], NEG_INF, lse_s))
        sp_parts.append(torch.where(empty[:, None], 1.0, sp_s))
    return (torch.stack(o_parts, dim=1), torch.stack(lse_parts, dim=1),
            torch.stack(sp_parts, dim=1))


def snapmla_decode_splitkv_ref(q_c8, q_r, sigma_q, content, rope, sigma_k,
                               seq_lens, *, softmax_scale: float, num_splits: int,
                               block_n: int = 128, fmt: str = "fp8_e4m3",
                               return_partials: bool = False):
    """Split-KV oracle: each slice runs the pipeline with its local ragged
    length and the dead-block early exit, then ``lse_combine_ref`` merges
    the (o, lse, sigma_p) partials."""
    def one_split(c, r, sk, local_len):
        return snapmla_decode_pipeline_ref(
            q_c8, q_r, sigma_q, c, r, sk, local_len, softmax_scale=softmax_scale,
            block_n=block_n, fmt=fmt, return_sigma_p=True, skip_dead_blocks=True)

    o_p, lse_p, sp_p = _split_partials(one_split, content, rope, sigma_k,
                                       seq_lens, num_splits, block_n)
    o, lse = lse_combine_ref(o_p, lse_p)
    if return_partials:
        return o, lse, (o_p, lse_p, sp_p)
    return o, lse


def gather_paged_view(content_pool, rope_pool, scale_pool, page_table):
    """Contiguous [B, P*page, ...] view of a page pool through its page table."""
    idx = page_table.long()
    c, r, s = content_pool[idx], rope_pool[idx], scale_pool[idx]
    B, P, page = s.shape
    return (c.reshape(B, P * page, -1), r.reshape(B, P * page, -1),
            s.reshape(B, P * page))


def snapmla_decode_paged_splitkv_ref(q_c8, q_r, sigma_q, content_pool, rope_pool,
                                     scale_pool, page_table, seq_lens, *,
                                     softmax_scale: float, num_splits: int,
                                     fmt: str = "fp8_e4m3",
                                     return_partials: bool = False):
    """Paged split-KV oracle: page-table gather + the split-KV oracle at
    block_n == page (plain version of the paged split-KV kernel + combine)."""
    page = content_pool.shape[1]
    c, r, s = gather_paged_view(content_pool, rope_pool, scale_pool, page_table)
    return snapmla_decode_splitkv_ref(
        q_c8, q_r, sigma_q, c, r.float(), s, seq_lens, softmax_scale=softmax_scale,
        num_splits=num_splits, block_n=page, fmt=fmt,
        return_partials=return_partials)


def snapmla_decode_paged_ref(q_c8, q_r, sigma_q, content_pool, rope_pool,
                             scale_pool, page_table, seq_lens, *,
                             softmax_scale: float, fmt: str = "fp8_e4m3"):
    """Single pass over the whole page table with no early exit (plain version
    of the single-pass paged kernel, kernel.py:694): dead pages still run the
    sigma_p update with an all-masked block."""
    page = content_pool.shape[1]
    c, r, s = gather_paged_view(content_pool, rope_pool, scale_pool, page_table)
    return snapmla_decode_pipeline_ref(
        q_c8, q_r, sigma_q, c, r.float(), s, seq_lens, softmax_scale=softmax_scale,
        block_n=page, fmt=fmt)


def prepare_q(q_c: torch.Tensor, q_r: torch.Tensor, fmt: str = "fp8_e4m3"):
    """Fused-Q-Quant reference: q_c [B, H, d_c] f32, q_r [B, H, d_r] ->
    (q_c8, q_r_scaled, sigma_q [B, H])."""
    if fmt == "none":
        return (q_c.to(torch.bfloat16), q_r.float(),
                torch.ones(q_c.shape[:-1], dtype=torch.float32, device=q_c.device))
    raq = quant.quantize_rope_aware(q_c, q_r, fmt, rope_dtype=torch.float32)
    return raq.q_content, raq.rope_scaled, raq.scale[..., 0]
