"""Plain PyTorch versions of the SnapMLA FP8 decode pipeline (port of
``repro/kernels/mla_decode/ref.py``).

The pipeline forms are the oracles of the CUDA kernels in ``kernel.py``:

  * ``snapmla_decode_pipeline_ref`` — online softmax, per-token V-scale
    fusion, block-wise dynamic P quantization and implicit dequantization
    (paper §3.2.3, Eqs. 12-13), one KV block at a time, with the FMA or the
    AMLA (power-of-two, ``amla.py``) rescale;
  * ``snapmla_decode_splitkv_ref`` / ``snapmla_decode_paged_splitkv_ref`` —
    the split-KV form: the pipeline per split with the dead-block early exit,
    merged by ``lse_combine_ref`` (FMA) or ``amla_combine_ref`` (AMLA);
  * ``snapmla_decode_paged_ref`` — the single pass over the page table
    without early exit (the plain version of the single-pass kernel);
  * a rank-4 ``[B, q_len, H, .]`` query block (the speculative verify) runs
    through ``_verify_rows``: row t is the q_len = 1 version at its own limit
    ``seq_lens - (q_len - 1) + t``. This is the q_len > 1 kernel's plain
    version exactly: each row's state is independent of every other row's,
    and a row with no valid token in a live block keeps its state (the row
    guard), as the q_len = 1 kernel skips that block. The split forms take
    rank-4 queries, at any number of splits (a rank-4 query always takes
    the split-KV kernel). Rows whose limit is <= 0 give (0, NEG_INF + log S)
    here and in the kernels, where the JAX oracles give NaN.

Two choices make kernel and plain version agree bit for bit on the card:

  * the QK logits are accumulated in float64 and rounded once to float32
    (``_qk_logits``). A product of two fp8 (or int8) values is exact and the
    float64 sum of ``d_c`` of them is exact in any order, so the content dot
    does not depend on summation order; the reference's float32 dot differs
    from it by a few ulp at most. This keeps P's fp8 rounding decisions —
    which a one-ulp change in a logit can flip — identical between the CUDA
    kernel and this version. Sink-guard rows (float32 content) are the
    exception: their float64 sum is no longer exact in every order;
  * masking uses the kernel's finite ``NEG_INF`` sentinel
    (kernel.py:86) rather than the JAX ref's ``-inf``. Wherever the JAX ref
    is finite the two agree exactly; on an empty row without early exit
    this version gives the single-pass kernel's ``(NaN, -inf)``.

fp8 is widened to float32 before every product, as the Pallas body does.

The parallel (einsum) forms are what the reference backends (``torch_ref``,
``torch_paged_ref``) decode through, as the reference's ``jnp_ref`` /
``jnp_paged_ref`` do: ``snapmla_decode_parallel_ref`` (every block's partial
at once, σp per block, merged by the block maxima),
``snapmla_decode_splitkv_parallel_ref`` (that per split, empty splits
emitting (0, NEG_INF), merged by ``lse_combine_ref``) and
``snapmla_decode_parallel_any`` (either, by ``num_splits``; a rank-4 query
row by row through ``_verify_rows``). They follow the reference's
arithmetic: float32 dots, ``-inf`` masking, no AMLA. They equal the
pipeline up to P's fp8 rounding.
"""
from __future__ import annotations

import torch

from repro_torch.core import quant
from repro_torch.core.placement import einsum
from repro_torch.kernels.mla_decode import amla

NEG_INF = -1e30


def _verify_rows(decode_row, q_c8, q_r, sigma_q, seq_lens, *,
                 stack_axis: int = 1, partial_axis: int = 2):
    """Run a q_len = 1 version once per query row t of a [B, q_len, H, .]
    block, at the row's limit ``seq_lens - (q_len - 1) + t``, and stack the
    results at ``stack_axis`` (a trailing partials tuple at
    ``partial_axis``), as the reference's ``_verify_rows`` (ref.py:30-58)."""
    q_len = q_c8.shape[1]
    lens = seq_lens.long()
    per_row = [decode_row(q_c8[:, t], q_r[:, t], sigma_q[:, t], lens - (q_len - 1 - t))
               for t in range(q_len)]
    out = []
    for parts in zip(*per_row):
        if isinstance(parts[0], tuple):
            out.append(tuple(torch.stack(ps, dim=partial_axis) for ps in zip(*parts)))
        else:
            out.append(torch.stack(parts, dim=stack_axis))
    return tuple(out)


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
    content: torch.Tensor,  # [B, N, d_c] quantized latent cache (or f32, sink rows patched)
    rope: torch.Tensor,     # [B, N, d_r] rope keys, PRE-DIVIDED by sigma_k
    sigma_k: torch.Tensor,  # [B, N]
    seq_lens: torch.Tensor,  # [B]
    *,
    softmax_scale: float,
    block_n: int = 128,
    fmt: str = "fp8_e4m3",
    return_sigma_p: bool = False,
    skip_dead_blocks: bool = False,
    rescale: str = "fma",
    return_raw: bool = False,
):
    """Returns (o [B, H, d_c] f32, lse [B, H] f32) — plus the final sigma_p
    [B, H] when ``return_sigma_p``. ``skip_dead_blocks`` freezes the carried
    state on blocks with no valid token (the split-KV kernel's early exit).

    ``rescale="amla"`` carries the max as the integer ``i`` (m = i*ln2) and
    sigma_p as the integer exponent ``e`` (sigma_p = 2^e); every rescale is
    an exact ``2^k`` applied by ``amla.exp2_mul``. ``return_raw`` (AMLA only)
    returns the unnormalized (acc, l, g = i + e) a split publishes."""
    if rescale not in ("fma", "amla"):
        raise ValueError(f"rescale must be 'fma' or 'amla', not {rescale!r}")
    B, H, d_c = q_c8.shape
    N = content.shape[1]
    if N % block_n:
        raise ValueError(f"cache length {N} is not a multiple of block_n={block_n}")
    dev = q_c8.device
    qmax = quant.qmax_for(fmt) if fmt != "none" else 1.0
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
        if rescale == "amla":
            # m carries i, sp carries e (kernel.py:152-177)
            m_new = torch.maximum(m, torch.ceil(torch.amax(s, dim=-1) * amla.LOG2E_F32))
            e = torch.where(valid, torch.exp(s - (m_new * amla.LN2_F32)[..., None]), 0.0)
            p8, sp_new = amla.quantize_block_pow2(e * sk_all[..., blk], fmt, qmax)
            k = torch.where(l > 0.0, (m - m_new) + (sp - sp_new), 0.0).to(torch.int32)
            l_new = (amla.exp2_mul(l, k)
                     + amla.exp2_mul(torch.sum(e, dim=-1), -sp_new.to(torch.int32)))
            acc_new = amla.exp2_mul(acc, k[..., None]) + torch.matmul(p8, cf[:, blk])
        else:
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
    if rescale == "amla":
        g = m + sp                                                  # integer grid exponent
        if return_raw:
            return acc, l, g
        o = acc / l[..., None]                                      # sigma_p cancels
        lse = g * amla.LN2_F32 + torch.log(l)
    else:
        o = acc / l[..., None]                                      # sigma_p cancels
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
    num = einsum("bsh,bshc->bhc", w, o_partial)
    return num / den[..., None], m_star + torch.log(den)


def amla_combine_ref(acc_partial: torch.Tensor, l_partial: torch.Tensor,
                     g_partial: torch.Tensor):
    """Combine-free AMLA merge of raw split partials: acc [B, S, H, d_c], l
    [B, S, H] (0 if the split is empty), g [B, S, H] integer grid exponents.
    Shift every split with data onto K* = max g by ``exp2_mul``, sum, then
    one division and one log -> (o [B, H, d_c], lse [B, H])."""
    has = l_partial > 0.0
    k_star = torch.amax(torch.where(has, g_partial, NEG_INF), dim=1)      # [B, H]
    k = torch.where(has, g_partial - k_star[:, None, :], 0.0).to(torch.int32)
    den = torch.sum(amla.exp2_mul(l_partial, k), dim=1)
    num = torch.sum(amla.exp2_mul(acc_partial, k[..., None]), dim=1)
    return num / den[..., None], k_star * amla.LN2_F32 + torch.log(den)


def _split_partials(decode_one_split, content, rope, sigma_k, seq_lens,
                    num_splits: int, block_n: int, neutral=(0.0, NEG_INF, 1.0)):
    """Cut the KV axis into ``num_splits`` slices of whole blocks (padding the
    tail slice), run ``decode_one_split`` per slice and neutralize empty
    slices with ``neutral`` — (o = 0, lse = NEG_INF, sigma_p = 1) for FMA,
    all zeros for the raw AMLA (acc, l, g)."""
    N = content.shape[1]
    if N % block_n:
        raise ValueError(f"cache length {N} is not a multiple of block_n={block_n}")
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
        if neutral[1] == NEG_INF:
            lse_s = torch.nan_to_num(lse_s, nan=0.0, neginf=NEG_INF)
        o_parts.append(torch.where(empty[:, None, None], neutral[0], o_s))
        lse_parts.append(torch.where(empty[:, None], neutral[1], lse_s))
        sp_parts.append(torch.where(empty[:, None], neutral[2], sp_s))
    return (torch.stack(o_parts, dim=1), torch.stack(lse_parts, dim=1),
            torch.stack(sp_parts, dim=1))


def snapmla_decode_splitkv_ref(q_c8, q_r, sigma_q, content, rope, sigma_k,
                               seq_lens, *, softmax_scale: float, num_splits: int,
                               block_n: int = 128, fmt: str = "fp8_e4m3",
                               return_partials: bool = False, rescale: str = "fma"):
    """Split-KV oracle: each slice runs the pipeline with its local ragged
    length and the dead-block early exit, then ``lse_combine_ref`` merges
    the (o, lse, sigma_p) partials — or, under ``rescale="amla"``,
    ``amla_combine_ref`` merges the raw (acc, l, g) partials. A rank-4 query
    gives o [B, q_len, H, d_c], lse [B, q_len, H] and partials
    [B, S, q_len, H, .]."""
    if q_c8.dim() == 4:
        return _verify_rows(
            lambda qc, qr, sq, sl: snapmla_decode_splitkv_ref(
                qc, qr, sq, content, rope, sigma_k, sl, softmax_scale=softmax_scale,
                num_splits=num_splits, block_n=block_n, fmt=fmt,
                return_partials=return_partials, rescale=rescale),
            q_c8, q_r, sigma_q, seq_lens)
    amla_mode = rescale == "amla"

    def one_split(c, r, sk, local_len):
        return snapmla_decode_pipeline_ref(
            q_c8, q_r, sigma_q, c, r, sk, local_len, softmax_scale=softmax_scale,
            block_n=block_n, fmt=fmt, return_sigma_p=not amla_mode,
            skip_dead_blocks=True, rescale=rescale, return_raw=amla_mode)

    parts = _split_partials(one_split, content, rope, sigma_k, seq_lens,
                            num_splits, block_n,
                            neutral=(0.0, 0.0, 0.0) if amla_mode else (0.0, NEG_INF, 1.0))
    o, lse = amla_combine_ref(*parts) if amla_mode else lse_combine_ref(*parts[:2])
    if return_partials:
        return o, lse, parts
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
                                     return_partials: bool = False,
                                     rescale: str = "fma"):
    """Paged split-KV oracle: page-table gather + the split-KV oracle at
    block_n == page (plain version of the paged split-KV kernel + combine)."""
    page = content_pool.shape[1]
    c, r, s = gather_paged_view(content_pool, rope_pool, scale_pool, page_table)
    return snapmla_decode_splitkv_ref(
        q_c8, q_r, sigma_q, c, r.float(), s, seq_lens, softmax_scale=softmax_scale,
        num_splits=num_splits, block_n=page, fmt=fmt,
        return_partials=return_partials, rescale=rescale)


def snapmla_decode_paged_ref(q_c8, q_r, sigma_q, content_pool, rope_pool,
                             scale_pool, page_table, seq_lens, *,
                             softmax_scale: float, fmt: str = "fp8_e4m3",
                             rescale: str = "fma"):
    """Single pass over the whole page table with no early exit (plain version
    of the single-pass paged kernel, kernel.py:694): dead pages still run the
    sigma_p update with an all-masked block."""
    page = content_pool.shape[1]
    c, r, s = gather_paged_view(content_pool, rope_pool, scale_pool, page_table)
    return snapmla_decode_pipeline_ref(
        q_c8, q_r, sigma_q, c, r.float(), s, seq_lens, softmax_scale=softmax_scale,
        block_n=page, fmt=fmt, rescale=rescale)


def snapmla_decode_parallel_ref(q_c8, q_r, sigma_q, content, rope, sigma_k, seq_lens, *,
                                softmax_scale: float, block_n: int = 128,
                                fmt: str = "fp8_e4m3"):
    """Parallel (two-pass flash-combine) form of the pipeline (ref.py:389-442):
    q_c8 [B, H, d_c], q_r [B, H, d_r] (/ sigma_q), sigma_q [B, H], content
    [B, N, d_c], rope [B, N, d_r] (/ sigma_k), sigma_k [B, N], seq_lens [B]
    -> (o [B, H, d_c] f32, lse [B, H] f32). The QK, PV and combine dots run
    in float32, as the reference's einsums do; an empty row gives NaN."""
    B, H, d_c = q_c8.shape
    N = content.shape[1]
    if N % block_n:
        raise ValueError(f"cache length {N} is not a multiple of block_n={block_n}")
    nb = N // block_n
    dev = q_c8.device
    s = (einsum("bhc,bnc->bhn", q_c8.float(), content.float())
         + einsum("bhr,bnr->bhn", q_r.float(), rope.float()))
    s = s * (sigma_q.float()[:, :, None] * sigma_k.float()[:, None, :]) * softmax_scale
    mask = torch.arange(N, device=dev)[None, None, :] < seq_lens.to(dev).long()[:, None, None]
    s = torch.where(mask, s, float("-inf"))
    sb = s.reshape(B, H, nb, block_n)
    m_k = torch.amax(sb, dim=-1)                                      # [B, H, nb]
    e = torch.where(torch.isfinite(sb), torch.exp(sb - m_k[..., None]), 0.0)
    # Key Step 2: fuse the per-token V scale, block-wise dynamic quantization
    p8, sp = _quantize_p(e * sigma_k.float().reshape(B, 1, nb, block_n), fmt)
    o_k = einsum("bhkn,bknc->bhkc", p8,
                       content.float().reshape(B, nb, block_n, d_c))  # [B, H, nb, d_c]
    l_k = torch.sum(e, dim=-1)
    m_star = torch.amax(m_k, dim=-1, keepdim=True)
    w = torch.exp(m_k - m_star)
    num = einsum("bhk,bhkc->bhc", w * sp, o_k)
    den = einsum("bhk,bhk->bh", w, l_k)
    return num / den[..., None], m_star[..., 0] + torch.log(den)


def snapmla_decode_splitkv_parallel_ref(q_c8, q_r, sigma_q, content, rope, sigma_k,
                                        seq_lens, *, softmax_scale: float, num_splits: int,
                                        block_n: int = 128, fmt: str = "fp8_e4m3"):
    """Split-KV in the parallel form (ref.py:445-474): the two-pass form per
    split (sigma_p folded into its lse), empty splits as the neutral
    (0, NEG_INF) partial, merged by ``lse_combine_ref``."""
    def one_split(c, r, sk, local_len):
        o_s, lse_s = snapmla_decode_parallel_ref(
            q_c8, q_r, sigma_q, c, r, sk, local_len, softmax_scale=softmax_scale,
            block_n=block_n, fmt=fmt)
        return o_s, lse_s, torch.ones_like(lse_s)

    o_p, lse_p, _ = _split_partials(one_split, content, rope, sigma_k, seq_lens,
                                    num_splits, block_n)
    return lse_combine_ref(o_p, lse_p)


def snapmla_decode_parallel_any(q_c8, q_r, sigma_q, content, rope, sigma_k, seq_lens, *,
                                softmax_scale: float, num_splits: int = 1,
                                block_n: int = 128, fmt: str = "fp8_e4m3"):
    """The parallel form at any split count (ref.py:477-511): one split is
    ``snapmla_decode_parallel_ref``, more the split form; a rank-4
    ``[B, q_len, H, .]`` query runs row by row under the verify contract."""
    kw = dict(softmax_scale=softmax_scale, block_n=block_n, fmt=fmt)
    if q_c8.dim() == 4:
        return _verify_rows(
            lambda qc, qr, sq, sl: snapmla_decode_parallel_any(
                qc, qr, sq, content, rope, sigma_k, sl, num_splits=num_splits, **kw),
            q_c8, q_r, sigma_q, seq_lens)
    if num_splits > 1:
        return snapmla_decode_splitkv_parallel_ref(q_c8, q_r, sigma_q, content, rope, sigma_k,
                                                   seq_lens, num_splits=num_splits, **kw)
    return snapmla_decode_parallel_ref(q_c8, q_r, sigma_q, content, rope, sigma_k, seq_lens,
                                       **kw)


def prepare_q(q_c: torch.Tensor, q_r: torch.Tensor, fmt: str = "fp8_e4m3"):
    """Fused-Q-Quant reference: q_c [B, H, d_c] f32, q_r [B, H, d_r] ->
    (q_c8, q_r_scaled, sigma_q [B, H])."""
    if fmt == "none":
        return (q_c.to(torch.bfloat16), q_r.float(),
                torch.ones(q_c.shape[:-1], dtype=torch.float32, device=q_c.device))
    raq = quant.quantize_rope_aware(q_c, q_r, fmt, rope_dtype=torch.float32)
    return raq.q_content, raq.rope_scaled, raq.scale[..., 0]
