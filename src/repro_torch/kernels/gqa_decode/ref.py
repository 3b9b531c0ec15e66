"""Plain PyTorch versions of the FP8 per-token quantized GQA decode pipeline
(port of ``repro/kernels/gqa_decode/ref.py``).

SnapMLA's Key Step 2 generalized to GQA: K and V are quantized per token and
kv head after RoPE; K's scale multiplies the logits (it lies along the QK
non-reduction dim), V's lies along the PV reduction dim, so it is fused into
the probability block, which is quantized block by block (block-wise dynamic
P quantization) and dequantized implicitly through sigma_p.

  * ``gqa_decode_pipeline_ref`` — the plain version of the CUDA kernel
    (``csrc/gqa_decode.cu``): one KV block of ``block_n`` slots at a time, in
    order, with no early exit. It follows the Pallas kernel's arithmetic
    (``kernel.py:26-104``) rather than the reference's jnp pipeline: the
    finite ``NEG_INF`` sentinel, ``e`` masked to 0 on invalid slots (so a
    block with no valid slot leaves the state finite and floors sigma_p at
    EPS/qmax), ``(q·k)·ks·f32(1/sqrt(dh))`` in that order, and
    ``max(amax, EPS) / qmax`` as the compiled form computes it
    (``quant.dynamic_scale``). A row with no valid slot gives 0/0 = NaN.
  * ``gqa_decode_parallel_ref`` — the parallel (flash-combine) form the
    reference's model path runs (float32, ``-inf`` masking); a test oracle.

Three sums accumulate in float64 and round once to float32, here and in the
kernel alike: the QK dot over dh, the PV dot over the block, and the block's
sum of ``e``. A product of two fp8 (or int8) values is exact in float64 and
so is a block's PV sum of them, in any order; the QK dot (float32 query) and
the sum of ``e`` are not exact, but their float64 sums round to the same
float32 in any order in all but rare cases. So the kernel agrees with this
version bit for bit where the order does not show, and P's fp8 rounding,
which a one-ulp change of a logit can flip, sees the same logits. The
reference accumulates in float32; the two agree within 1e-5.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import quant
from repro_torch.core.placement import einsum, unsharded

NEG_INF = -1e30


def _valid_slots(slot_pos: torch.Tensor, positions: torch.Tensor, window: int) -> torch.Tensor:
    """[B, N] bool: a slot holds a position p with 0 <= p <= positions[b]
    (and p > positions[b] - window with a window)."""
    pos = positions.to(slot_pos.device).long()[:, None]
    valid = (slot_pos >= 0) & (slot_pos <= pos)
    if window:
        valid &= slot_pos > pos - window
    return valid


def gqa_decode_pipeline_ref(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                            k_scale: torch.Tensor, v_scale: torch.Tensor,
                            slot_pos: torch.Tensor, positions: torch.Tensor, *,
                            window: int = 0, block_n: int = 128,
                            fmt: quant.QuantFormat = "fp8_e4m3") -> torch.Tensor:
    """q [B, H, dh] f32 (RoPE applied), k8 / v8 [B, N, Hkv, dh] in the
    storage format, k_scale / v_scale [B, N, Hkv] f32, slot_pos [B, N] int32
    (-1 = empty), positions [B] -> o [B, H, dh] f32. N must be a multiple of
    ``block_n`` (``ops.gqa_decode`` pads)."""
    B, H, dh = q.shape
    N, Hkv = k8.shape[1], k8.shape[2]
    g = H // Hkv
    if N % block_n:
        raise ValueError(f"cache length {N} is not a multiple of block_n={block_n}")
    dev = q.device
    sm_scale = 1.0 / math.sqrt(dh)          # a float32 constant, as in kernel.py:62
    qg = q.float().reshape(B, Hkv, g, dh).double()
    kd = k8.float().double().permute(0, 2, 3, 1)                       # [B, Hkv, dh, N]
    s_all = torch.matmul(qg, kd).float()                               # [B, Hkv, g, N]
    s_all = s_all * k_scale.float().permute(0, 2, 1)[:, :, None, :] * sm_scale
    valid_all = _valid_slots(slot_pos, positions, window)[:, None, None, :]
    s_all = torch.where(valid_all, s_all, NEG_INF)
    vs_all = v_scale.float().permute(0, 2, 1)[:, :, None, :]           # [B, Hkv, 1, N]
    vd = v8.float().double().permute(0, 2, 1, 3)                       # [B, Hkv, N, dh]
    m = torch.full((B, Hkv, g), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, g), dtype=torch.float32, device=dev)
    sp = torch.ones((B, Hkv, g), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, g, dh), dtype=torch.float32, device=dev)
    for j in range(N // block_n):
        blk = slice(j * block_n, (j + 1) * block_n)
        s, valid = s_all[..., blk], valid_all[..., blk]
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        e = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        # Key Step 2: fuse the per-token V scale, block-wise dynamic quantization
        p_fused = e * vs_all[..., blk]
        if fmt != "none":
            sp_new = quant.dynamic_scale(torch.amax(torch.abs(p_fused), dim=-1),
                                         quant.qmax_for(fmt))
            p8 = quant._cast(p_fused / sp_new[..., None], fmt).float()
        else:
            sp_new = torch.ones_like(m_new)
            p8 = p_fused
        corr = torch.exp(m - m_new) * (sp / sp_new)
        l = l * corr + e.double().sum(dim=-1).float() / sp_new
        acc = acc * corr[..., None] + torch.matmul(p8.double(), vd[:, :, blk]).float()
        m, sp = m_new, sp_new
    return (acc / l[..., None]).reshape(B, H, dh)


def gqa_decode_parallel_ref(q: torch.Tensor, k8: torch.Tensor, v8: torch.Tensor,
                            k_scale: torch.Tensor, v_scale: torch.Tensor,
                            slot_pos: torch.Tensor, positions: torch.Tensor, *,
                            window: int = 0, block_n: int = 128,
                            fmt: quant.QuantFormat = "fp8_e4m3") -> torch.Tensor:
    """The parallel (flash-combine) form of the pipeline (ref.py:81-136):
    every block's partial at once, merged by the block maxima. Equal to the
    pipeline up to P's fp8 rounding."""
    B, H, dh = q.shape
    N, Hkv = k8.shape[1], k8.shape[2]
    g = H // Hkv
    if N % block_n:
        raise ValueError(f"cache length {N} is not a multiple of block_n={block_n}")
    nb = N // block_n
    qmax = quant.qmax_for(fmt) if fmt != "none" else 1.0
    # grouping the heads, and splitting the slots into blocks, cannot keep a
    # sharding that Hkv or nb does not divide
    qg = unsharded("gqa_group_heads", q, 1).float().reshape(B, Hkv, g, dh)
    s = einsum("bhgd,bnhd->bhgn", qg, k8.float())
    s = s * k_scale.float().permute(0, 2, 1)[:, :, None, :] / math.sqrt(dh)
    valid = _valid_slots(slot_pos, positions, window)
    s = torch.where(valid[:, None, None, :], s, float("-inf"))
    sb = unsharded("gqa_split_blocks", s, 3).reshape(B, Hkv, g, nb, block_n)
    m_k = torch.amax(sb, dim=-1)                                       # [B, Hkv, g, nb]
    e = torch.where(torch.isfinite(sb), torch.exp(sb - m_k[..., None]), 0.0)
    vsb = v_scale.float().permute(0, 2, 1).reshape(B, Hkv, 1, nb, block_n)
    p_fused = e * vsb
    amax = torch.amax(torch.abs(p_fused), dim=-1)
    sp = quant.dynamic_scale(amax, qmax)
    if fmt != "none":
        p8 = quant._cast(p_fused / sp[..., None], fmt).float()
    else:
        sp = torch.ones_like(sp)
        p8 = p_fused
    vb = v8.float().permute(0, 2, 1, 3).reshape(B, Hkv, nb, block_n, dh)
    o_k = einsum("bhgkn,bhknd->bhgkd", p8, vb)
    l_k = torch.sum(e, dim=-1)
    m_star = torch.amax(m_k, dim=-1, keepdim=True)
    w = torch.exp(m_k - m_star)
    num = einsum("bhgk,bhgkd->bhgd", w * sp, o_k)
    den = einsum("bhgk,bhgk->bhg", w, l_k)
    return (num / den[..., None]).reshape(B, H, dh)


def pad_to_block(k8: torch.Tensor, v8: torch.Tensor, k_scale: torch.Tensor,
                 v_scale: torch.Tensor, slot_pos: torch.Tensor, block_n: int):
    """Pad N up to a multiple of ``block_n`` with empty slots: zero codes,
    unit scales, ``slot_pos = -1`` (ops.py:27-33 of the reference)."""
    B, N = slot_pos.shape
    pad = (-N) % block_n
    if not pad:
        return k8, v8, k_scale, v_scale, slot_pos

    def grow(x, value):
        fill = torch.full((B, pad) + tuple(x.shape[2:]), value, dtype=torch.float32,
                          device=x.device).to(x.dtype)
        return torch.cat([x, fill], dim=1)

    return (grow(k8, 0.0), grow(v8, 0.0), grow(k_scale, 1.0), grow(v_scale, 1.0),
            torch.cat([slot_pos, torch.full((B, pad), -1, dtype=slot_pos.dtype,
                                            device=slot_pos.device)], dim=1))
