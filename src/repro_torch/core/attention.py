"""Dequantize-first decode attention oracles (port of
``repro/core/attention.py``): the whole cache is dequantized up front and
exact attention runs in float32. The decode pipelines (and their kernels)
agree with these within the FP8 / INT8 round-trip tolerance."""
from __future__ import annotations

import math

import torch

from repro_torch.core.kvcache import GQACache, MLACache


def mla_decode_dequant_ref(q_lat: torch.Tensor, q_rope: torch.Tensor, cache: MLACache,
                           softmax_scale: float) -> torch.Tensor:
    """Exact absorbed-MLA decode over a (possibly quantized) latent cache:
    q_lat [B, H, d_c] and q_rope [B, H, d_r] unquantized -> [B, H, d_c]."""
    c = cache.content.float() * cache.scale[..., None]       # dequant
    kr = cache.rope.float() * cache.scale[..., None]          # undo the prescale
    logits = (torch.einsum("bhc,bnc->bhn", q_lat.float(), c)
              + torch.einsum("bhr,bnr->bhn", q_rope.float(), kr)) * softmax_scale
    n = c.shape[1]
    mask = torch.arange(n, device=c.device)[None, None, :] < cache.seq_lens.long()[:, None, None]
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhn,bnc->bhc", p, c)


def gqa_decode_dequant_ref(q: torch.Tensor, cache: GQACache, positions: torch.Tensor,
                           window: int = 0) -> torch.Tensor:
    """Exact GQA decode over a (possibly quantized, possibly ring) cache:
    q [B, H, dh] (RoPE applied), positions [B] -> [B, H, dh]."""
    B, H, dh = q.shape
    Hkv = cache.k.shape[2]
    g = H // Hkv
    k = cache.k.float() * cache.k_scale[..., None]
    v = cache.v.float() * cache.v_scale[..., None]
    qg = q.reshape(B, Hkv, g, dh).float()
    logits = torch.einsum("bhgd,bnhd->bhgn", qg, k) / math.sqrt(dh)
    sp = cache.slot_pos
    pos = positions.to(sp.device).long()[:, None]
    valid = (sp >= 0) & (sp <= pos)
    if window:
        valid &= sp > pos - window
    logits = torch.where(valid[:, None, None, :], logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    return torch.einsum("bhgn,bnhd->bhgd", p, v).reshape(B, H, dh)
