"""Multi-head Latent Attention (port of ``repro/core/mla.py``).

DeepSeek-V2/V3 MLA math (paper §2): low-rank joint KV compression
``c_kv = W_DKV h`` (Eq. 1), decoupled RoPE key ``k_r = RoPE(W_KR h)`` shared
across heads (Eq. 2), V from the latent only (Eq. 4), and the absorbed
decode form (Eq. 5) ``q~_i = W_UK_i^T q_c_i``. Weights keep the JAX layouts.
The query takes the direct W_Q (``q_lora_rank == 0``, mla-7b) or DeepSeek's
q-LoRA (``q_lora_rank > 0``, deepseek-v3-mla): ``W_UQ rmsnorm(W_DQ h)``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.models.layers import _normal, apply_rope, einsum, matmul, rms_norm, rope_freqs


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    d_model: int
    n_heads: int
    d_head: int          # per-head content dim (d_h)
    d_rope: int          # decoupled rope dim (d_r), shared K across heads
    d_c: int             # KV compression dim (latent)
    q_lora_rank: int = 0
    rope_theta: float = 10000.0

    @property
    def qk_dim(self) -> int:
        return self.d_head + self.d_rope

    @property
    def softmax_scale(self) -> float:
        return 1.0 / (self.qk_dim ** 0.5)


class MLAParams(NamedTuple):
    """Weights for one MLA attention layer (absorbed-compatible layout)."""

    w_dq: torch.Tensor | None    # [d, q_lora] or None
    q_norm: torch.Tensor | None  # [q_lora]
    w_uq: torch.Tensor           # [q_lora or d, H, d_h + d_r]
    w_dkv: torch.Tensor          # [d, d_c]
    kv_norm: torch.Tensor        # [d_c]
    w_kr: torch.Tensor           # [d, d_r]
    w_uk: torch.Tensor           # [d_c, H, d_h]
    w_uv: torch.Tensor           # [d_c, H, d_h]
    w_o: torch.Tensor            # [H, d_h, d]


def init_mla_params(gen: torch.Generator, cfg: MLAConfig, dtype=torch.float32,
                    device=None) -> MLAParams:
    d, H, dh, dr, dc = cfg.d_model, cfg.n_heads, cfg.d_head, cfg.d_rope, cfg.d_c

    def init(shape, fan_in):
        return _normal(gen, shape, fan_in ** -0.5, dtype, device)

    r = cfg.q_lora_rank
    return MLAParams(
        w_dq=init((d, r), d) if r else None,
        q_norm=torch.ones((r,), dtype=dtype, device=device) if r else None,
        w_uq=init((r, H, dh + dr), r) if r else init((d, H, dh + dr), d),
        w_dkv=init((d, dc), d),
        kv_norm=torch.ones((dc,), dtype=dtype, device=device),
        w_kr=init((d, dr), d),
        w_uk=init((dc, H, dh), dc),
        w_uv=init((dc, H, dh), dc),
        w_o=init((H, dh, d), H * dh),
    )


# ---------------------------------------------------------------------------
# Projections
# ---------------------------------------------------------------------------

def project_q(params: MLAParams, cfg: MLAConfig, h: torch.Tensor,
              positions: torch.Tensor):
    """h [..., S, d] -> (q_c [..., S, H, d_h], q_r [..., S, H, d_r] RoPE'd)."""
    if params.w_dq is not None:
        ql = rms_norm(matmul(h, params.w_dq), params.q_norm)
        q = einsum("...sk,khd->...shd", ql, params.w_uq)
    else:
        q = einsum("...sk,khd->...shd", h, params.w_uq)
    q_c, q_r = q[..., : cfg.d_head], q[..., cfg.d_head:]
    sin, cos = rope_freqs(positions, cfg.d_rope, cfg.rope_theta)
    q_r = apply_rope(q_r, sin[..., None, :], cos[..., None, :])
    return q_c, q_r


def project_kv(params: MLAParams, cfg: MLAConfig, h: torch.Tensor,
               positions: torch.Tensor):
    """h [..., S, d] -> (c_kv [..., S, d_c] normed, k_r [..., S, d_r] RoPE'd)."""
    c_kv = rms_norm(matmul(h, params.w_dkv), params.kv_norm)
    k_r = matmul(h, params.w_kr)
    sin, cos = rope_freqs(positions, cfg.d_rope, cfg.rope_theta)
    return c_kv, apply_rope(k_r, sin, cos)


def absorb_q(params: MLAParams, q_c: torch.Tensor) -> torch.Tensor:
    """q_c [..., H, d_h] -> latent-space query q~ [..., H, d_c] (Eq. 5)."""
    return einsum("...hd,chd->...hc", q_c, params.w_uk)


def output_proj(params: MLAParams, o_latent: torch.Tensor) -> torch.Tensor:
    """o_latent [..., H, d_c] -> [..., d] via W_UV then W_O (absorbed pair)."""
    o_head = einsum("...hc,chd->...hd", o_latent, params.w_uv)
    return einsum("...hd,hdk->...k", o_head, params.w_o)


# ---------------------------------------------------------------------------
# Full-sequence (prefill) attention — the unabsorbed causal form
# ---------------------------------------------------------------------------

def mla_attention(params: MLAParams, cfg: MLAConfig, h: torch.Tensor,
                  positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """h [B, S, d], positions [S] or [B, S] -> [B, S, d]. Written with einsum
    and softmax as the reference is (mla.py:129)."""
    q_c, q_r = project_q(params, cfg, h, positions)        # [B,S,H,dh],[B,S,H,dr]
    c_kv, k_r = project_kv(params, cfg, h, positions)      # [B,S,dc],[B,S,dr]
    k_c = einsum("...sc,chd->...shd", c_kv, params.w_uk)
    v = einsum("...sc,chd->...shd", c_kv, params.w_uv)
    logits = (einsum("...qhd,...khd->...hqk", q_c, k_c)
              + einsum("...qhd,...kd->...hqk", q_r, k_r)) * cfg.softmax_scale
    S = h.shape[-2]
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=h.device))
        logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits.float(), dim=-1).to(h.dtype)
    o = einsum("...hqk,...khd->...qhd", p, v)
    return einsum("...qhd,hdk->...qk", o, params.w_o)


# ---------------------------------------------------------------------------
# Absorbed decode (one new token against a latent cache) — the BF16 baseline
# ---------------------------------------------------------------------------

def mla_decode_absorbed(params: MLAParams, cfg: MLAConfig, h_t: torch.Tensor,
                        cache_c: torch.Tensor, cache_kr: torch.Tensor,
                        seq_lens: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    """The unquantized absorbed decode (mla.py:159-182): h_t [B, d], the
    latent cache ``cache_c`` [B, N, d_c] and rope keys ``cache_kr``
    [B, N, d_r] (the new token already appended: ``seq_lens`` [B] counts
    it), ``positions`` [B] the token's position -> [B, d]. Softmax over the
    valid slots in float32, as the reference's."""
    q_c, q_r = project_q(params, cfg, h_t[:, None, :], positions[:, None])
    q_lat = absorb_q(params, q_c[:, 0])                           # [B, H, d_c]
    logits = (einsum("bhc,bnc->bhn", q_lat.float(), cache_c.float())
              + einsum("bhr,bnr->bhn", q_r[:, 0].float(), cache_kr.float())
              ) * cfg.softmax_scale
    n = cache_c.shape[1]
    mask = (torch.arange(n, device=h_t.device)[None, None, :]
            < seq_lens.to(h_t.device).long()[:, None, None])
    p = torch.softmax(torch.where(mask, logits, float("-inf")), dim=-1)
    o_lat = einsum("bhn,bnc->bhc", p, cache_c.float())
    return output_proj(params, o_lat.to(h_t.dtype))
