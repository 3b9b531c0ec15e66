"""Transformer layers (port of ``repro/models/layers.py``): RMSNorm and
LayerNorm, half-split RoPE, GQA attention for training and prefill
(``project_qkv``, ``sdpa``, ``flash_sdpa``, ``attention_block``), cross
attention (``cross_attention_block``), the MLPs, the embedding and the tied
unembedding. Weights are plain tensors
in the JAX package's layouts.

``sdpa`` and ``flash_sdpa`` are plain PyTorch, as the reference computes them
in plain jnp outside any Pallas kernel; ``scaled_dot_product_attention`` is
not used, since its rounding differs."""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core import placement as PL
from repro_torch.core.placement import gather_rows, unsharded, whole_grad


def promoted(*ts: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """``ts`` cast to their common dtype, as JAX promotes the operands of a
    dot whose dtypes differ (a float32 activation against bfloat16 weights
    gives a float32 product, where torch would raise); a no-op, and so
    bitwise, when the dtypes agree."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    """``placement.einsum`` (``torch.einsum``, run on the local shards of
    DTensors) over ``promoted`` operands."""
    return PL.einsum(eq, *promoted(*ops))


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` over ``promoted`` operands (a 2-D ``b``); on DTensors the
    same product as ``einsum``."""
    a, b = promoted(a, b)
    if PL.has_dtensor((a, b)):
        return PL.local_einsum("...i,ij->...j", a, b)
    return a @ b


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * gain.float()).to(x.dtype)


def layer_norm(x: torch.Tensor, gain: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 with the population variance (layers.py:26); no
    model path of either package calls it."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * gain.float() + bias.float()).to(x.dtype)


def rope_freqs(positions: torch.Tensor, dim: int, theta: float = 10000.0):
    """positions [...] -> (sin, cos) each [..., dim] (half-split convention)."""
    half = dim // 2
    exps = torch.arange(half, dtype=torch.float32, device=positions.device) / half
    inv = 1.0 / (theta ** exps)
    ang = positions.float()[..., None] * inv                 # [..., half]
    ang = torch.cat([ang, ang], dim=-1)                      # [..., dim]
    return torch.sin(ang), torch.cos(ang)


def apply_rope(x: torch.Tensor, sin: torch.Tensor, cos: torch.Tensor) -> torch.Tensor:
    """x [..., dim]; sin/cos broadcastable to x. Half-split rotate."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    rotated = torch.cat([-x2, x1], dim=-1)
    return (x.float() * cos + rotated.float() * sin).to(x.dtype)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    rope_theta: float = 10000.0
    qkv_bias: bool = False            # qwen2.5 style
    window: int = 0                   # 0 = full causal; >0 = sliding window
    use_rope: bool = True


class AttnParams(NamedTuple):
    wq: torch.Tensor            # [d, H, dh]
    wk: torch.Tensor            # [d, Hkv, dh]
    wv: torch.Tensor            # [d, Hkv, dh]
    wo: torch.Tensor            # [H, dh, d]
    bq: torch.Tensor | None     # [H, dh]
    bk: torch.Tensor | None     # [Hkv, dh]
    bv: torch.Tensor | None     # [Hkv, dh]


def init_attn_params(gen: torch.Generator, cfg: AttnConfig, dtype=torch.float32,
                     device=None) -> AttnParams:
    d, H, Hk, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.d_head

    def bias(shape):
        return torch.zeros(shape, dtype=dtype, device=device) if cfg.qkv_bias else None

    return AttnParams(
        wq=_normal(gen, (d, H, dh), d ** -0.5, dtype, device),
        wk=_normal(gen, (d, Hk, dh), d ** -0.5, dtype, device),
        wv=_normal(gen, (d, Hk, dh), d ** -0.5, dtype, device),
        wo=_normal(gen, (H, dh, d), (H * dh) ** -0.5, dtype, device),
        bq=bias((H, dh)), bk=bias((Hk, dh)), bv=bias((Hk, dh)),
    )


def project_qkv(params: AttnParams, cfg: AttnConfig, x: torch.Tensor,
                positions: torch.Tensor):
    """x [B, S, d] -> q [B, S, H, dh], k, v [B, S, Hkv, dh] (RoPE on q, k)."""
    q = einsum("bsd,dhk->bshk", x, params.wq)
    k = einsum("bsd,dhk->bshk", x, params.wk)
    v = einsum("bsd,dhk->bshk", x, params.wv)
    if params.bq is not None:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    if cfg.use_rope:
        sin, cos = rope_freqs(positions, cfg.d_head, cfg.rope_theta)
        sin, cos = sin[..., None, :], cos[..., None, :]
        q, k = apply_rope(q, sin, cos), apply_rope(k, sin, cos)
    return q, k, v


def _group_heads(q: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q [B, S, H, dh] -> [B, S, Hkv, H / Hkv, dh] (a reshape; on a DTensor
    the head dimension is made whole first, and the gradient's grouped
    dimensions before it flows back)."""
    B, S, H, dh = q.shape
    qg = unsharded("group_heads", q, 2).reshape(B, S, n_kv, H // n_kv, dh)
    return whole_grad("group_heads_grad", qg, 2, 3)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
         window: int = 0, q_offset: int = 0) -> torch.Tensor:
    """Reference attention with GQA head sharing and the sliding window:
    q [B, Sq, H, dh], k, v [B, Sk, Hkv, dh] -> [B, Sq, H, dh]."""
    B, Sq, H, dh = q.shape
    Hkv, Sk = k.shape[2], k.shape[1]
    g = H // Hkv
    qg = _group_heads(q, Hkv).float()
    logits = einsum("bqhgd,bkhd->bhgqk", qg, k.float()) / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window:
        mask &= kpos[None, :] > qpos[:, None] - window
    logits = torch.where(mask, logits, float("-inf"))
    p = torch.softmax(logits, dim=-1)
    o = einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return o.reshape(B, Sq, H, dh).to(q.dtype)


def flash_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
               window: int = 0, q_offset: int = 0, block_k: int = 512) -> torch.Tensor:
    """The training / prefill attention: online softmax over KV blocks of
    ``block_k`` tokens (the reference's ``lax.scan``), with the causal and
    window masks; peak intermediate O(Sq * block_k)."""
    B, Sq, H, dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    nblocks = -(-Sk // block_k)
    qg = _group_heads(q, Hkv).float() / math.sqrt(dh)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    m = torch.full((B, Hkv, g, Sq), float("-inf"), device=q.device)
    l = torch.zeros((B, Hkv, g, Sq), device=q.device)
    acc = torch.zeros((B, Hkv, g, Sq, dh), device=q.device)
    for j in range(nblocks):
        lo, hi = j * block_k, min((j + 1) * block_k, Sk)
        s = einsum("bqhgd,bkhd->bhgqk", qg, k[:, lo:hi].float())
        kpos = torch.arange(lo, hi, device=q.device)
        valid = torch.ones((Sq, hi - lo), dtype=torch.bool, device=q.device)
        if causal:
            valid &= kpos[None, :] <= qpos[:, None]
        if window:
            valid &= kpos[None, :] > qpos[:, None] - window
        s = torch.where(valid, s, float("-inf"))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        e = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(e, dim=-1)
        acc = acc * corr[..., None] + einsum("bhgqk,bkhd->bhgqd", e,
                                                   v[:, lo:hi].float())
        m = m_new
    o = acc / torch.clamp(l, min=1e-30)[..., None]            # [B, Hkv, g, Sq, dh]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dh).to(q.dtype)


def attention_block(params: AttnParams, cfg: AttnConfig, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool = True,
                    use_flash: bool = True) -> torch.Tensor:
    q, k, v = project_qkv(params, cfg, x, positions)
    if use_flash:
        o = flash_sdpa(q, k, v, causal=causal, window=cfg.window)
    else:
        o = sdpa(q, k, v, causal=causal, window=cfg.window)
    return einsum("bshk,hkd->bsd", o, params.wo)


def cross_attention_block(params: AttnParams, cfg: AttnConfig, x: torch.Tensor,
                          kv_src: torch.Tensor) -> torch.Tensor:
    """Cross attention (layers.py:222): queries from x [B, Sq, d], keys and
    values from kv_src [B, Sk, d]; no RoPE, no mask, the plain ``sdpa``."""
    q = einsum("bsd,dhk->bshk", x, params.wq)
    k = einsum("bsd,dhk->bshk", kv_src, params.wk)
    v = einsum("bsd,dhk->bshk", kv_src, params.wv)
    if params.bq is not None:
        q, k, v = q + params.bq, k + params.bk, v + params.bv
    o = sdpa(q, k, v, causal=False)
    return einsum("bshk,hkd->bsd", o, params.wo)


class MLPParams(NamedTuple):
    w_gate: torch.Tensor | None  # [d, f] (None for plain MLP)
    w_up: torch.Tensor           # [d, f]
    w_down: torch.Tensor         # [f, d]


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    # scaled in place: a full-width expert stack is 15 GB a tensor
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return w.mul_(std).to(dtype)


def init_mlp_params(gen: torch.Generator, d: int, f: int, gated: bool = True,
                    dtype=torch.float32, device=None) -> MLPParams:
    return MLPParams(
        w_gate=_normal(gen, (d, f), d ** -0.5, dtype, device) if gated else None,
        w_up=_normal(gen, (d, f), d ** -0.5, dtype, device),
        w_down=_normal(gen, (f, d), f ** -0.5, dtype, device),
    )


# "gelu" is the tanh form, as the reference's jax.nn.gelu (approximate=True)
_ACTS = {"silu": F.silu, "gelu": lambda t: F.gelu(t, approximate="tanh"),
         "gelu_tanh": lambda t: F.gelu(t, approximate="tanh")}


def mlp(params: MLPParams, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = _ACTS[activation]
    if params.w_gate is not None:
        h = act(matmul(x, params.w_gate)) * matmul(x, params.w_up)
    else:
        h = act(matmul(x, params.w_up))
    return matmul(h, params.w_down)


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """table[tokens]; on DTensors the lookup follows the tokens' sharding
    (``placement.gather_rows``)."""
    return gather_rows("embed", table, tokens)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: x [B, S, d] @ table.T -> [B, S, V] (f32 logits)."""
    return einsum("bsd,vd->bsv", x.float(), table.float())
