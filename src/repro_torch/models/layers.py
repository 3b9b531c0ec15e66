"""Transformer layers the MLA path needs (port of the matching parts of
``repro/models/layers.py``): RMSNorm, half-split RoPE, the gated MLP and the
embedding. Weights are plain tensors in the JAX package's layouts."""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * gain.float()).to(x.dtype)


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


class MLPParams(NamedTuple):
    w_gate: torch.Tensor | None  # [d, f] (None for plain MLP)
    w_up: torch.Tensor           # [d, f]
    w_down: torch.Tensor         # [f, d]


def _normal(gen: torch.Generator, shape, std: float, dtype, device) -> torch.Tensor:
    w = torch.randn(shape, generator=gen, dtype=torch.float32, device=device)
    return (w * std).to(dtype)


def init_mlp_params(gen: torch.Generator, d: int, f: int, gated: bool = True,
                    dtype=torch.float32, device=None) -> MLPParams:
    return MLPParams(
        w_gate=_normal(gen, (d, f), d ** -0.5, dtype, device) if gated else None,
        w_up=_normal(gen, (d, f), d ** -0.5, dtype, device),
        w_down=_normal(gen, (f, d), f ** -0.5, dtype, device),
    )


_ACTS = {"silu": F.silu, "gelu": F.gelu,
         "gelu_tanh": lambda t: F.gelu(t, approximate="tanh")}


def mlp(params: MLPParams, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    act = _ACTS[activation]
    if params.w_gate is not None:
        h = act(x @ params.w_gate) * (x @ params.w_up)
    else:
        h = act(x @ params.w_up)
    return h @ params.w_down


def init_embedding(gen: torch.Generator, vocab: int, d: int, dtype=torch.float32,
                   device=None) -> torch.Tensor:
    return _normal(gen, (vocab, d), 0.02, dtype, device)


def embed(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return table[tokens]
