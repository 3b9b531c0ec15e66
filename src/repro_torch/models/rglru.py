"""RG-LRU recurrent block of Griffin / RecurrentGemma (port of
``repro/models/rglru.py``, arXiv:2402.19427).

Block = x -> [linear -> GELU] * [linear -> causal conv1d (width 4) -> RG-LRU]
-> linear, with the RG-LRU cell per channel

    r_t = sigmoid(W_a u_t + b_a),  i_t = sigmoid(W_x u_t + b_x)
    a_t = exp(-c * softplus(Λ) * r_t),  c = 8
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t)

``rglru_block`` (training / prefill) runs the recurrence as a sequential
scan over the sequence, where the reference runs an associative scan: the
same recurrence, summed in another order (within the reference test's
1e-4). ``rglru_step`` is the O(1) decode step. The state is not a KV cache,
so SnapMLA's quantization does not apply; it stays in float32.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.placement import local_scan
from repro_torch.models.layers import _normal, einsum, matmul

RGLRU_C = 8.0
CONV_W = 4


class RGLRUParams(NamedTuple):
    w_gate_branch: torch.Tensor   # [d, d_rnn] (GELU branch)
    w_in: torch.Tensor            # [d, d_rnn] (recurrent branch input)
    conv_w: torch.Tensor          # [CONV_W, d_rnn] depthwise causal conv
    conv_b: torch.Tensor          # [d_rnn]
    w_a: torch.Tensor             # [d_rnn, d_rnn] recurrence-gate projection
    b_a: torch.Tensor             # [d_rnn]
    w_x: torch.Tensor             # [d_rnn, d_rnn] input-gate projection
    b_x: torch.Tensor             # [d_rnn]
    log_lambda: torch.Tensor      # [d_rnn] Λ (softplus'd)
    w_out: torch.Tensor           # [d_rnn, d]


class RGLRUState(NamedTuple):
    h: torch.Tensor               # [B, d_rnn] recurrent state (f32)
    conv: torch.Tensor            # [B, CONV_W - 1, d_rnn] the conv's last inputs


def init_rglru_params(gen: torch.Generator, d: int, d_rnn: int, dtype=torch.float32,
                      device=None) -> RGLRUParams:
    """Random weights from ``gen``; Λ such that a ~ U(0.9, 0.999)^c, as in
    the Griffin paper (rglru.py:45-65)."""
    u = torch.rand((d_rnn,), generator=gen, device=device) * (0.999 - 0.9) + 0.9
    log_lambda = torch.log(torch.expm1(-torch.log(u)))    # softplus^-1(-log u)

    def zeros(shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return RGLRUParams(
        w_gate_branch=_normal(gen, (d, d_rnn), d ** -0.5, dtype, device),
        w_in=_normal(gen, (d, d_rnn), d ** -0.5, dtype, device),
        conv_w=_normal(gen, (CONV_W, d_rnn), CONV_W ** -0.5, dtype, device),
        conv_b=zeros((d_rnn,)),
        w_a=_normal(gen, (d_rnn, d_rnn), d_rnn ** -0.5, dtype, device),
        b_a=zeros((d_rnn,)),
        w_x=_normal(gen, (d_rnn, d_rnn), d_rnn ** -0.5, dtype, device),
        b_x=zeros((d_rnn,)),
        log_lambda=log_lambda.to(dtype),
        w_out=_normal(gen, (d_rnn, d), d_rnn ** -0.5, dtype, device),
    )


def init_rglru_state(batch: int, d_rnn: int, device=None) -> RGLRUState:
    return RGLRUState(
        h=torch.zeros((batch, d_rnn), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, CONV_W - 1, d_rnn), dtype=torch.float32, device=device))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")     # jax.nn.gelu's default form


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None):
    """x [B, S, dr]: the depthwise causal conv of width CONV_W over
    [tail | x] (zeros without a tail) -> (y [B, S, dr], the new tail)."""
    B, S, dr = x.shape
    pad = torch.zeros((B, CONV_W - 1, dr), dtype=x.dtype, device=x.device) if tail is None \
        else tail.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                         # [B, S + 3, dr]
    out = xp[:, 0:S] * w[0]
    for i in range(1, CONV_W):
        out = out + xp[:, i:i + S] * w[i]
    return out + b, xp[:, -(CONV_W - 1):]


def _gates(params: RGLRUParams, u: torch.Tensor):
    """(a, sqrt(1 - a^2) * i * u) of the RG-LRU cell, float32."""
    r = torch.sigmoid(matmul(u, params.w_a) + params.b_a)
    i = torch.sigmoid(matmul(u, params.w_x) + params.b_x)
    log_a = -RGLRU_C * F.softplus(params.log_lambda.float()) * r
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * u)
    return a, gated


def _scan(a: torch.Tensor, gated: torch.Tensor, h0: torch.Tensor | None) -> torch.Tensor:
    """h_t = a_t h_(t-1) + gated_t over t (dimension 1), from ``h0[:, 0]``
    (0 when None): [B, S, dr] -> every h_t."""
    h = torch.empty_like(gated)
    prev = None if h0 is None else h0[:, 0]
    for t in range(gated.shape[1]):
        prev = gated[:, t] if prev is None else a[:, t] * prev + gated[:, t]
        h[:, t] = prev
    return h


def rglru_block(params: RGLRUParams, x: torch.Tensor, state: RGLRUState | None = None):
    """Training / prefill: x [B, S, d] -> (y [B, S, d], the final
    ``RGLRUState``), from ``state`` (zeros when None)."""
    gate = _gelu(matmul(x, params.w_gate_branch))
    u, conv_tail = _causal_conv(matmul(x, params.w_in), params.conv_w, params.conv_b,
                                None if state is None else state.conv)
    a, gated = _gates(params, u.float())
    h0 = None if state is None else state.h[:, None].expand_as(gated)
    h = local_scan("rglru_scan", _scan, a, gated, h0)
    y = matmul(h.to(x.dtype) * gate, params.w_out)
    return y, RGLRUState(h=h[:, -1], conv=conv_tail)


def rglru_step(params: RGLRUParams, x_t: torch.Tensor, state: RGLRUState):
    """Decode: x_t [B, d] -> (y [B, d], the new state). O(1) per token."""
    gate = _gelu(matmul(x_t, params.w_gate_branch))
    u = matmul(x_t, params.w_in)                             # [B, dr]
    conv_in = torch.cat([state.conv, u[:, None].to(state.conv.dtype)], dim=1)  # [B, W, dr]
    u_c = einsum("bwd,wd->bd", conv_in, params.conv_w) + params.conv_b
    a, gated = _gates(params, u_c.float())
    h = a * state.h + gated
    y = matmul(h.to(x_t.dtype) * gate, params.w_out)
    return y, RGLRUState(h=h, conv=conv_in[:, 1:])
