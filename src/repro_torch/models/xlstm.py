"""xLSTM blocks (port of ``repro/models/xlstm.py``, arXiv:2405.04517): mLSTM
(matrix memory) and sLSTM (scalar memory).

mLSTM — matrix memory with exponential gating; training / prefill in the
quadratic masked (parallel) form, decode by the recurrence
    C_t = f' C_{t-1} + i' k_t v_t^T,  n_t = f' n_{t-1} + i' k_t,
    h_t = C_t^T q_t / max(|n_t . q_t|, exp(-m_t)),
with the stabilizer m_t = max(log f + m_{t-1}, log i).

sLSTM — scalar memory with recurrent per-head block-diagonal weights;
sequential, so training / prefill loops over time.

Neither block has a KV cache, so SnapMLA's quantization does not apply;
the states stay in float32 and take O(1) memory in the sequence length.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.core.placement import replicated
from repro_torch.models.layers import _normal, einsum


class MLSTMParams(NamedTuple):
    w_q: torch.Tensor        # [d, H, dh]
    w_k: torch.Tensor        # [d, H, dh]
    w_v: torch.Tensor        # [d, H, dh]
    w_i: torch.Tensor        # [d, H] input-gate logit
    w_f: torch.Tensor        # [d, H] forget-gate logit
    b_i: torch.Tensor        # [H]
    b_f: torch.Tensor        # [H]
    w_o_gate: torch.Tensor   # [d, H, dh] output gate (sigmoid)
    w_out: torch.Tensor      # [H, dh, d]
    gn_gain: torch.Tensor    # [H, dh] per-head norm gain


class MLSTMState(NamedTuple):
    c: torch.Tensor          # [B, H, dh, dh] matrix memory
    n: torch.Tensor          # [B, H, dh] normalizer
    m: torch.Tensor          # [B, H] stabilizer


class SLSTMParams(NamedTuple):
    w: torch.Tensor          # [4, d, H, dh] (z, i, f, o input projections)
    r: torch.Tensor          # [4, H, dh, dh] recurrent, block-diagonal per head
    b: torch.Tensor          # [4, H, dh]
    w_out: torch.Tensor      # [H, dh, d]
    gn_gain: torch.Tensor    # [H, dh]


class SLSTMState(NamedTuple):
    c: torch.Tensor          # [B, H, dh]
    n: torch.Tensor          # [B, H, dh]
    h: torch.Tensor          # [B, H, dh]
    m: torch.Tensor          # [B, H, dh]


def _logsigmoid(x: torch.Tensor) -> torch.Tensor:
    """``F.logsigmoid``; DTensor has no sharding rule for its backward, so
    on DTensors it runs replicated."""
    return replicated("logsigmoid", F.logsigmoid, x)


def init_mlstm_params(gen: torch.Generator, d: int, n_heads: int, d_head: int,
                      dtype=torch.float32, device=None) -> MLSTMParams:
    """Random weights from ``gen``; the forget bias at 3 (remember)."""
    def w(shape, fan_in):
        return _normal(gen, shape, fan_in ** -0.5, dtype, device)

    H, dh = n_heads, d_head
    return MLSTMParams(
        w_q=w((d, H, dh), d), w_k=w((d, H, dh), d), w_v=w((d, H, dh), d),
        w_i=w((d, H), d), w_f=w((d, H), d),
        b_i=torch.zeros((H,), dtype=dtype, device=device),
        b_f=torch.full((H,), 3.0, dtype=dtype, device=device),
        w_o_gate=w((d, H, dh), d), w_out=w((H, dh, d), H * dh),
        gn_gain=torch.ones((H, dh), dtype=dtype, device=device))


def init_mlstm_state(batch: int, n_heads: int, d_head: int, device=None) -> MLSTMState:
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMState(c=torch.zeros((batch, n_heads, d_head, d_head), **f32),
                      n=torch.zeros((batch, n_heads, d_head), **f32),
                      m=torch.full((batch, n_heads), float("-inf"), **f32))


def init_slstm_params(gen: torch.Generator, d: int, n_heads: int, d_head: int,
                      dtype=torch.float32, device=None) -> SLSTMParams:
    """Random weights from ``gen``; the forget gate's bias at 3."""
    H, dh = n_heads, d_head
    b = torch.zeros((4, H, dh), dtype=dtype, device=device)
    b[2] = 3.0
    return SLSTMParams(w=_normal(gen, (4, d, H, dh), d ** -0.5, dtype, device),
                       r=_normal(gen, (4, H, dh, dh), dh ** -0.5, dtype, device), b=b,
                       w_out=_normal(gen, (H, dh, d), (H * dh) ** -0.5, dtype, device),
                       gn_gain=torch.ones((H, dh), dtype=dtype, device=device))


def init_slstm_state(batch: int, n_heads: int, d_head: int, device=None) -> SLSTMState:
    z = torch.zeros((batch, n_heads, d_head), dtype=torch.float32, device=device)
    return SLSTMState(c=z, n=z.clone(), h=z.clone(), m=torch.full_like(z, float("-inf")))


def _head_norm(h: torch.Tensor, gain: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm over dh: h [..., H, dh]."""
    var = torch.mean(h * h, dim=-1, keepdim=True)
    return h * torch.rsqrt(var + eps) * gain


def mlstm_block(params: MLSTMParams, x: torch.Tensor):
    """Training / prefill from a fresh state, in the quadratic parallel
    form: x [B, S, d] -> (y [B, S, d], the final ``MLSTMState``)."""
    S = x.shape[1]
    dh = params.w_q.shape[2]
    q = einsum("bsd,dhk->bshk", x, params.w_q) / math.sqrt(dh)
    k = einsum("bsd,dhk->bshk", x, params.w_k)
    v = einsum("bsd,dhk->bshk", x, params.w_v)
    i_log = (einsum("bsd,dh->bsh", x, params.w_i) + params.b_i).float()
    f_log = _logsigmoid((einsum("bsd,dh->bsh", x, params.w_f) + params.b_f).float())
    f_cum = torch.cumsum(f_log, dim=1)                               # [B, S, H]
    # D[t, s] = f_cum[t] - f_cum[s] + i_log[s] for s <= t
    dmat = f_cum[:, :, None, :] - f_cum[:, None, :, :] + i_log[:, None, :, :]
    mask = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))[None, :, :, None]
    dmat = torch.where(mask, dmat, float("-inf"))                   # [B, T, S, H]
    m = torch.amax(dmat, dim=2, keepdim=True)                       # [B, T, 1, H]
    dexp = torch.exp(dmat - m)
    ct = einsum("bthk,bshk->btsh", q.float(), k.float()) * dexp
    norm = torch.maximum(torch.abs(torch.sum(ct, dim=2)), torch.exp(-m[:, :, 0]))
    h = einsum("btsh,bshk->bthk", ct, v.float()) / norm[..., None]
    o_gate = torch.sigmoid(einsum("bsd,dhk->bshk", x, params.w_o_gate))
    y = _head_norm(h.to(x.dtype), params.gn_gain) * o_gate
    y = einsum("bshk,hkd->bsd", y, params.w_out)
    # the final recurrent state, for the prefill -> decode handoff
    m_fin = f_cum[:, -1:, :] - f_cum + i_log                        # decay to the last step
    w = torch.exp(m_fin - torch.amax(m_fin, dim=1, keepdim=True))
    c_fin = einsum("bsh,bshk,bshl->bhkl", w, k.float(), v.float())
    n_fin = einsum("bsh,bshk->bhk", w, k.float())
    return y, MLSTMState(c=c_fin, n=n_fin, m=torch.amax(m_fin, dim=1))


def mlstm_step(params: MLSTMParams, x_t: torch.Tensor, state: MLSTMState):
    """Decode: x_t [B, d] -> (y [B, d], the new state). O(dh^2) per token."""
    dh = params.w_q.shape[2]
    q = einsum("bd,dhk->bhk", x_t, params.w_q).float() / math.sqrt(dh)
    k = einsum("bd,dhk->bhk", x_t, params.w_k).float()
    v = einsum("bd,dhk->bhk", x_t, params.w_v).float()
    i_log = (einsum("bd,dh->bh", x_t, params.w_i) + params.b_i).float()
    f_log = _logsigmoid((einsum("bd,dh->bh", x_t, params.w_f) + params.b_f).float())
    m_new = torch.maximum(f_log + state.m, i_log)
    f_p = torch.exp(f_log + state.m - m_new)[..., None]
    i_p = torch.exp(i_log - m_new)[..., None]
    c = f_p[..., None] * state.c + i_p[..., None] * k[..., :, None] * v[..., None, :]
    n = f_p * state.n + i_p * k
    denom = torch.maximum(torch.abs(einsum("bhk,bhk->bh", n, q)), torch.exp(-m_new))
    h = einsum("bhkl,bhk->bhl", c, q) / denom[..., None]
    o_gate = torch.sigmoid(einsum("bd,dhk->bhk", x_t, params.w_o_gate))
    y = _head_norm(h.to(x_t.dtype), params.gn_gain) * o_gate
    return einsum("bhk,hkd->bd", y, params.w_out), MLSTMState(c, n, m_new)


def _slstm_cell(params: SLSTMParams, pre: torch.Tensor, state: SLSTMState):
    """One step of the sLSTM recurrence from its input projection ``pre``
    [4, B, H, dh] (float32): the new ``SLSTMState``."""
    rec = einsum("bhk,ghkl->gbhl", state.h, params.r.float())
    z_, i_, f_, o_ = pre + rec + params.b.float()[:, None]
    z = torch.tanh(z_)
    o = torch.sigmoid(o_)
    f_log = _logsigmoid(f_)
    m_new = torch.maximum(f_log + state.m, i_)
    i_p = torch.exp(i_ - m_new)
    f_p = torch.exp(f_log + state.m - m_new)
    c = f_p * state.c + i_p * z
    n = torch.maximum(f_p * state.n + i_p, torch.exp(-m_new))
    return SLSTMState(c, n, o * (c / n), m_new)


def slstm_step(params: SLSTMParams, x_t: torch.Tensor, state: SLSTMState):
    """x_t [B, d] -> (y [B, d], the new state)."""
    new = _slstm_cell(params, einsum("bd,gdhk->gbhk", x_t, params.w).float(), state)
    y = _head_norm(new.h.to(x_t.dtype), params.gn_gain)
    return einsum("bhk,hkd->bd", y, params.w_out), new


def slstm_block(params: SLSTMParams, x: torch.Tensor, state: SLSTMState | None = None):
    """Training / prefill: the step over time. x [B, S, d] -> (y [B, S, d],
    the final ``SLSTMState``). The input projection, the head norm and the
    output projection of every step run batched over time, outside the
    recurrence (each step's value is the same; the reference scans the whole
    step). On DTensors it runs replicated: a step of the recurrence then
    costs no DTensor dispatch."""
    return replicated("slstm_block", _slstm_block, params, x, state)


def _slstm_block(params: SLSTMParams, x: torch.Tensor, state: SLSTMState | None):
    B, S, _ = x.shape
    st = state if state is not None else init_slstm_state(B, params.w.shape[2],
                                                          params.w.shape[3], x.device)
    pre = einsum("bsd,gdhk->gsbhk", x, params.w).float()
    hs = []
    for t in range(S):
        st = _slstm_cell(params, pre[:, t], st)
        hs.append(st.h)
    y = _head_norm(torch.stack(hs, dim=1).to(x.dtype), params.gn_gain)
    return einsum("bshk,hkd->bsd", y, params.w_out), st
