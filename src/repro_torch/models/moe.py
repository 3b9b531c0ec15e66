"""Token-choice top-k Mixture-of-Experts with capacity-based sort dispatch
(port of ``repro/models/moe.py``).

Tokens are routed to their top-k experts, packed into an [E, C, d] buffer by
a stable sort of the flat expert ids (no [T, E, C] one-hot tensors), run
through the stacked expert MLPs and combined with the router weights. Pairs
past an expert's capacity ``C`` are dropped; the dropped fraction is returned
as a tensor on the device (no host sync).

``C = max(1, int(T * k * capacity_factor / E))`` is a Python int from the
shapes: it depends on how many tokens ``T`` share the call, so every row the
caller routes (idle serving slots, padded chunk tails) takes part, as in the
reference. The expert products are batched matmuls over every expert of the
buffer, as the reference's einsums are: a decode step reads all expert
weights.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.placement import replicated
from repro_torch.models.layers import _ACTS, _normal


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    n_shared_experts: int = 0      # deepseek-style always-on shared expert(s)
    renorm_topk: bool = True       # renormalize the top-k router weights to sum 1


class MoEParams(NamedTuple):
    w_router: torch.Tensor               # [d, E]
    w_gate: torch.Tensor                 # [E, d, f]
    w_up: torch.Tensor                   # [E, d, f]
    w_down: torch.Tensor                 # [E, f, d]
    shared_gate: torch.Tensor | None     # [d, f_shared]
    shared_up: torch.Tensor | None
    shared_down: torch.Tensor | None


def init_moe_params(gen: torch.Generator, d: int, cfg: MoEConfig, dtype=torch.float32,
                    device=None) -> MoEParams:
    E, f = cfg.n_experts, cfg.d_ff_expert
    fs = f * cfg.n_shared_experts

    def init(shape, fan_in):
        return _normal(gen, shape, fan_in ** -0.5, dtype, device)

    return MoEParams(
        w_router=init((d, E), d),
        w_gate=init((E, d, f), d),
        w_up=init((E, d, f), d),
        w_down=init((E, f, d), f),
        shared_gate=init((d, fs), d) if fs else None,
        shared_up=init((d, fs), d) if fs else None,
        shared_down=init((fs, d), fs) if fs else None,
    )


def _route(params: MoEParams, cfg: MoEConfig, xt: torch.Tensor):
    """Router in float32: softmax, top-k (ties to the lower expert id, as
    ``jax.lax.top_k``: a stable descending sort), optional renormalisation.
    Returns (weights [T, k], ids [T, k])."""
    probs = torch.softmax(xt.float() @ params.w_router.float(), dim=-1)      # [T, E]
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :cfg.top_k], ids[:, :cfg.top_k]
    if cfg.renorm_topk:
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)
    return weights, ids


def _shared(params: MoEParams, xt: torch.Tensor, act) -> torch.Tensor:
    hs = act(xt @ params.shared_gate) * (xt @ params.shared_up)
    return hs @ params.shared_down


def _dispatch(xt: torch.Tensor, ids: torch.Tensor, E: int, C: int, k: int):
    """Sort-based dispatch: the rank of each (token, choice) pair within its
    expert, in token order; pairs at rank >= C go to the overflow row E*C.
    Returns (the expert buffer [E, C, d], each pair's row ``dest``, ``keep``
    and ``sort_idx``, all in sorted pair order)."""
    T, d = xt.shape
    flat_ids = ids.reshape(-1)                                       # [T*k]
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[sort_idx]
    first_of_expert = torch.searchsorted(sorted_ids, sorted_ids, side="left")
    rank = torch.arange(T * k, device=xt.device) - first_of_expert
    keep = rank < C
    dest = torch.where(keep, sorted_ids * C + rank, E * C)
    token_of = sort_idx // k
    # every dropped pair writes zeros into the overflow row, so the
    # duplicate indices there leave a defined result
    buf = torch.zeros((E * C + 1, d), dtype=xt.dtype, device=xt.device)
    buf[dest] = xt[token_of] * keep[:, None].to(xt.dtype)
    return buf[:E * C].reshape(E, C, d), dest, keep, sort_idx


def _combine(eout: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
             sort_idx: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Back to (token, choice) order, weighted by the router: [T, d]."""
    E, C, d = eout.shape
    T, k = weights.shape
    flat_out = torch.cat([eout.reshape(E * C, d),
                          torch.zeros((1, d), dtype=eout.dtype, device=eout.device)])
    pair_out = flat_out[dest] * keep[:, None].to(eout.dtype)         # sorted order
    unsorted = torch.zeros((T * k, d), dtype=eout.dtype, device=eout.device)
    unsorted[sort_idx] = pair_out
    return torch.einsum("tkd,tk->td", unsorted.reshape(T, k, d), weights.to(eout.dtype))


def moe_layer(params: MoEParams, cfg: MoEConfig, x: torch.Tensor,
              act: str = "silu") -> tuple[torch.Tensor, torch.Tensor]:
    """x [..., T, d] -> (out [..., T, d], dropped fraction, a 0-d float32
    tensor). ``act`` names the activation (``"silu"`` or ``"gelu"``, the
    tanh form)."""
    fn = _ACTS[act]
    d = x.shape[-1]
    xt = x.reshape(-1, d)                                            # [T, d]
    T = xt.shape[0]
    E, k = cfg.n_experts, cfg.top_k
    weights, ids = _route(params, cfg, xt)
    C = max(1, int(T * k * cfg.capacity_factor / E))
    # the sort dispatch and the combine index by data-dependent rows, which
    # DTensor cannot shard: on DTensors they run replicated
    buf, dest, keep, sort_idx = replicated(
        "moe_dispatch", lambda a, b: _dispatch(a, b, E, C, k), xt, ids)

    # the stacked expert MLPs (batched over every expert of the buffer)
    h = fn(torch.bmm(buf, params.w_gate)) * torch.bmm(buf, params.w_up)
    eout = torch.bmm(h, params.w_down)                               # [E, C, d]
    out = replicated("moe_combine", _combine, eout, dest, keep, sort_idx, weights)

    if params.shared_gate is not None:
        out = out + _shared(params, xt, fn)
    return out.reshape(x.shape), _dropped_fraction(keep)


def _dropped_fraction(keep: torch.Tensor) -> torch.Tensor:
    """``1 - mean(keep)`` as XLA compiles it: the mean is the count times
    float32(1/n), and the subtraction is fused with that product into one
    rounding (an FMA). The float64 product of a count below 2^24 and a
    float32 is exact, so rounding ``1 - product`` to float32 gives the
    fused result."""
    inv_n = float(np.float32(1.0 / keep.numel()))
    return (1.0 - keep.sum(dtype=torch.float64) * inv_n).to(torch.float32)


def moe_ref_dense(params: MoEParams, cfg: MoEConfig, x: torch.Tensor,
                  act: str = "silu") -> torch.Tensor:
    """O(T*E) dense oracle: every expert for every token, masked to the
    top-k (tests only)."""
    fn = _ACTS[act]
    d = x.shape[-1]
    xt = x.reshape(-1, d)
    weights, ids = _route(params, cfg, xt)
    h = fn(torch.einsum("td,edf->tef", xt, params.w_gate)) * torch.einsum(
        "td,edf->tef", xt, params.w_up)
    every = torch.einsum("tef,efd->ted", h, params.w_down)          # [T, E, d]
    mask = torch.nn.functional.one_hot(ids, cfg.n_experts).to(every.dtype)   # [T, k, E]
    out = torch.einsum("tke,ted,tk->td", mask, every, weights.to(every.dtype))
    if params.shared_gate is not None:
        out = out + _shared(params, xt, fn)
    return out.reshape(x.shape)
