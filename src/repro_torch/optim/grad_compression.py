"""INT8 error-feedback gradient compression (port of
``repro/optim/grad_compression.py``): a gradient is quantized per tensor to
int8 after the residual of the previous step is added back, and the new
quantization residual is kept for the next (Karimireddy et al., 2019), so
the sum of the decompressed gradients tracks the true sum. The math is
device-agnostic; the multi-device reduction that would carry the payload
is not ported (single device)."""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map, tree_unflatten


class EFState(NamedTuple):
    residual: Any      # tree like the gradients, float32


def init_ef_state(grads_like) -> EFState:
    return EFState(tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads_like))


def compress(g: torch.Tensor, residual: torch.Tensor):
    """g + residual -> (int8 payload, float32 scale, new residual)."""
    corrected = g.float() + residual
    amax = torch.amax(torch.abs(corrected))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_residual = corrected - q.float() * scale
    return q, scale, new_residual


def decompress(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


class Payload(NamedTuple):
    """One compressed leaf: the int8 codes and their scale."""
    q: torch.Tensor
    scale: torch.Tensor


def compress_tree(grads, state: EFState):
    """(a tree like ``grads`` of ``Payload``, the new ``EFState``)."""
    out = [compress(g, r) for g, r in zip(tree_leaves(grads), tree_leaves(state.residual))]
    payload = tree_unflatten(grads, iter([Payload(q, s) for q, s, _ in out]))
    return payload, EFState(tree_unflatten(grads, iter([r for _, _, r in out])))


def decompress_tree(payload):
    """The float32 tree a ``compress_tree`` payload stands for."""
    if isinstance(payload, Payload):
        return decompress(*payload)
    if isinstance(payload, dict):
        return {k: decompress_tree(v) for k, v in payload.items()}
    if isinstance(payload, tuple) and hasattr(payload, "_fields"):
        return type(payload)(*(decompress_tree(v) for v in payload))
    if isinstance(payload, (list, tuple)):
        return type(payload)(decompress_tree(v) for v in payload)
    return payload

