"""AdamW with global-norm clipping (port of ``repro/optim/adamw.py``), over
any tree of tensors (nested dicts, lists and NamedTuples; None leaves are
structure). Moments, bias correction and the decoupled weight decay are in
float32, as in the reference; each parameter keeps its dtype.

``tree_leaves`` / ``tree_unflatten`` walk a tree in the reference's leaf
order (``jax.tree`` flattens a dict in sorted key order)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterator, NamedTuple

import torch


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensor leaves of ``tree``, dict keys in sorted order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return []


def tree_unflatten(like: Any, leaves: Iterator[Any]) -> Any:
    """``like`` with its tensor leaves replaced, in ``tree_leaves`` order, by
    the next items of ``leaves`` (tensors, or any object)."""
    if isinstance(like, torch.Tensor):
        return next(leaves)
    if isinstance(like, dict):
        new = {k: tree_unflatten(like[k], leaves) for k in sorted(like)}
        return {k: new[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(tree_unflatten(v, leaves) for v in like))
    if isinstance(like, (list, tuple)):
        return type(like)(tree_unflatten(v, leaves) for v in like)
    return like


def tree_map(fn: Callable[[torch.Tensor], torch.Tensor], tree: Any) -> Any:
    return tree_unflatten(tree, iter([fn(x) for x in tree_leaves(tree)]))


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor       # 0-d int32
    mu: Any                  # tree like the parameters, float32
    nu: Any


def init_adamw(params) -> AdamWState:
    def zeros(p):
        return torch.zeros_like(p, dtype=torch.float32)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    return AdamWState(step=step, mu=tree_map(zeros, params), nu=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, over the leaves in order, of each leaf's float32 sum
    of squares."""
    total = 0
    for leaf in tree_leaves(tree):
        total = total + torch.sum(torch.square(leaf.float()))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads, state: AdamWState, params, lr_scale=1.0):
    """(new_params, new_state, {"grad_norm", "lr"}): the gradients clipped to
    global norm ``grad_clip``, then AdamW with bias correction and decoupled
    weight decay (adamw.py:44-72). ``lr_scale`` is a float or a 0-d float32
    tensor (``warmup_cosine``)."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    b1c = 1.0 - torch.pow(cfg.b1, step.float())
    b2c = 1.0 - torch.pow(cfg.b2, step.float())
    lr = cfg.lr * lr_scale

    def upd(g, m, v, p):
        g = g.float() * clip
        m_new = cfg.b1 * m + (1 - cfg.b1) * g
        v_new = cfg.b2 * v + (1 - cfg.b2) * g * g
        mhat = m_new / b1c
        vhat = v_new / b2c
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + cfg.weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m_new, v_new

    out = [upd(*x) for x in zip(tree_leaves(grads), tree_leaves(state.mu),
                                tree_leaves(state.nu), tree_leaves(params))]
    new_p, new_m, new_v = (tree_unflatten(params, iter([o[i] for o in out]))
                           for i in range(3))
    lr = torch.as_tensor(lr, dtype=torch.float32, device=gnorm.device)
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm, "lr": lr}
