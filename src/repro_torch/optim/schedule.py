"""LR schedule (port of ``repro/optim/schedule.py``): linear warmup, then
cosine decay."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1) -> torch.Tensor:
    """An lr *scale* in [min_ratio, 1] (0-d float32; multiply by the base
    lr): ``step / warmup_steps`` while warming up, then the cosine from 1
    down to ``min_ratio`` at ``total_steps``."""
    step = torch.as_tensor(step, dtype=torch.float32)
    warm = step / max(warmup_steps, 1)
    prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(step < warmup_steps, warm, cos)
