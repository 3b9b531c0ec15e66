"""Straggler detection for synchronous training (a copy of
``repro/runtime/straggler.py``; numpy only).

In a synchronous step one slow host drags the whole fleet. Each host keeps
an EWMA of its step wall time; a host whose EWMA exceeds ``threshold`` times
the fleet median is flagged (after ``warmup_steps``). The production action
— a hot-spare swap and an elastic restart from the latest checkpoint — is
policy outside this module; the single-device training loop feeds it its
own step times."""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class StragglerConfig:
    ewma_alpha: float = 0.2
    threshold: float = 1.5       # x fleet median
    warmup_steps: int = 5        # ignore the first steps (allocation, warm-up)


class StragglerDetector:
    def __init__(self, cfg: StragglerConfig, n_hosts: int):
        self.cfg = cfg
        self.n_hosts = n_hosts
        self.ewma = np.zeros(n_hosts)
        self.steps = 0
        self.flagged: list[tuple[int, int]] = []   # (step, host)

    def update(self, per_host_times: np.ndarray) -> list[int]:
        """per_host_times [n_hosts] seconds for this step -> flagged hosts."""
        self.steps += 1
        a = self.cfg.ewma_alpha
        if self.steps == 1:
            self.ewma = per_host_times.astype(float).copy()
        else:
            self.ewma = (1 - a) * self.ewma + a * per_host_times
        if self.steps <= self.cfg.warmup_steps:
            return []
        med = float(np.median(self.ewma))
        slow = [h for h in range(self.n_hosts)
                if self.ewma[h] > self.cfg.threshold * med]
        for h in slow:
            self.flagged.append((self.steps, h))
        return slow
