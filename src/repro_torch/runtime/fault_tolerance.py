"""Fault-tolerance runtime: preemption handling + checkpoint/restart loop
(a copy of ``repro/runtime/fault_tolerance.py``; it imports nothing of JAX).

Production semantics implemented here and exercised in tests:

* ``PreemptionHandler`` — installs a SIGTERM/SIGINT handler that sets a flag;
  the serving engine's run loop snapshots at the next step boundary and exits cleanly
  (the pattern for Borg/K8s preemption notices and maintenance events).
* ``run_with_restarts`` — supervisor that restarts the step loop from the
  latest checkpoint after a (simulated or real) failure, up to a retry
  budget.
"""
from __future__ import annotations

import dataclasses
import random
import signal
import time
from typing import Callable


class PreemptionHandler:
    def __init__(self, install: bool = True):
        self.requested = False
        self._prev = {}
        if install:
            for sig in (signal.SIGTERM, signal.SIGINT):
                try:
                    self._prev[sig] = signal.signal(sig, self._handle)
                except ValueError:   # not main thread (tests)
                    pass

    def _handle(self, signum, frame):
        self.requested = True

    def trigger(self):               # for tests / manual drills
        self.requested = True

    def reset(self):
        """Clear the flag for the next attempt of a restart loop (the
        handler stays installed). Without this, a restored attempt would
        observe the PREVIOUS preemption and immediately re-exit."""
        self.requested = False

    def restore(self):
        """Reinstall the signal handlers that were active before this
        handler was installed. A previous disposition captured as ``None``
        (handler set outside Python) cannot be reinstalled from Python —
        fall back to SIG_DFL rather than raising mid-teardown; likewise a
        non-main-thread teardown is a no-op, mirroring install."""
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev if prev is not None else
                              signal.SIG_DFL)
            except ValueError:       # not main thread (tests)
                pass
        self._prev = {}


@dataclasses.dataclass
class RestartPolicy:
    """Retry budget + backoff schedule for ``run_with_restarts``.

    ``delay(attempt)`` is exponential with a cap and optional full jitter:
    ``min(backoff_s * backoff_factor**(attempt-1), max_backoff_s)`` scaled
    by U[1-jitter, 1] (thundering-herd spreading for co-preempted workers;
    ``seed`` pins the draw for deterministic tests)."""
    max_restarts: int = 3
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 30.0
    jitter: float = 0.0              # in [0, 1): fraction of spread
    seed: int | None = None

    def __post_init__(self):
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int) -> float:
        if self.backoff_s <= 0.0:
            return 0.0
        d = min(self.backoff_s * self.backoff_factor ** max(attempt - 1, 0),
                self.max_backoff_s)
        if self.jitter > 0.0:
            d *= 1.0 - self.jitter * self._rng.random()
        return d


def run_with_restarts(step_loop: Callable[[], str], policy: RestartPolicy,
                      on_restart: Callable[[int], None] | None = None) -> str:
    """Run ``step_loop`` (returns "done"/"preempted") restarting on exceptions.

    ``step_loop`` is expected to resume from the latest checkpoint itself
    (see launch/serve.run_engine --restartable); this
    supervisor only bounds the retry budget and paces the restarts.
    """
    attempts = 0
    while True:
        try:
            return step_loop()
        except Exception:
            attempts += 1
            if attempts > policy.max_restarts:
                raise
            if on_restart:
                on_restart(attempts)
            delay = policy.delay(attempts)
            if delay:
                time.sleep(delay)
