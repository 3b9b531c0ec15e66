"""Deterministic fault-injection harness for the serving engine (a copy of
``repro/serving/faults.py``).

A ``FaultPlan`` is a *seeded, virtual-time* schedule of injected faults the
``ServingEngine`` consults at well-defined points of each step — the same
workload + seed + plan reproduces the exact fault sequence run-to-run, so
chaos tests can assert token-level outcomes (P-Cast shows FP8 E4M3
attention genuinely collapses under sink-heavy long contexts, so a NaN in a
slot's logits is an *expected* production event for an FP8 MLA cache, not a
can't-happen — the engine must degrade per request, and this harness is how
that degradation is pinned by tests and the ``serving_sim`` fault sweep).

Fault kinds (``FaultEvent.kind``):

* ``nan_logits`` — poison one slot's decode logits at engine step ``step``
  (after the decode dispatch, before postprocess), modelling a kernel/numerics
  fault. The engine's quarantine retries the row once on the plain
  reference backend: a non-``sticky`` event is recomputed clean (kernel fault →
  recovered), a ``sticky`` event poisons the retry too (genuinely divergent
  input → the request fails with reason "nonfinite").
* ``alloc_fail`` — force ``PageAllocator.grow`` to report exhaustion for
  ``count`` consecutive steps starting at ``step`` (drives the eviction /
  requeue / deadline-cancel machinery without needing a tiny pool).
* ``backend_raise`` — raise from the decode dispatch at ``step`` (before
  the donated buffers are consumed); the engine degrades the whole step to
  the plain reference backend and keeps going.
* ``preempt`` — trigger the ``PreemptionHandler`` at ``step``: the run loop
  snapshots to the checkpoint directory and raises ``EnginePreempted`` for
  ``runtime.fault_tolerance.run_with_restarts`` to restart-and-restore
  (the port's engine has no snapshot/restore yet: it parses this kind but
  ``serve`` refuses it).

Everything here is host-side and O(#events) per query — zero cost on the
fault-free path, and nothing leaks into device code.
"""
from __future__ import annotations

import dataclasses

import numpy as np

KINDS = ("nan_logits", "alloc_fail", "backend_raise", "preempt")


class EnginePreempted(Exception):
    """Raised by ``ServingEngine.run`` at a step boundary after a preemption
    request was observed and the state snapshotted; ``run_with_restarts``
    treats it like any failure and restarts the loop, which restores from
    the latest checkpoint."""


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    kind: str                      # one of KINDS
    step: int                      # engine step (virtual time) to fire at
    slot: int = 0                  # nan_logits: decode slot to poison
    sticky: bool = False           # nan_logits: poison the ref retry too
    count: int = 1                 # alloc_fail: consecutive steps affected

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(expected one of {KINDS})")
        if self.step < 0 or self.count < 1:
            raise ValueError("fault step must be >= 0 and count >= 1")


class FaultPlan:
    """A queryable schedule of ``FaultEvent``s plus a fired-event log.

    The engine asks point questions (``nan_slots`` / ``alloc_fail`` /
    ``backend_raise`` / ``preempt``) keyed by its step counter; every hit is
    recorded in ``fired`` (step, kind, slot) so metrics and tests can assert
    exactly which injections actually landed.
    """

    def __init__(self, events: list[FaultEvent] | tuple[FaultEvent, ...] = ()):
        self.events = list(events)
        self.fired: list[tuple[int, str, int]] = []

    def __bool__(self) -> bool:
        return bool(self.events)

    def _log(self, step: int, kind: str, slot: int = -1) -> None:
        self.fired.append((step, kind, slot))

    # -- point queries (one per engine injection site) ----------------------

    def nan_slots(self, step: int) -> list[FaultEvent]:
        """nan_logits events scheduled for this step (possibly several
        slots); firing is logged by the engine when a live row is hit."""
        return [e for e in self.events
                if e.kind == "nan_logits" and e.step == step]

    def retry_poisoned(self, step: int, slot: int) -> bool:
        """Does a sticky nan_logits event also poison the ref-backend retry
        of (step, slot)? (The 'genuinely divergent input' twin.)"""
        return any(e.kind == "nan_logits" and e.step == step
                   and e.slot == slot and e.sticky for e in self.events)

    def alloc_fail(self, step: int) -> bool:
        hit = any(e.kind == "alloc_fail"
                  and e.step <= step < e.step + e.count for e in self.events)
        if hit:
            self._log(step, "alloc_fail")
        return hit

    def backend_raise(self, step: int) -> bool:
        hit = any(e.kind == "backend_raise" and e.step == step
                  for e in self.events)
        if hit:
            self._log(step, "backend_raise")
        return hit

    def preempt(self, step: int) -> bool:
        hit = any(e.kind == "preempt" and e.step == step
                  for e in self.events)
        if hit:
            self._log(step, "preempt")
        return hit

    # -- construction -------------------------------------------------------

    @classmethod
    def random(cls, seed: int, n_steps: int, n_faults: int = 3,
               max_batch: int = 4,
               kinds: tuple[str, ...] = ("nan_logits", "alloc_fail"),
               sticky_ratio: float = 0.0) -> "FaultPlan":
        """Seeded random schedule for chaos storms: ``n_faults`` events drawn
        over ``[1, n_steps)`` x ``kinds`` x slots. Same seed, same schedule."""
        rng = np.random.default_rng(seed)
        events = []
        for _ in range(n_faults):
            kind = str(rng.choice(list(kinds)))
            events.append(FaultEvent(
                kind=kind,
                step=int(rng.integers(1, max(n_steps, 2))),
                slot=int(rng.integers(0, max_batch)),
                sticky=bool(rng.random() < sticky_ratio),
                count=int(rng.integers(1, 3)) if kind == "alloc_fail" else 1))
        return cls(events)

    @classmethod
    def parse(cls, specs: list[str]) -> "FaultPlan":
        """CLI form: each spec is ``kind:step[:slot][:sticky]`` (alloc_fail
        uses the third field as ``count``), e.g. ``nan_logits:3:0:sticky``,
        ``alloc_fail:2:3``, ``preempt:4``. Used by ``serve --inject``."""
        events = []
        for spec in specs:
            parts = spec.split(":")
            kind, step = parts[0], int(parts[1])
            third = int(parts[2]) if len(parts) > 2 else 0
            sticky = len(parts) > 3 and parts[3] == "sticky"
            if kind == "alloc_fail":
                events.append(FaultEvent(kind, step, count=max(third, 1)))
            else:
                events.append(FaultEvent(kind, step, slot=third,
                                         sticky=sticky))
        return cls(events)
