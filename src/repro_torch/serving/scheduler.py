"""Request lifecycle + FCFS slot scheduler for the continuous-batching engine.

A copy of ``repro/serving/scheduler.py`` (the port imports nothing of the JAX package).

Lifecycle::

    QUEUED --admit--> PREFILLING --chunks--> DECODE --EOS/max_new--> DONE
      |  ^                 |                    |
      |  +--- evict-to-requeue (pages freed; ---+---> FAILED (quarantine /
      |       generated tokens kept)                  deadline cancel)
      +--> REJECTED (bounded-queue load shedding at submit)

Admission is strict FCFS: the head of the queue is admitted as soon as (a) a
batch slot is free and (b) the allocator can cover its prompt's non-shared
pages; if the head cannot be admitted nothing behind it is considered (no
head-of-line skipping — later requests never starve an earlier one of pages).
A request evicted under pool pressure is NOT terminal: its pages are freed
and it re-enters the queue (at the back, so it cannot immediately re-trigger
the eviction that displaced it) with its generated-so-far tokens kept; on
readmission it replay-prefills ``effective_prompt`` (prompt + generated
tokens already landed in the cache) and resumes decoding from its pending
last token.

Failure isolation is per request, never per process: ``fail`` frees the
victim's pages, records a typed ``fail_reason`` ("nonfinite", "deadline",
"nonfinite_prefill", ...) and keeps the partial tokens in the terminal
result; ``reject`` is the bounded-admission-queue load-shedding path (the
request never held pages). Deadlines are virtual (engine steps, relative to
``arrival``): a TTFT deadline covers submit → first token, a total deadline
covers submit → finish. Blown deadlines make a request the PREFERRED
eviction victim (cancelling it frees pages mid-decode for requests that can
still meet theirs) before eviction falls back to youngest-first requeue.

Slots are positions in the fixed ``max_batch`` the decode step runs
over; finished slots are recycled in place (the engine zeroes the
slot's page-table row onto the scratch page), so the decode step always sees
static shapes and the active set is carried as a mask — the same pinning
idea the fused scan uses for EOS-finished rows. A PREFILLING request holds
its slot while its chunk cursor (``prefill_pos``) walks the prompt, but the
decode step sees that slot parked on the scratch page until the cursor
reaches the end.

Host-side bookkeeping only; nothing here touches the device.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque

import numpy as np


class Status(enum.Enum):
    QUEUED = "queued"
    PREFILLING = "prefilling"      # chunk cursor mid-prompt (holds a slot)
    DECODE = "decode"
    DONE = "done"
    FAILED = "failed"              # terminal: quarantined / deadline-cancelled
    REJECTED = "rejected"          # terminal: bounded-queue load shedding


@dataclasses.dataclass
class Request:
    """One generation request plus its runtime bookkeeping."""

    rid: int
    prompt: np.ndarray             # [S] int32 prompt tokens
    max_new: int                   # tokens to generate (incl. the prefill one)
    arrival: float = 0.0           # virtual arrival time (engine steps)
    # deadlines, in VIRTUAL steps relative to arrival (None = no deadline):
    # ttft_deadline covers submit -> first token, deadline covers submit ->
    # finish. Enforcement: blown-TTFT requests still waiting (queued or
    # prefilling) are cancelled at the step sweep; blown requests mid-decode
    # become the preferred eviction victim (cancel, not requeue) but are
    # otherwise allowed to finish late (grace) — killing a request about to
    # complete wastes more pool time than shipping a late answer.
    ttft_deadline: int | None = None
    deadline: int | None = None

    status: Status = Status.QUEUED
    fail_reason: str = ""          # typed reason for FAILED/REJECTED results
    slot: int = -1                 # batch slot while PREFILLING/DECODE
    pages: list[int] = dataclasses.field(default_factory=list)
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    prefill_pos: int = 0           # chunk cursor into effective_prompt
    # leading effective-prompt tokens whose pages were already resident at
    # admission (radix prefix-cache hit, including host-tier restores): the
    # engine's chunked prefill starts AFTER them — TTFT tracks the uncached
    # suffix. Set by ``admit`` from the allocator's match.
    cached_tokens: int = 0
    requeues: int = 0              # evict-to-requeue round trips
    # timing (virtual steps; the engine also records wall-clock spans)
    admit_step: int = -1
    first_token_step: int = -1     # TTFT = first_token_step - arrival
    finish_step: int = -1
    arrival_work: int = 0          # engine work units (tokens) at submit
    first_token_work: int = -1     # engine work units at first token

    @property
    def prompt_len(self) -> int:
        return int(len(self.prompt))

    @property
    def effective_prompt(self) -> np.ndarray:
        """What (re)admission must land in the cache: the prompt plus every
        generated token that had been appended before eviction. The LAST
        sampled token is never appended (the next decode step feeds it), so
        it stays pending in the engine's ``last_tok`` slot instead."""
        if not self.out_tokens:
            return self.prompt
        return np.concatenate([
            self.prompt, np.asarray(self.out_tokens[:-1], np.int32)])

    @property
    def seq_len(self) -> int:
        """Tokens resident in the cache: prompt + generated-and-appended.
        The latest sampled token is appended by the NEXT decode step, so it
        is not counted until then."""
        return self.prompt_len + max(len(self.out_tokens) - 1, 0)

    @property
    def done(self) -> bool:
        return self.status is Status.DONE

    # -- deadlines (virtual steps) ------------------------------------------

    def ttft_blown(self, step: int) -> bool:
        """TTFT deadline passed with no first token emitted yet."""
        return (self.ttft_deadline is not None
                and self.first_token_step < 0
                and step - self.arrival > self.ttft_deadline)

    def deadline_blown(self, step: int) -> bool:
        """Total-latency deadline passed without finishing."""
        return (self.deadline is not None
                and step - self.arrival > self.deadline)

    def any_deadline_blown(self, step: int) -> bool:
        return self.ttft_blown(step) or self.deadline_blown(step)


class Scheduler:
    """FCFS admission into a fixed slot array, with a bounded queue."""

    def __init__(self, max_batch: int, max_queue: int = 0):
        self.max_batch = int(max_batch)
        # admission-queue bound (0 = unbounded): load shedding happens at
        # submit time via ``reject`` instead of queueing without limit.
        # Internal requeues (evict-to-requeue) bypass the bound — the work
        # already admitted once is never shed.
        self.max_queue = int(max_queue)
        self.queue: deque[Request] = deque()
        self.slots: list[Request | None] = [None] * self.max_batch
        self.finished: list[Request] = []
        self.requeues = 0              # cumulative evict-to-requeue count

    # -- queue --------------------------------------------------------------

    @property
    def queue_full(self) -> bool:
        return bool(self.max_queue) and len(self.queue) >= self.max_queue

    def submit(self, req: Request) -> None:
        req.status = Status.QUEUED
        self.queue.append(req)

    def reject(self, req: Request, step: int, reason: str) -> None:
        """Typed load-shedding: the request is terminal REJECTED without
        ever holding a slot or pages."""
        req.status, req.fail_reason = Status.REJECTED, reason
        req.finish_step = step
        self.finished.append(req)

    @property
    def num_active(self) -> int:
        return sum(1 for r in self.slots if r is not None)

    @property
    def active(self) -> list[Request]:
        return [r for r in self.slots if r is not None]

    @property
    def prefilling(self) -> list[Request]:
        """PREFILLING requests in admission order (the chunk scheduler's
        FCFS round-robin order)."""
        return sorted((r for r in self.slots
                       if r is not None and r.status is Status.PREFILLING),
                      key=lambda r: (r.admit_step, r.rid))

    @property
    def drained(self) -> bool:
        return not self.queue and self.num_active == 0

    def _free_slot(self) -> int:
        for i, r in enumerate(self.slots):
            if r is None:
                return i
        return -1

    # -- admission / retirement --------------------------------------------

    def admit(self, allocator, step: int) -> list[Request]:
        """Admit queue-head requests while a slot is free and the allocator
        covers their (effective) prompts. Admitted requests get a slot +
        page run, a reset chunk cursor, and move to PREFILLING; the engine
        then runs their prefill (monolithically or chunk by chunk)."""
        admitted: list[Request] = []
        while self.queue:
            slot = self._free_slot()
            if slot < 0:
                break
            head = self.queue[0]
            pages = allocator.alloc_prompt(head.effective_prompt)
            if pages is None:
                break                      # strict FCFS: no skipping past head
            self.queue.popleft()
            head.status = Status.PREFILLING
            head.slot, head.pages, head.admit_step = slot, pages, step
            head.prefill_pos = 0
            head.cached_tokens = getattr(pages, "cached_tokens", 0)
            self.slots[slot] = head
            admitted.append(head)
        return admitted

    def retire(self, req: Request, step: int, allocator) -> None:
        """DONE: release pages, recycle the slot in place."""
        allocator.free(req.pages)
        req.pages = []
        req.status, req.finish_step = Status.DONE, step
        if req.slot >= 0:
            self.slots[req.slot] = None
            req.slot = -1
        self.finished.append(req)

    def fail(self, req: Request, step: int, allocator, reason: str) -> None:
        """Terminal per-request failure isolation: pages freed, slot
        recycled, partial tokens kept on the request, typed ``reason``
        recorded — every OTHER slot keeps decoding. Handles requests in any
        pre-terminal state (queued, prefilling, decoding)."""
        if req.status is Status.QUEUED:
            self.queue.remove(req)
        if req.pages:
            allocator.free(req.pages)
            req.pages = []
        req.status, req.fail_reason = Status.FAILED, reason
        req.finish_step = step
        if req.slot >= 0:
            self.slots[req.slot] = None
            req.slot = -1
        self.finished.append(req)

    def requeue(self, req: Request, allocator) -> None:
        """Evict-to-requeue: free the pages, keep the generated tokens, and
        send the request to the BACK of the queue (so it cannot instantly
        re-trigger the eviction that displaced it). Its next admission
        replay-prefills ``effective_prompt``."""
        allocator.free(req.pages)
        req.pages = []
        req.prefill_pos = 0
        req.requeues += 1
        self.requeues += 1
        if req.slot >= 0:
            self.slots[req.slot] = None
            req.slot = -1
        self.submit(req)

    def eviction_victim(self, step: int | None = None) -> Request | None:
        """Victim choice under pool exhaustion. A request that has already
        blown a deadline is preferred (most-blown first — its pool pages are
        doing the least good; the engine CANCELS it rather than requeueing,
        freeing pages mid-decode), falling back to the youngest active
        request (latest admission — FCFS fairness) when every deadline is
        still live."""
        active = self.active
        if not active:
            return None
        if step is not None:
            blown = [r for r in active if r.any_deadline_blown(step)]
            if blown:
                # most overdue relative to its tightest blown deadline
                def overdue(r):
                    d = min((x for x in (r.ttft_deadline, r.deadline)
                             if x is not None), default=0)
                    return (step - r.arrival - d, r.rid)
                return max(blown, key=overdue)
        return max(active, key=lambda r: (r.admit_step, r.rid))
