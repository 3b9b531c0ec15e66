"""Per-request span tracing with Chrome trace-event export (a copy of
``repro/obs/trace.py``, which imports nothing of JAX; the port keeps its own).

The engine emits three kinds of events into a :class:`SpanTracer`:

  * **request lifecycle spans** — one track (thread) per request id:
    ``QUEUED -> PREFILL -> DECODE`` duration spans, ``PREFILL(chunk i)``
    sub-spans for chunked admission, and ``FIRST_TOKEN`` / ``DONE`` /
    ``FAILED(reason)`` / ``REJECTED`` / ``EVICTED`` instants;
  * **engine step-phase spans** — admit / tier_drain / prefill / decode /
    postprocess / retire windows on the engine track, one per step in which
    the phase did work;
  * **counter samples** — per-step pool occupancy (Chrome ``C`` events, so
    Perfetto draws the page-utilization area chart directly).

CLOCKS.  The default clock is **virtual**: one engine step is
``TICKS_PER_STEP`` (1000) microsecond-ticks, and each step phase owns a
fixed sub-window (``PHASE_WINDOWS``). Timestamps are therefore pure
functions of the engine's step counter — a seeded run exports a
byte-identical trace on any machine, and integer-dividing any request
event's ts by ``TICKS_PER_STEP`` recovers the exact engine step, so the
trace REPRODUCES the engine's reported TTFT / latency (in steps) rather
than approximating them. ``clock="wall"`` stamps real microseconds instead
(readable, not reproducible; never used by CI): host time when the engine
emits the event, at step boundaries — each engine step ends in its one
device-to-host transfer, so host time there has caught up with the device.

The exporter (:meth:`SpanTracer.chrome_payload`) emits the Chrome
trace-event JSON format (``traceEvents`` array of ``X``/``i``/``C``/``M``
events) that chrome://tracing and https://ui.perfetto.dev load directly.
All spans must be closed at export; an open span at export time is a
lifecycle-accounting bug and raises.

Tracer state (events, open spans, the span-id cursor) rides
``export_state``/``restore_state`` through engine checkpoints, so a
preempted-and-restored run continues the SAME trace: span ids stay unique
and the resumed steps append exactly where the snapshot stopped.

PROFILER SPANS.  :class:`span` is the other half of the module: a host range
recorded into ``torch.profiler``'s trace, on the clock of the device kernels
the profiler records beside it, so an idle gap on the device can be put down
to the host phase it fell in (the fused decode loop's ``snapmla.round.*``,
``launch/steps.make_fused_decode``). It opens a function-scope range
(``torch._C._profiler._RecordFunctionFast``), not ``record_function``'s
user-scope one: Kineto adds a device-side annotation to a user-scope range,
spanning the kernels it launched, which a trace reader would take for a
kernel. It never synchronizes and never allocates; with no profiler
recording it reads the clock twice and checks the profiler's state. Its own
``time.perf_counter`` reads at entry and exit (``t0``, ``t1``, ``s``) are
what the caller's host timings take, so the trace and the caller's numbers
come from the same boundaries.
"""
from __future__ import annotations

import json
import time
from typing import Any

from torch._C._profiler import _RecordFunctionFast

TICKS_PER_STEP = 1000
# fixed per-step sub-windows (virtual clock): [begin, end) tick offsets
PHASE_WINDOWS: dict[str, tuple[int, int]] = {
    "admit": (0, 100),
    "tier_drain": (100, 150),
    "prefill": (150, 450),
    "decode": (450, 750),
    "postprocess": (750, 850),
    "retire": (850, 1000),
}
# point offsets for request lifecycle edges (all < TICKS_PER_STEP, so
# ts // TICKS_PER_STEP is always the emitting step)
OFF_ADMIT = 50            # QUEUED -> PREFILL transition
OFF_DECODE = 445          # PREFILL -> DECODE transition (prefill window end)
OFF_FIRST_TOKEN = 780     # FIRST_TOKEN instant (postprocess window)
OFF_RETIRE = 860          # span close + DONE instant
OFF_FAIL = 870            # span close + FAILED/REJECTED instant
OFF_EVICT = 855           # span close + EVICTED instant, QUEUED reopens
# chunk sub-spans tile the prefill window: 6 ticks per chunk, clamped so
# the last tile still closes before the PREFILL span's DECODE transition
# at offset 445
_CHUNK_W = 6
_CHUNK_MAX = (PHASE_WINDOWS["prefill"][1]
              - PHASE_WINDOWS["prefill"][0]) // _CHUNK_W - 2

ENGINE_PID = 1
REQUEST_PID = 2


class SpanTracer:
    """Collects engine/request events; exports Chrome trace JSON."""

    def __init__(self, clock: str = "virtual"):
        if clock not in ("virtual", "wall"):
            raise ValueError(f"clock must be 'virtual' or 'wall': {clock!r}")
        self.clock = clock
        self._t0 = time.time()
        self._next_sid = 1
        self._events: list[dict] = []
        # rid -> open lifecycle span {sid, name, ts, args}
        self._open: dict[int, dict] = {}
        # rid -> chunks traced so far (names the PREFILL(chunk i) sub-spans)
        self._chunks: dict[int, int] = {}
        # per-step cursor slotting chunk sub-spans side by side
        self._step_chunk_cursor: tuple[int, int] = (-1, 0)

    # ------------------------------------------------------------------
    # clocks
    # ------------------------------------------------------------------

    def ts(self, step: int, offset: int = 0) -> int:
        """Virtual: ``step * TICKS_PER_STEP + offset`` ticks. Wall: real
        microseconds since tracer creation (offset ignored)."""
        if self.clock == "virtual":
            return step * TICKS_PER_STEP + offset
        return int((time.time() - self._t0) * 1e6)

    def _sid(self) -> int:
        sid = self._next_sid
        self._next_sid += 1
        return sid

    # ------------------------------------------------------------------
    # engine track
    # ------------------------------------------------------------------

    def step_phase(self, step: int, phase: str,
                   args: dict[str, Any] | None = None) -> None:
        """One step-phase window as a complete span on the engine track."""
        begin, end = PHASE_WINDOWS[phase]
        if self.clock == "virtual":
            ts, dur = self.ts(step, begin), end - begin
        else:
            ts, dur = self.ts(step), 0
        self._events.append({
            "name": phase, "ph": "X", "ts": ts, "dur": dur,
            "pid": ENGINE_PID, "tid": 0, "cat": "phase",
            "args": {"step": step, **(args or {})}, "sid": self._sid()})

    def counter(self, step: int, name: str,
                values: dict[str, int | float]) -> None:
        """Chrome 'C' sample (Perfetto renders a stacked area chart)."""
        self._events.append({
            "name": name, "ph": "C",
            "ts": self.ts(step, TICKS_PER_STEP - 1),
            "pid": ENGINE_PID, "tid": 0, "args": dict(values),
            "sid": self._sid()})

    def engine_instant(self, step: int, offset: int, name: str,
                       args: dict[str, Any] | None = None) -> None:
        self._events.append({
            "name": name, "ph": "i", "ts": self.ts(step, offset), "s": "g",
            "pid": ENGINE_PID, "tid": 0, "cat": "fault",
            "args": {"step": step, **(args or {})}, "sid": self._sid()})

    # ------------------------------------------------------------------
    # request track
    # ------------------------------------------------------------------

    def req_begin(self, rid: int, name: str, ts: int,
                  args: dict[str, Any] | None = None) -> None:
        """Open the request's next lifecycle span (QUEUED/PREFILL/DECODE).
        A request has at most one open span; opening over an open span is a
        lifecycle bug and raises."""
        if rid in self._open:
            raise RuntimeError(
                f"request {rid}: span {self._open[rid]['name']!r} still "
                f"open while beginning {name!r}")
        self._open[rid] = {"sid": self._sid(), "name": name, "ts": ts,
                           "args": dict(args or {})}

    def req_end(self, rid: int, ts: int,
                args: dict[str, Any] | None = None) -> None:
        span = self._open.pop(rid, None)
        if span is None:
            return
        self._events.append({
            "name": span["name"], "ph": "X", "ts": span["ts"],
            "dur": max(ts - span["ts"], 0), "pid": REQUEST_PID, "tid": rid,
            "cat": "request", "args": {**span["args"], **(args or {})},
            "sid": span["sid"]})

    def req_transition(self, rid: int, name: str, ts: int,
                       args: dict[str, Any] | None = None) -> None:
        self.req_end(rid, ts)
        self.req_begin(rid, name, ts, args)

    def req_instant(self, rid: int, name: str, ts: int,
                    args: dict[str, Any] | None = None) -> None:
        self._events.append({
            "name": name, "ph": "i", "ts": ts, "s": "t",
            "pid": REQUEST_PID, "tid": rid, "cat": "request",
            "args": dict(args or {}), "sid": self._sid()})

    def req_chunk(self, rid: int, step: int,
                  args: dict[str, Any] | None = None) -> None:
        """One PREFILL(chunk i) sub-span, tiled inside the step's prefill
        window in execution order."""
        cur_step, k = self._step_chunk_cursor
        if cur_step != step:
            k = 0
        self._step_chunk_cursor = (step, k + 1)
        i = self._chunks.get(rid, 0)
        self._chunks[rid] = i + 1
        off = PHASE_WINDOWS["prefill"][0] + _CHUNK_W * min(k, _CHUNK_MAX)
        if self.clock == "virtual":
            ts, dur = self.ts(step, off), _CHUNK_W
        else:
            ts, dur = self.ts(step), 0
        self._events.append({
            "name": f"PREFILL(chunk {i})", "ph": "X", "ts": ts, "dur": dur,
            "pid": REQUEST_PID, "tid": rid, "cat": "request",
            "args": {"step": step, **(args or {})}, "sid": self._sid()})

    def reset_chunks(self, rid: int) -> None:
        """A requeued request replays prefill: chunk numbering restarts."""
        self._chunks.pop(rid, None)

    # ------------------------------------------------------------------
    # export
    # ------------------------------------------------------------------

    def open_spans(self) -> dict[int, str]:
        return {rid: span["name"] for rid, span in self._open.items()}

    def chrome_payload(self) -> dict[str, Any]:
        """The Chrome trace-event JSON payload. Raises if any lifecycle
        span is still open — a drained engine must have closed them all."""
        if self._open:
            leaked = {rid: s["name"] for rid, s in sorted(self._open.items())}
            raise RuntimeError(f"open spans at export: {leaked}")
        meta: list[dict] = [
            {"name": "process_name", "ph": "M", "pid": ENGINE_PID, "tid": 0,
             "args": {"name": "engine"}},
            {"name": "thread_name", "ph": "M", "pid": ENGINE_PID, "tid": 0,
             "args": {"name": "step phases"}},
            {"name": "process_name", "ph": "M", "pid": REQUEST_PID, "tid": 0,
             "args": {"name": "requests"}},
        ]
        rids = sorted({e["tid"] for e in self._events
                       if e["pid"] == REQUEST_PID})
        for rid in rids:
            meta.append({"name": "thread_name", "ph": "M",
                         "pid": REQUEST_PID, "tid": rid,
                         "args": {"name": f"request {rid}"}})
        events = sorted(self._events, key=lambda e: (e["ts"], e["sid"]))
        # sid is tracer-internal (checkpoint continuity); strip from export
        body = [{k: v for k, v in e.items() if k != "sid"} for e in events]
        return {"traceEvents": meta + body,
                "displayTimeUnit": "ms",
                "metadata": {"clock": self.clock,
                             "ticks_per_step": TICKS_PER_STEP}}

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.chrome_payload(), f, indent=1, sort_keys=True)
            f.write("\n")

    # ------------------------------------------------------------------
    # checkpoint round-trip
    # ------------------------------------------------------------------

    def export_state(self) -> dict[str, Any]:
        return {
            "clock": self.clock,
            "next_sid": self._next_sid,
            "events": [dict(e) for e in self._events],
            "open": {str(rid): dict(s) for rid, s in self._open.items()},
            "chunks": {str(rid): n for rid, n in self._chunks.items()},
        }

    def restore_state(self, state: dict[str, Any]) -> None:
        self.clock = state["clock"]
        self._next_sid = int(state["next_sid"])
        self._events = [dict(e) for e in state["events"]]
        self._open = {int(rid): dict(s)
                      for rid, s in state["open"].items()}
        self._chunks = {int(rid): int(n)
                        for rid, n in state["chunks"].items()}
        self._step_chunk_cursor = (-1, 0)


# ---------------------------------------------------------------------------
# validation (CI smoke + trace_report)
# ---------------------------------------------------------------------------

_VALID_PH = {"X", "i", "C", "M"}
_TERMINAL = ("DONE", "FAILED", "REJECTED")


def validate_chrome_trace(payload: dict, *,
                          expect_requests: int | None = None) -> dict:
    """Structural validation of an exported trace. Raises ``ValueError``
    with every violation found; returns summary stats on success:
    ``{"events", "requests", "spans", "terminal"}``.

    Checks: Chrome-schema fields on every event, non-negative integer
    ts/dur on every ``X`` span (all spans closed — duration spans can only
    be emitted closed, so presence == closure), exactly one terminal
    instant (DONE/FAILED/REJECTED) per request track, and — when
    ``expect_requests`` is given — that the number of request tracks
    matches the submitted-request count with zero leaked (non-terminated)
    tracks."""
    problems: list[str] = []
    events = payload.get("traceEvents")
    if not isinstance(events, list) or not events:
        raise ValueError("trace: missing/empty traceEvents array")
    req_tracks: set[int] = set()
    terminal: dict[int, int] = {}
    spans = 0
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in _VALID_PH:
            problems.append(f"event {i}: bad ph {ph!r}")
            continue
        if not isinstance(e.get("name"), str):
            problems.append(f"event {i}: missing name")
        if ph == "M":
            continue
        ts = e.get("ts")
        if not isinstance(ts, int) or ts < 0:
            problems.append(f"event {i} ({e.get('name')}): bad ts {ts!r}")
        if not isinstance(e.get("pid"), int) \
                or not isinstance(e.get("tid"), int):
            problems.append(f"event {i} ({e.get('name')}): bad pid/tid")
        if ph == "X":
            spans += 1
            dur = e.get("dur")
            if not isinstance(dur, int) or dur < 0:
                problems.append(
                    f"event {i} ({e.get('name')}): bad dur {dur!r}")
        if e.get("pid") == REQUEST_PID:
            rid = e.get("tid")
            req_tracks.add(rid)
            if ph == "i" and any(e.get("name", "").startswith(t)
                                 for t in _TERMINAL):
                terminal[rid] = terminal.get(rid, 0) + 1
    for rid in sorted(req_tracks):
        n = terminal.get(rid, 0)
        if n != 1:
            problems.append(f"request {rid}: {n} terminal instants "
                            "(expected exactly 1 DONE/FAILED/REJECTED)")
    if expect_requests is not None and len(req_tracks) != expect_requests:
        problems.append(f"{len(req_tracks)} request tracks != "
                        f"{expect_requests} submitted requests")
    if problems:
        raise ValueError("invalid trace:\n  " + "\n  ".join(problems))
    return {"events": len(events), "requests": len(req_tracks),
            "spans": spans, "terminal": len(terminal)}


class span:
    """``with span(name) as sp:`` records the block as the host range
    ``name`` in ``torch.profiler``'s trace (none without a profiler) and keeps
    the block's ``time.perf_counter`` bounds as ``sp.t0`` / ``sp.t1`` (0.0
    until entered / left) and its seconds as ``sp.s``. One block at a time: a
    ``span`` may be entered again after it has been left."""

    __slots__ = ("name", "t0", "t1", "_range")

    def __init__(self, name: str):
        self.name = name
        self.t0 = self.t1 = 0.0
        self._range = None

    def __enter__(self) -> "span":
        self._range = _RecordFunctionFast(self.name)
        self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        self._range.__exit__(*exc)
        self._range = None

    @property
    def s(self) -> float:
        return self.t1 - self.t0
