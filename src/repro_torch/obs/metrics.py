"""Typed metrics registry — the deterministic-first telemetry core.

A copy of ``repro/obs/metrics.py`` (the port imports nothing of the JAX package).

One :class:`MetricsRegistry` holds every counter the serving stack exposes,
under the naming convention ``snapmla_<area>_<name>`` (enforced at
registration). The design splits metrics into two strictly separated
families:

  * **work metrics** (the default) — deterministic work units: tokens,
    pages, blocks, requests, fault counts. Same seed + workload ⇒ same
    values on any machine, so ``scripts/bench_gate.py`` can pin them as
    regression floors.
  * **wall metrics** (``wall=True``) — wall-clock seconds / throughput.
    They live in a separate namespace in every exported view and are NEVER
    eligible for gating (bench_gate asserts no gated path touches them).

Three metric types, Prometheus-shaped but in-process:

  * :class:`Counter` — monotonic ``inc(n)``; negative increments raise.
  * :class:`Gauge` — ``set``/``inc``/``dec``; also used to mirror counters
    owned by subsystems whose values can legally move down (e.g. the
    allocator's un-evict fast path decrements ``host_offloads``).
  * :class:`Histogram` — ``observe(v)`` into fixed buckets plus sum/count.

Labels are supported (``labels("kind")`` then ``metric.labels(kind=...)``);
label sets materialize children on first use and snapshots sort them, so
the exported view is byte-stable for a deterministic run.

``snapshot()`` returns a nested plain dict (JSON-safe, sorted keys);
``export_state``/``restore_state`` round-trip the registry through the
engine checkpoint manifest so a restored run resumes its series exactly.

Subsystems that keep counters as internal state (allocator free lists,
tier slots) are absorbed via **collectors**: ``register_collector(fn)``
callbacks run at snapshot time and push the current values into registry
gauges — one registry view over every module without rewriting
invariant-carrying internals.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Iterable

_NAME_RE = re.compile(r"^snapmla_[a-z0-9]+(_[a-z0-9]+)+$")

# default histogram buckets: powers of two — token widths, page counts and
# scale magnitudes all live naturally on this grid
DEFAULT_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def _check_name(name: str) -> str:
    if not _NAME_RE.match(name):
        raise ValueError(
            f"metric name {name!r} violates the snapmla_<area>_<name> "
            "convention (lowercase, underscore-separated, >= 3 segments)")
    return name


class _Metric:
    """Shared base: identity, wall/work family, label plumbing."""

    kind = "metric"

    def __init__(self, name: str, help: str, labels: Iterable[str] = (),
                 *, wall: bool = False):
        self.name = _check_name(name)
        self.help = help
        self.label_names = tuple(labels)
        self.wall = bool(wall)
        # label-values tuple -> child payload (created on first use)
        self._children: dict[tuple[str, ...], Any] = {}

    # -- labels --------------------------------------------------------
    def _key(self, kv: dict[str, str]) -> tuple[str, ...]:
        if set(kv) != set(self.label_names):
            raise ValueError(
                f"{self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.label_names)}")
        return tuple(str(kv[k]) for k in self.label_names)

    def labels(self, **kv: str):
        """Child accessor for a labeled metric (unlabeled metrics ARE their
        own child)."""
        if not self.label_names:
            raise ValueError(f"{self.name} declares no labels")
        key = self._key(kv)
        child = self._children.get(key)
        if child is None:
            child = self._make_child()
            self._children[key] = child
        return child

    def _make_child(self):
        raise NotImplementedError

    def _self_child(self):
        """The implicit child of an unlabeled metric."""
        if self.label_names:
            raise ValueError(f"{self.name} is labeled; use .labels(...)")
        child = self._children.get(())
        if child is None:
            child = self._make_child()
            self._children[()] = child
        return child

    # -- snapshot / state ---------------------------------------------
    def _child_value(self, child) -> Any:
        raise NotImplementedError

    def _child_restore(self, child, value) -> None:
        raise NotImplementedError

    def value_dict(self) -> dict[str, Any]:
        """{label-values-joined-by-comma: value}; '' for unlabeled."""
        return {",".join(k): self._child_value(c)
                for k, c in sorted(self._children.items())}

    def restore_values(self, values: dict[str, Any]) -> None:
        self._children.clear()
        for joined, value in values.items():
            key = tuple(joined.split(",")) if joined else ()
            if len(key) != len(self.label_names):
                raise ValueError(
                    f"{self.name}: restored label arity {key} != declared "
                    f"{self.label_names}")
            child = self._make_child()
            self._child_restore(child, value)
            self._children[key] = child


class _CounterChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Counter(_Metric):
    """Monotonic counter (work units by default; seconds when wall=True)."""

    kind = "counter"

    def _make_child(self):
        return _CounterChild()

    def _child_value(self, child):
        return child.value

    def _child_restore(self, child, value):
        child.value = value

    def inc(self, n: int | float = 1) -> None:
        self._self_child().inc(n)

    @property
    def value(self):
        return self._self_child().value


class _GaugeChild:
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def dec(self, n=1) -> None:
        self.value -= n


class Gauge(_Metric):
    """Point-in-time value (can move both ways)."""

    kind = "gauge"

    def _make_child(self):
        return _GaugeChild()

    def _child_value(self, child):
        return child.value

    def _child_restore(self, child, value):
        child.value = value

    def set(self, v) -> None:
        self._self_child().set(v)

    def inc(self, n=1) -> None:
        self._self_child().inc(n)

    def dec(self, n=1) -> None:
        self._self_child().dec(n)

    @property
    def value(self):
        return self._self_child().value


class _HistogramChild:
    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets: tuple[float, ...]):
        self.buckets = buckets
        self.counts = [0] * (len(buckets) + 1)   # +inf overflow bucket
        self.sum = 0
        self.count = 0

    def observe(self, v) -> None:
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                return
        self.counts[-1] += 1


class Histogram(_Metric):
    """Fixed-bucket histogram (cumulative-free: per-bucket counts)."""

    kind = "histogram"

    def __init__(self, name, help, labels=(), *, wall=False,
                 buckets: Iterable[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels, wall=wall)
        self.buckets = tuple(buckets)
        if list(self.buckets) != sorted(self.buckets):
            raise ValueError(f"{name}: histogram buckets must be sorted")

    def _make_child(self):
        return _HistogramChild(self.buckets)

    def _child_value(self, child):
        return {"count": child.count, "sum": child.sum,
                "buckets": {str(le): n for le, n
                            in zip(child.buckets, child.counts)},
                "overflow": child.counts[-1]}

    def _child_restore(self, child, value):
        child.count = value["count"]
        child.sum = value["sum"]
        child.counts = [value["buckets"].get(str(le), 0)
                        for le in child.buckets] + [value.get("overflow", 0)]

    def observe(self, v) -> None:
        self._self_child().observe(v)

    @property
    def count(self):
        return self._self_child().count

    @property
    def sum(self):
        return self._self_child().sum


class MetricsRegistry:
    """The one place every telemetry scalar registers.

    Registration is idempotent for an identical spec (same type / labels /
    wall family) and raises on a conflicting re-registration, so modules can
    declare their metrics independently against a shared registry.
    """

    def __init__(self):
        self._metrics: dict[str, _Metric] = {}
        self._collectors: list[Callable[[], None]] = []

    # -- registration --------------------------------------------------
    def _register(self, cls, name, help, labels, wall, **kw) -> Any:
        existing = self._metrics.get(name)
        if existing is not None:
            if (type(existing) is not cls
                    or existing.label_names != tuple(labels)
                    or existing.wall != bool(wall)):
                raise ValueError(
                    f"metric {name!r} re-registered with a different spec")
            return existing
        metric = cls(name, help, labels, wall=wall, **kw)
        self._metrics[name] = metric
        return metric

    def counter(self, name: str, help: str = "", labels: Iterable[str] = (),
                *, wall: bool = False) -> Counter:
        return self._register(Counter, name, help, labels, wall)

    def gauge(self, name: str, help: str = "", labels: Iterable[str] = (),
              *, wall: bool = False) -> Gauge:
        return self._register(Gauge, name, help, labels, wall)

    def histogram(self, name: str, help: str = "", labels: Iterable[str] = (),
                  *, wall: bool = False,
                  buckets: Iterable[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._register(Histogram, name, help, labels, wall,
                              buckets=buckets)

    def get(self, name: str) -> _Metric:
        return self._metrics[name]

    def __contains__(self, name: str) -> bool:
        return name in self._metrics

    def names(self) -> list[str]:
        return sorted(self._metrics)

    # -- collectors ----------------------------------------------------
    def register_collector(self, fn: Callable[[], None]) -> None:
        """``fn`` runs before every snapshot/export and pushes subsystem
        state (allocator stats, tier slots, tree size) into gauges."""
        self._collectors.append(fn)

    def collect(self) -> None:
        for fn in self._collectors:
            fn()

    # -- views ---------------------------------------------------------
    def snapshot(self, *, include_wall: bool = False) -> dict[str, Any]:
        """Deterministic nested view: ``{"work": {...}, "wall": {...}}``.

        ``work`` is always byte-stable for a seeded run; ``wall`` is only
        present when requested (it never is for gating/baseline paths)."""
        self.collect()
        work: dict[str, Any] = {}
        wall: dict[str, Any] = {}
        for name in sorted(self._metrics):
            m = self._metrics[name]
            (wall if m.wall else work)[name] = {
                "type": m.kind, "values": m.value_dict()}
        out: dict[str, Any] = {"work": work}
        if include_wall:
            out["wall"] = wall
        return out

    # -- checkpoint round-trip ----------------------------------------
    def export_state(self) -> dict[str, Any]:
        """JSON-safe values-only state (specs live in code, like
        bench_gate's METRICS table)."""
        self.collect()
        return {name: m.value_dict()
                for name, m in sorted(self._metrics.items())}

    def restore_state(self, state: dict[str, Any]) -> None:
        """Restore values into already-registered metrics. Unknown names in
        ``state`` are ignored (forward compat); registered metrics missing
        from ``state`` keep their zeros."""
        for name, values in state.items():
            m = self._metrics.get(name)
            if m is not None:
                m.restore_values(values)
