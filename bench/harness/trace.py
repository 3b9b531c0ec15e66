"""The traced run's device trace: ``torch.profiler`` over the measured
window, reduced to the device's kernel intervals, the busy union, the idle
gaps and the harness's own host ranges (``record_function`` names that start
with ``bench.``), from which the per-layer metrics are read."""
from __future__ import annotations

import contextlib
import re
from dataclasses import dataclass, field

import torch

WINDOW = "bench.window"


@dataclass
class Trace:
    kernels: list = field(default_factory=list)     # (name, start_us, end_us), device
    ranges: list = field(default_factory=list)      # (name, start_us, end_us), host ops
    lo: float = 0.0                                  # the window, us
    hi: float = 0.0

    @property
    def window_s(self) -> float:
        return (self.hi - self.lo) / 1e6

    def clipped(self):
        for name, a, b in self.kernels:
            a, b = max(a, self.lo), min(b, self.hi)
            if b > a:
                yield name, a, b

    def busy_intervals(self) -> list:
        """The union of device-busy intervals inside the window."""
        out = []
        for _, a, b in sorted(self.clipped(), key=lambda k: k[1]):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_s(self, pattern: str) -> tuple[float, int]:
        """Seconds and launches of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        hits = [(a, b) for name, a, b in self.clipped() if rx.search(name)]
        return sum(b - a for a, b in hits) / 1e6, len(hits)

    def top_ops(self, n: int = 10) -> list:
        total: dict = {}
        for name, a, b in self.clipped():
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k[:160], v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """The longest idle gaps in the window, each named by the innermost
        harness range the host was in at the gap's middle."""
        busy = self.busy_intervals()
        edges = [self.lo] + [x for ab in busy for x in ab] + [self.hi]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        out = []
        for a, b in gaps[:n]:
            mid = (a + b) / 2
            inside = [(r_b - r_a, name) for name, r_a, r_b in self.ranges
                      if r_a <= mid <= r_b and name != WINDOW]
            ours = [x for x in inside if x[1].startswith("bench.")]
            label = " > ".join(min(g)[1] for g in (ours, [x for x in inside if x not in ours])
                               if g)
            out.append([label or "host outside any traced range", (b - a) / 1e6])
        return out


@contextlib.contextmanager
def profiled(enabled: bool, device):
    """Profile the block on the host and ``device`` when ``enabled``; yields a
    callable that returns the ``Trace`` once the block has ended."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    holder: dict = {}
    prof.start()
    try:
        yield lambda: holder["trace"]
    finally:
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        prof.stop()
        holder["trace"] = _reduce(prof)


def _reduce(prof) -> Trace:
    tr = Trace()
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns() / 1e3
        end = start + ev.duration_ns() / 1e3
        if ev.device_type() == torch.autograd.DeviceType.CUDA:
            if not ev.name().startswith("bench."):        # not the GPU side of a range
                tr.kernels.append((ev.name(), start, end))
        else:
            tr.ranges.append((ev.name(), start, end))
    windows = [(a, b) for name, a, b in tr.ranges if name == WINDOW]
    if windows:
        tr.lo, tr.hi = windows[0]
    return tr


def mark(name: str):
    """A harness host range, named ``bench.<name>``."""
    return torch.profiler.record_function(f"bench.{name}")
