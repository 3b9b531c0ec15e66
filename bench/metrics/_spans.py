"""What the decode-loop metrics share: the program's own host ranges around
the phases of a fused decode round (``snapmla.round`` and its children,
recorded by ``repro_torch.launch.steps.make_fused_decode``), each clipped to
the traced window. A trace without them (a program that records none) gives
no rounds, and every reader then returns None."""
from __future__ import annotations

ROUND = "snapmla.round"
# the phases a round spends rebuilding what the previous round had: its
# buffers, the eager first step, the graph capture and the graph's release
# (not ``first_sync``, during which the device runs the eager step)
REBUILD = tuple(f"{ROUND}.{phase}" for phase in ("buffers", "eager", "capture", "release"))
# the CUDA runtime's device allocate and free calls, as the trace names them
ALLOCS = frozenset({"cudaMalloc", "cudaFree"})


def clipped(tr, names) -> list:
    """The window's parts of the host ranges named in ``names``, [start, end] in us."""
    out = []
    for name, a, b in tr.ranges:
        if name in names:
            a, b = max(a, tr.lo), min(b, tr.hi)
            if b > a:
                out.append([a, b])
    return out


def union(intervals) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def overlap_us(xs, ys) -> float:
    """The length both unions of intervals cover."""
    xs, ys = union(xs), union(ys)
    total, j = 0.0, 0
    for a, b in xs:
        while j < len(ys) and ys[j][1] <= a:
            j += 1
        k = j
        while k < len(ys) and ys[k][0] < b:
            total += min(b, ys[k][1]) - max(a, ys[k][0])
            k += 1
    return total


def rounds(tr) -> int:
    """The rounds that start inside the window."""
    return sum(1 for name, a, _ in tr.ranges if name == ROUND and tr.lo <= a < tr.hi)


def rebuild_ms_per_round(run):
    n = rounds(run.trace)
    if not n:
        return None
    return sum(b - a for a, b in clipped(run.trace, REBUILD)) / 1e3 / n


def rebuild_idle_share(run):
    """The device's idle time inside the rebuild phases over the window's
    wall, in %."""
    tr = run.trace
    if not rounds(tr) or tr.hi <= tr.lo:
        return None
    spans = union(clipped(tr, REBUILD))
    idle = sum(b - a for a, b in spans) - overlap_us(spans, tr.busy_intervals())
    return 100.0 * idle / (tr.hi - tr.lo)


def allocs_per_round(run):
    """The runtime's device allocate / free calls that start inside a round,
    per round."""
    tr = run.trace
    n = rounds(tr)
    if not n:
        return None
    inside = union(clipped(tr, {ROUND}))
    calls = sum(1 for name, a, _ in tr.ranges
                if name in ALLOCS and any(lo <= a < hi for lo, hi in inside))
    return calls / n
