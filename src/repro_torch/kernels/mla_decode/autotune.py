"""Profile-driven ``num_splits`` autotuner of the split-KV decode kernels
(port of ``repro/kernels/mla_decode/autotune.py``).

A measured-sweep cache keyed on ``(capacity, block_n, batch)``, persisted
as JSON, is the first source of split counts; ``ops.resolve_num_splits``
resolves, in order:

  1. an exact profile hit for (capacity, block_n, batch)  -> its measured best
  2. an entry of the same capacity, block_n, layout and rescale at another
     batch -> the best of the batch nearest in log-batch (ties to the
     smaller batch)
  3. no usable entry, or no profile file            -> ``default_num_splits``

The file format is the reference's version 2 (version 1 still loads): the
key grows "/paged" for sweeps of the paged kernels and "/amla" for sweeps
under the AMLA rescale; each entry holds ``best``, ``best_us`` (the time of
the best, which makes entries at different ``block_n`` comparable for the
joint ``(num_splits, block_n)`` plan) and ``measured_us``; "best" prefers
fewer splits within ``WIN_MARGIN``. The port's file also records the card it
was measured on (``device``: the name and power limit ``nvidia-smi`` gives);
the reference's loader ignores the field, and the port's loads the
reference's files.

The reference's default file, ``BENCH_splits_profile.json``, holds TPU times
and is never read here. The port's default is ``H100_splits_profile.json``
at the repo root, measured on the card by ``scripts/measure_split_profile.py``;
``SNAPMLA_TORCH_SPLIT_PROFILE`` overrides the path. The module-level
singleton loads it lazily once; ``reset()`` drops it or swaps one in.

On the card the sweep times the CUDA decode kernels (single pass at one
split, split-KV above; FMA or AMLA) as CUDA-graph replays between CUDA
events; on the CPU only a caller-supplied timer (``synthetic_timer``) can
drive it, and no kernel runs.
"""
from __future__ import annotations

import json
import os
import pathlib
import statistics
from typing import Callable, NamedTuple

import torch

PROFILE_ENV = "SNAPMLA_TORCH_SPLIT_PROFILE"
PROFILE_VERSION = 2
_LOADABLE_VERSIONS = (1, 2)    # v1 entries are a strict subset of v2's

# anchored at the repo root (this file is src/repro_torch/kernels/mla_decode/)
DEFAULT_PROFILE = (pathlib.Path(__file__).resolve().parents[4]
                   / "H100_splits_profile.json")

# A larger split count must beat every smaller one by this margin to be
# recorded as "best": jitter never moves a plan off the single pass.
WIN_MARGIN = 0.05


class SplitConfig(NamedTuple):
    """A joint split-KV plan: how many splits, at which KV block size."""

    num_splits: int
    block_n: int


def profile_path() -> pathlib.Path:
    override = os.environ.get(PROFILE_ENV)
    return pathlib.Path(override) if override else DEFAULT_PROFILE


def _key(capacity: int, block_n: int, batch: int, layout: str, rescale: str = "fma") -> str:
    base = f"{int(capacity)}/{int(block_n)}/{int(batch)}"
    if layout != "contiguous":
        base = f"{base}/{layout}"
    return base if rescale == "fma" else f"{base}/{rescale}"


def _parse_key(key: str) -> tuple[int, int, int, str, str] | None:
    """'<cap>/<bn>/<batch>[/<layout>][/amla]' -> (capacity, block_n, batch,
    layout, rescale); None for a malformed key."""
    parts = key.split("/")
    rescale = "fma"
    if parts and parts[-1] == "amla":
        rescale = parts.pop()
    if len(parts) == 3:
        parts = parts + ["contiguous"]
    if len(parts) != 4:
        return None
    try:
        return int(parts[0]), int(parts[1]), int(parts[2]), parts[3], rescale
    except ValueError:
        return None


def _pick_best(measured_us: dict[int, float]) -> int:
    best = None
    for s in sorted(measured_us):
        if best is None or measured_us[s] < measured_us[best] * (1 - WIN_MARGIN):
            best = s
    return best


def _entry_best(entry) -> int | None:
    try:
        return int(entry["best"])
    except (TypeError, KeyError, ValueError):
        return None


def _entry_best_us(entry) -> float | None:
    """The measured microseconds of an entry's best: ``best_us`` (v2), else
    the entry's own ``measured_us[best]`` (v1); None when malformed."""
    try:
        if "best_us" in entry:
            return float(entry["best_us"])
        return float(entry["measured_us"][str(int(entry["best"]))])
    except (TypeError, KeyError, ValueError):
        return None


def _log_dist(b: int, batch: int) -> tuple[float, int]:
    """Batch distance as a ratio (the exponent of the log distance), ties to
    the smaller batch."""
    hi, lo = max(b, batch, 1), max(min(b, batch), 1)
    return hi / lo, b


class SplitProfile:
    """Measured sweeps: (capacity, block_n, batch, layout, rescale) -> best
    split count, with the raw microseconds; ``device`` names the card."""

    def __init__(self, entries: dict | None = None, device: dict | None = None):
        self.entries: dict[str, dict] = dict(entries or {})
        self.device = device

    def lookup(self, capacity: int, block_n: int, batch: int | None,
               layout: str = "contiguous", rescale: str = "fma") -> int | None:
        """The exact entry's best, or None."""
        if batch is None:
            return None
        return _entry_best(self.entries.get(_key(capacity, block_n, batch, layout, rescale)))

    def lookup_nearest(self, capacity: int, block_n: int, batch: int | None,
                       layout: str = "contiguous", rescale: str = "fma") -> int | None:
        """Exact hit, else the best of the nearest batch (in log space) among
        entries of the same capacity, block_n, layout and rescale; None when
        there is none."""
        exact = self.lookup(capacity, block_n, batch, layout, rescale)
        if exact is not None or batch is None:
            return exact
        candidates = []
        for key, entry in self.entries.items():
            parsed = _parse_key(key)
            if parsed is None or parsed[:2] != (capacity, block_n) \
                    or parsed[3:] != (layout, rescale):
                continue
            best = _entry_best(entry)
            if best is not None:
                candidates.append((_log_dist(parsed[2], batch), best))
        return min(candidates)[1] if candidates else None

    def lookup_config(self, capacity: int, batch: int | None, layout: str = "contiguous",
                      rescale: str = "fma") -> SplitConfig | None:
        """Joint plan: among the entries of this capacity, layout and rescale
        (any block_n) at the exact batch, else at the nearest batch, the
        (best, block_n) whose best ran fastest; time ties go to the smaller
        block_n."""
        if batch is None:
            return None
        by_batch: dict[int, list[tuple[float, int, int]]] = {}
        for key, entry in self.entries.items():
            parsed = _parse_key(key)
            if parsed is None or parsed[0] != capacity or parsed[3:] != (layout, rescale):
                continue
            us, best = _entry_best_us(entry), _entry_best(entry)
            if us is None or best is None:
                continue
            by_batch.setdefault(parsed[2], []).append((us, parsed[1], best))
        if not by_batch:
            return None
        pool = by_batch.get(batch) or by_batch[min(by_batch, key=lambda b: _log_dist(b, batch))]
        _, bn, best = min(pool)
        return SplitConfig(num_splits=best, block_n=bn)

    def record(self, capacity: int, block_n: int, batch: int, measured_us: dict[int, float],
               layout: str = "contiguous", rescale: str = "fma") -> int:
        """Store one sweep; returns its best (``WIN_MARGIN`` ties to fewer
        splits)."""
        if not measured_us:
            raise ValueError("empty sweep")
        best = _pick_best(measured_us)
        self.entries[_key(capacity, block_n, batch, layout, rescale)] = {
            "best": int(best),
            "best_us": float(measured_us[best]),
            "measured_us": {str(k): float(v) for k, v in measured_us.items()},
        }
        return int(best)

    def save(self, path: str | os.PathLike | None = None) -> pathlib.Path:
        p = pathlib.Path(path) if path else profile_path()
        payload = {"version": PROFILE_VERSION, "entries": self.entries}
        if self.device is not None:
            payload["device"] = self.device
        p.write_text(json.dumps(payload, indent=2, sort_keys=True) + "\n")
        return p

    @classmethod
    def load(cls, path: str | os.PathLike | None = None) -> "SplitProfile":
        """The profile at ``path`` (default ``profile_path()``); an empty one
        when the file is missing, unreadable or of another version."""
        p = pathlib.Path(path) if path else profile_path()
        try:
            payload = json.loads(p.read_text())
        except (OSError, ValueError):
            return cls()
        if not isinstance(payload, dict) or payload.get("version") not in _LOADABLE_VERSIONS:
            return cls()
        entries = payload.get("entries", {})
        device = payload.get("device")
        return cls(entries if isinstance(entries, dict) else {},
                   device if isinstance(device, dict) else None)


_PROFILE: SplitProfile | None = None


def get_profile() -> SplitProfile:
    """The lazily loaded singleton ``ops.resolve_num_splits`` reads."""
    global _PROFILE
    if _PROFILE is None:
        _PROFILE = SplitProfile.load()
    return _PROFILE


def reset(profile: SplitProfile | None = None) -> None:
    """Drop the singleton (the next lookup reloads the file) or swap one in."""
    global _PROFILE
    _PROFILE = profile


def tuned_num_splits(capacity: int, block_n: int, batch: int | None,
                     layout: str = "contiguous", rescale: str = "fma") -> int | None:
    """The profile's split count for the shape (exact hit, else nearest
    batch); None -> the heuristic. AMLA plans come only from AMLA sweeps."""
    return get_profile().lookup_nearest(capacity, block_n, batch, layout, rescale)


def tuned_split_config(capacity: int, batch: int | None, layout: str = "contiguous",
                       rescale: str = "fma") -> SplitConfig | None:
    """The profile's joint (num_splits, block_n) plan; None -> the heuristic."""
    return get_profile().lookup_config(capacity, batch, layout, rescale)


# ---------------------------------------------------------------------------
# measured sweeps
# ---------------------------------------------------------------------------

def candidate_splits(capacity: int, block_n: int, max_splits: int = 8) -> list[int]:
    """Powers of two up to min(max_splits, block count)."""
    nblocks = max(1, capacity // block_n)
    out, s = [], 1
    while s <= min(max_splits, nblocks):
        out.append(s)
        s *= 2
    return out


def candidate_block_ns(capacity: int, block_ns: tuple[int, ...] = (32, 64, 128, 256)
                       ) -> list[int]:
    """Contiguous block sizes that divide the capacity (else the capacity)."""
    out = [bn for bn in block_ns if bn <= capacity and capacity % bn == 0]
    return out or [capacity]


def block_ns_for_paged(capacity: int, page_size: int = 128) -> int:
    """A paged pool's block is its page."""
    return min(page_size, capacity)


def graph_timer(iters: int = 20, reps: int = 5):
    """The card's ``timer(num_splits, run) -> us``: one eager call (it grows
    the kernels' scratch), ``iters`` calls captured as a CUDA graph, the
    median over ``reps`` replays between CUDA events, per call. Device time:
    the Python wrappers' own cost is not counted, as in the captured decode
    loop."""
    def timer(_s, run):
        if not torch.cuda.is_available():
            raise RuntimeError("graph_timer measures on the card; on the CPU pass a "
                               "synthetic timer")
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            run()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(iters):
                run()
        graph.replay()
        torch.cuda.synchronize()
        out = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            torch.cuda.synchronize()
            out.append(start.elapsed_time(end) * 1e3 / iters)
        return statistics.median(out)
    return timer


def synthetic_timer(timings_us: dict[int, float]):
    """Fixed microseconds per split count; runs nothing (tests)."""
    def timer(s, _run):
        return timings_us[s]
    return timer


def synthetic_timer_2d(timings_us: dict[tuple[int, int], float]):
    """Fixed microseconds per (block_n, num_splits); runs nothing (tests)."""
    def timer(bn, s, _run):
        return timings_us[(bn, s)]
    return timer


def _sweep_case(capacity: int, block_n: int, batch: int, *, d_c: int, d_r: int, heads: int,
                fmt: str, fill: float, layout: str, device):
    """The cache and decode query one sweep times: random latents prefilled
    through the port's cache writes, every row at ``fill * capacity``
    tokens, a raw query (prepared for ``none``)."""
    from repro_torch import resolve_device
    from repro_torch.core.kvcache import (CacheConfig, init_mla_cache, init_paged_mla_cache,
                                          mla_prefill, paged_mla_prefill)
    from repro_torch.kernels.mla_decode import ref as kref
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    cfg = CacheConfig(fmt=fmt, page_size=block_n)
    ckv = torch.randn(batch, capacity, d_c, generator=gen, device=dev)
    kr = torch.randn(batch, capacity, d_r, generator=gen, device=dev)
    if layout == "paged":
        cache = paged_mla_prefill(init_paged_mla_cache(cfg, batch, capacity, d_c, d_r,
                                                       device=dev), cfg, ckv, kr)
    else:
        cache = mla_prefill(init_mla_cache(cfg, batch, capacity, d_c, d_r, device=dev),
                            cfg, ckv, kr)
    lens = torch.full((batch,), max(1, int(capacity * fill)), dtype=torch.int32, device=dev)
    cache = cache._replace(seq_lens=lens)
    q_lat = torch.randn(batch, heads, d_c, generator=gen, device=dev)
    q_rope = torch.randn(batch, heads, d_r, generator=gen, device=dev)
    query = kref.prepare_q(q_lat, q_rope, fmt) if fmt == "none" else (q_lat, q_rope, None)
    return cache, query


def measure_split_sweep(capacity: int, block_n: int, batch: int, *, d_c: int = 64,
                        d_r: int = 16, heads: int = 8, fmt: str = "fp8_e4m3",
                        fill: float = 0.75, iters: int = 20,
                        profile: SplitProfile | None = None, layout: str = "contiguous",
                        rescale: str = "fma", timer: Callable | None = None,
                        device=None) -> dict[int, float]:
    """Time the decode kernels at every candidate split count and record the
    best into ``profile`` (default: the singleton) under ``layout`` and
    ``rescale``. Returns {num_splits: us}.

    ``timer(num_splits, run) -> us`` is the measurement seam; ``run()``
    decodes once at that split count through ``ops.snapmla_decode`` (or
    ``snapmla_decode_paged``) with the kernels, building the case on its
    first call, on ``device`` (default the card). The default timer is
    ``graph_timer(iters)``, on the card only; a synthetic timer runs
    nothing."""
    from repro_torch.kernels.mla_decode import ops
    if timer is None:
        timer = graph_timer(iters)
    case: list = []

    def run(s):
        if not case:
            case.extend(_sweep_case(capacity, block_n, batch, d_c=d_c, d_r=d_r, heads=heads,
                                    fmt=fmt, fill=fill, layout=layout, device=device))
        cache, (q_c, q_r, sq) = case
        scale = 1.0 / float((d_c + d_r) ** 0.5)
        if layout == "paged":
            return ops.snapmla_decode_paged(q_c, q_r, sq, cache, softmax_scale=scale, fmt=fmt,
                                            num_splits=s, rescale=rescale)
        return ops.snapmla_decode(q_c, q_r, sq, cache, softmax_scale=scale, block_n=block_n,
                                  fmt=fmt, num_splits=s, rescale=rescale)

    measured = {s: float(timer(s, lambda s=s: run(s)))
                for s in candidate_splits(capacity, block_n)}
    (profile if profile is not None else get_profile()).record(
        capacity, block_n, batch, measured, layout=layout, rescale=rescale)
    return measured


def measure_config_sweep(capacity: int, batch: int, *, block_ns: list[int] | None = None,
                         d_c: int = 64, d_r: int = 16, heads: int = 8,
                         fmt: str = "fp8_e4m3", fill: float = 0.75, iters: int = 20,
                         profile: SplitProfile | None = None, layout: str = "contiguous",
                         rescale: str = "fma", timer: Callable | None = None,
                         device=None) -> dict[tuple[int, int], float]:
    """``measure_split_sweep`` at every candidate block_n (a paged pool's
    only: its page), one profile entry each, so ``lookup_config`` picks the
    joint plan. ``timer(block_n, num_splits, run)``. Returns
    {(block_n, num_splits): us}."""
    if block_ns is None:
        block_ns = (candidate_block_ns(capacity) if layout == "contiguous"
                    else [block_ns_for_paged(capacity)])
    measured: dict[tuple[int, int], float] = {}
    for bn in block_ns:
        bn_timer = None if timer is None else (lambda s, run, _bn=bn: timer(_bn, s, run))
        sweep = measure_split_sweep(capacity, bn, batch, d_c=d_c, d_r=d_r, heads=heads,
                                    fmt=fmt, fill=fill, iters=iters, profile=profile,
                                    layout=layout, rescale=rescale, timer=bn_timer,
                                    device=device)
        measured.update({(bn, s): us for s, us in sweep.items()})
    return measured
