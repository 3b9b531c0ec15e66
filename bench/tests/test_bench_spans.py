"""The decode-loop readers (``bench/metrics/_spans.py``) on a hand-made trace
with the program's ``snapmla.round`` ranges, and on a profiled CPU run of the
program's fused decode loop."""
from types import SimpleNamespace

import pytest
import torch

import bench_smoke_cases as S  # noqa: F401
import _readers
import _spans
from harness import cell, trace

R = "snapmla.round"
# three rounds: one that started before the window, one inside it, one that
# runs past its end (its release lies wholly outside)
RANGES = [
    ("bench.window", 0.0, 1000.0),
    (R, -100.0, 5.0), (f"{R}.replays", -100.0, -10.0), (f"{R}.release", -10.0, 5.0),
    ("bench.round", 8.0, 402.0),
    (R, 10.0, 400.0),
    (f"{R}.buffers", 10.0, 30.0), (f"{R}.eager", 30.0, 100.0), (f"{R}.capture", 100.0, 150.0),
    (f"{R}.first_sync", 150.0, 200.0), (f"{R}.replays", 200.0, 380.0),
    (f"{R}.release", 380.0, 400.0),
    ("bench.round", 498.0, 1102.0),
    (R, 500.0, 1100.0),
    (f"{R}.buffers", 500.0, 520.0), (f"{R}.eager", 520.0, 600.0),
    (f"{R}.capture", 600.0, 650.0), (f"{R}.first_sync", 650.0, 700.0),
    (f"{R}.replays", 700.0, 1000.0), (f"{R}.release", 1050.0, 1100.0),
    # the runtime's calls: inside the rounds, between them, past the window
    ("cudaMalloc", 2.0, 3.0), ("cudaMalloc", 15.0, 16.0), ("cudaLaunchKernel", 20.0, 21.0),
    ("cudaFree", 390.0, 391.0), ("cudaMalloc", 450.0, 460.0), ("cudaMalloc", 510.0, 511.0),
    ("cudaFree", 1060.0, 1061.0),
]
KERNELS = [("k_eager", 40.0, 90.0), ("k_first", 160.0, 200.0), ("k_replay", 210.0, 370.0),
           ("k_eager", 530.0, 560.0), ("k_replay", 710.0, 990.0)]


def _run(ranges=RANGES, kernels=KERNELS):
    tr = trace.Trace(kernels=list(kernels), ranges=list(ranges))
    tr.lo, tr.hi = 0.0, 1000.0
    return SimpleNamespace(trace=tr)


def test_rounds_start_inside_the_window():
    assert _spans.rounds(_run().trace) == 2


def test_rebuild_ms_clips_every_phase_to_the_window():
    # 5 (the early round's release) + 20 + 70 + 50 + 20 + 20 + 80 + 50 us, two rounds
    assert _spans.rebuild_ms_per_round(_run()) == pytest.approx(315 / 1e3 / 2)


def test_rebuild_idle_share_counts_idle_inside_the_rebuild_phases_only():
    run = _run()
    # idle inside: 5; 20; 70 - 50; 50; 20; 20; 80 - 30; 50 us (first_sync and
    # replays are left out, idle or not)
    assert _spans.rebuild_idle_share(run) == pytest.approx(100 * 235 / 1000)
    assert _spans.rebuild_idle_share(run) <= _readers.idle_share(run) == pytest.approx(44.0)


def test_allocs_inside_rounds_per_round():
    # 2 (the early round's clipped part), 15, 390, 510; not 450 (between
    # rounds), 1060 (past the window) or the kernel launch
    assert _spans.allocs_per_round(_run()) == pytest.approx(4 / 2)


def test_no_round_reads_none():
    bare = [r for r in RANGES if not r[0].startswith("snapmla.")]
    late = [(n, a + 2000.0, b + 2000.0) if n.startswith("snapmla.") else (n, a, b)
            for n, a, b in RANGES]
    for ranges in (bare, late):
        run = _run(ranges)
        assert _spans.rebuild_ms_per_round(run) is None
        assert _spans.rebuild_idle_share(run) is None
        assert _spans.allocs_per_round(run) is None


def test_overlap_of_unions():
    assert _spans.overlap_us([[0, 10], [5, 20], [30, 40]], [[8, 32], [39, 50]]) == 12 + 2 + 1
    assert _spans.overlap_us([], [[0, 1]]) == 0.0


def test_readers_find_the_program_spans_in_a_profiled_cpu_run():
    """The three readers, loaded as the harness loads them, on the trace of two
    fused decode rounds of the program on the CPU (no device: no kernels and
    no runtime calls, so all of the rebuild phases read idle)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import steps as ST
    from repro_torch.models import transformer as T
    cfg = get_smoke_config("mla-7b")
    params = T.init_model(torch.Generator().manual_seed(0), cfg, device="cpu")
    state = T.init_decode_state(cfg, 2, 16, device="cpu")
    fused = ST.make_fused_decode(cfg, 3)
    tok, pos = torch.zeros(2, dtype=torch.int32), torch.zeros(2, dtype=torch.int32)
    readers = cell.readers(cell.load_benchmark(), "dsv3.decode_32k")
    with trace.profiled(True, torch.device("cpu")) as get_trace:
        with trace.mark("window"):
            for _ in range(2):
                with trace.mark("round"):
                    toks, state, _ = fused(params, tok, state, pos)
                tok, pos = toks[:, -1], pos + 3
    run = SimpleNamespace(trace=get_trace())
    assert _spans.rounds(run.trace) == 2
    got = {name: readers[name][1](run) for name in
           ("round_rebuild_ms.decode", "rebuild_idle_share.decode",
            "round_device_allocs.decode")}
    assert got["round_rebuild_ms.decode"] > 0
    assert 0 < got["rebuild_idle_share.decode"] < 100
    assert got["rebuild_idle_share.decode"] == pytest.approx(
        100 * got["round_rebuild_ms.decode"] * 2e-3 / run.trace.window_s)
    assert got["round_device_allocs.decode"] == 0
    assert readers["round_device_allocs.decode"][0] == "calls"
