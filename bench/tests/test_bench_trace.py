"""The device-trace reduction and the per-layer readers on a hand-made trace."""
from types import SimpleNamespace

import pytest

import bench_smoke_cases as S  # noqa: F401
import _counts
import _readers
from harness import trace

KERNELS = [("void snap::decode_kernel<0, 8, false>(...)", 10.0, 20.0),
           ("sm80_xmma_gemm_f32f32_tn", 15.0, 30.0),            # overlaps the first
           ("gemv2T_kernel_val", 40.0, 50.0),
           ("void at::native::elementwise_kernel", 95.0, 120.0)]  # runs past the window
RANGES = [("bench.window", 0.0, 100.0), ("bench.round", 5.0, 35.0), ("bench.round", 38.0, 60.0),
          ("aten::mm", 31.0, 39.0)]


def _trace():
    tr = trace.Trace(kernels=list(KERNELS), ranges=list(RANGES))
    tr.lo, tr.hi = 0.0, 100.0
    return tr


def test_busy_union_and_gaps():
    tr = _trace()
    assert tr.busy_intervals() == [[10.0, 30.0], [40.0, 50.0], [95.0, 100.0]]
    assert tr.busy_s == pytest.approx(35e-6)
    gaps = tr.idle_gaps()
    assert [g[1] for g in gaps] == pytest.approx([45e-6, 10e-6, 10e-6])
    assert [g[0] for g in gaps] == ["host outside any traced range",   # 50..95
                                    "bench.round",                       # 0..10
                                    "bench.round > aten::mm"]            # 30..40


def test_gemm_and_idle_readers():
    run = SimpleNamespace(trace=_trace(), steps=2)
    assert _readers.gemm_ms_per_step(run) == pytest.approx(1e3 * 25e-6 / 2)
    assert _readers.idle_share(run) == pytest.approx(65.0)
    assert _readers.gemm_ms_per_step(SimpleNamespace(trace=_trace(), steps=0)) is None


def test_mla_roofline_reads_the_frozen_bound():
    tr = _trace()
    d = dict(n_layers=1, n_heads=2, d_c=6, d_rope=2)
    run = SimpleNamespace(trace=tr, decode_calls=[[3, 5], [4, 6]], fmt="fp8_e4m3",
                          table_entries=4, dims=d)
    least = sum(_counts.decode_bound(l, "fp8_e4m3", 1, 4, 2, 6, 2)[0] for l in ([3, 5], [4, 6]))
    assert _readers.mla_roofline(run) == pytest.approx(100 * least / 1e3 / 10e-6)
