"""What the per-layer metric files share: the kernel-name patterns of a layer
and the sums over a traced window. Each metric's own file says which of these
it reads and for which traffic."""
from __future__ import annotations

import _counts

# the MLA decode launches (kernels A / B with D and C folded in, or the
# standalone D / C / #4 where a path launches them)
MLA_DECODE = (r"(?<![A-Za-z0-9_])decode_kernel<|lse_combine_kernel|amla_combine"
              r"|fused_q_quant_kernel")
# the library's matrix products (cuBLAS / cuBLASLt / CUTLASS kernels)
GEMM = r"gemm|gemv|Gemm|Gemv|cutlass|xmma|splitKreduce|dot_kernel"


def mla_roofline(run):
    """Σ least time of the window's MLA decode calls over Σ their device
    time, in %; None where the trace holds no such launch."""
    secs, n = run.trace.device_s(MLA_DECODE)
    if not n or not run.decode_calls:
        return None
    d = run.dims
    least_ms = sum(_counts.decode_bound(lens, run.fmt, 1, run.table_entries, d["n_heads"],
                                        d["d_c"], d["d_rope"])[0]
                   for lens in run.decode_calls) * d["n_layers"]
    return 100.0 * least_ms / 1e3 / secs


def gemm_ms_per_step(run):
    secs, n = run.trace.device_s(GEMM)
    if not n or not run.steps:
        return None
    return 1e3 * secs / run.steps


def step_mfu(run):
    """Σ least time of the window's steps over the window's wall, in %."""
    if not run.decode_calls or run.trace.window_s <= 0:
        return None
    least = 0.0
    for lens in run.decode_calls:
        least += _counts.least_seconds(
            *_counts.step_work(run.dims, run.fmt, lens, run.experts_read, run.pairs_kept),
            run.fmt)
    return 100.0 * least / run.trace.window_s


def idle_share(run):
    if run.trace.window_s <= 0 or run.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
