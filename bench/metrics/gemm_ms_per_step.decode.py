"""gemm_ms_per_step.decode: device ms per decode step of the library's
matrix products (the projections, the experts, the logits), from the device
trace by kernel name."""
import _readers


def read(run):
    return _readers.gemm_ms_per_step(run)
