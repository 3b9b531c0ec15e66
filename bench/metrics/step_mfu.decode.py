"""step_mfu.decode: the whole decode step's share of the card's peak: the
least time of the window's steps (frozen counts: float32 FLOPs at 67 TFLOP/s
plus attention at the FP8 rate, or the bytes at 3.35 TB/s, whichever is
larger) over the traced window's wall."""
import _readers


def read(run):
    return _readers.step_mfu(run)
