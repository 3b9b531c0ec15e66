"""mla_kernel_roofline.decode: the MLA decode kernels' share of their
roofline over an offline decode window (device trace, by kernel name; the
least time from the frozen ``decode_bound``)."""
import _readers


def read(run):
    return _readers.mla_roofline(run)
