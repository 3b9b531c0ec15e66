"""device_idle_share.decode: 1 - the union of device-busy intervals over the
traced window's wall, in %."""
import _readers


def read(run):
    return _readers.idle_share(run)
