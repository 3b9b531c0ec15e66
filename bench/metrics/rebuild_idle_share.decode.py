"""rebuild_idle_share.decode: the device's idle time that falls inside a
round's rebuild phases (``snapmla.round.buffers``, ``.eager``, ``.capture``,
``.release``) over the traced window's wall, in %: the part of
``device_idle_share.decode`` that the per-round rebuild causes."""
import _spans


def read(run):
    return _spans.rebuild_idle_share(run)
